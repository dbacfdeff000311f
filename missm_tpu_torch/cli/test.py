"""Evaluation entry point, after missm_tpu/cli/test.py — mirrors
`test.py`: loads the final model and runs the missing-type x missing-ratio
sweep on `--device` (the card by default), writing reference-format txt
reports to ./new_txt_experiment/. With `--distributed` (and the layout
flags of cli.train) every data rank sweeps its shard of the rows at
`--batch_size` / n_data a batch (the global batch rounded up as
round_eval_batch says) and the results are gathered; rank 0 writes the
reports.

python -m missm_tpu_torch.cli.test --datasetName mvsa --fusion_type sum \
    --test_types sum --modality_types language image \
    --test_missing_type language image mixed --csv_path .../label.csv
"""
from __future__ import annotations

import os

from ..compat.args import test_args
from ..data.loaders import testing_loader
from ..eval.sweep import run_missing_sweep
from ..train.checkpoint import restore_checkpoint
from ..train.step import make_eval_step
from ..core.mesh import data_coordinate
from .common import (build_model_config, init_params, make_loader_fns,
                     make_tokenizer, round_eval_batch, setup_layout,
                     setup_mesh, to_device)


def main(argv=None):
    args = test_args(argv)
    result_dir = "./new_txt_experiment"
    os.makedirs(result_dir, exist_ok=True)

    mesh = setup_mesh(args)
    rank_args = args
    if mesh is not None:
        import copy
        rank_args = copy.copy(args)
        rank_args.batch_size = round_eval_batch(args, mesh)
    shard, n_shards = data_coordinate(mesh)

    tokenizer = make_tokenizer(args)
    media_loaders = make_loader_fns(args)
    train_loader, test_loaders, num_classes = testing_loader(
        rank_args, args.csv_path, tokenizer, media_loaders,
        missing_path=args.missing_index_path, num_shards=n_shards,
        shard_index=shard)

    cfg = build_model_config(args, num_classes, mesh=mesh)

    ckpt = os.path.join(args.model_ckpt_dir,
                        f"{args.datasetName}_{args.fusion_type}")
    if os.path.isdir(ckpt):
        tree, _ = restore_checkpoint(ckpt)
        params = to_device(tree["params"], args.device)
    elif args.init == "random":
        params = init_params(args, cfg, args.seed)
    else:
        raise FileNotFoundError(f"final model checkpoint not found: {ckpt}")
    cfg, params = setup_layout(args, cfg, params, mesh)
    eval_step = make_eval_step(cfg, device=args.device)

    all_results = {}
    for test_type in args.test_types:
        all_results[test_type] = run_missing_sweep(
            params, cfg, eval_step, test_loaders, result_dir,
            args.datasetName, test_type, train_loader=train_loader,
            device=args.device)
    print("Test completed!")
    return all_results


if __name__ == "__main__":
    main()
