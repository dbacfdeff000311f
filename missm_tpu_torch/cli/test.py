"""Evaluation entry point, after missm_tpu/cli/test.py — mirrors
`test.py`: loads the final model and runs the missing-type x missing-ratio
sweep on `--device` (the card by default), writing reference-format txt
reports to ./new_txt_experiment/.

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
from .common import (build_model_config, init_params, make_loader_fns,
                     make_tokenizer, to_device)


def main(argv=None):
    args = test_args(argv)
    result_dir = "./new_txt_experiment"
    os.makedirs(result_dir, exist_ok=True)

    tokenizer = make_tokenizer(args)
    media_loaders = make_loader_fns(args)
    train_loader, test_loaders, num_classes = testing_loader(
        args, args.csv_path, tokenizer, media_loaders,
        missing_path=args.missing_index_path)

    cfg = build_model_config(args, num_classes)

    ckpt = os.path.join(args.model_ckpt_dir,
                        f"{args.datasetName}_{args.fusion_type}")
    if os.path.isdir(ckpt):
        tree, _ = restore_checkpoint(ckpt)
        params = to_device(tree["params"], args.device)
    elif args.init == "random":
        params = init_params(args, cfg, args.seed)
    else:
        raise FileNotFoundError(f"final model checkpoint not found: {ckpt}")
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
