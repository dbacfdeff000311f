"""Export a trained checkpoint as a serving artifact (torch.export, see
eval/artifact.py), after missm_tpu/cli/export.py. The artifact holds the
params and runs with torch and the port's op registrations, without model
code or configs:

python -m missm_tpu_torch.cli.export --datasetName mvsa \
    --csv_path .../label.csv --fusion_type sum --output artifact_dir

The input shapes and types are fixed from one real batch of the dataset's
given split (default: test), so the artifact serves what the eval pipeline
produces; batch size = --batch_size. It is exported on --device (the card
by default) and serves there.
"""
from __future__ import annotations

import os

from ..compat.args import test_args
from ..core.device import resolve_device
from ..data.datasets import DATASET_SPECS, MMDataset, encode_labels
from ..eval.artifact import ARTIFACT_FILE, export_artifact
from ..eval.predictor import Predictor
from ..eval.sweep import _pad_batch
from ..train.checkpoint import restore_checkpoint
from .common import (build_model_config, make_loader_fns, make_tokenizer,
                     round_eval_batch, setup_mesh)


def main(argv=None):
    import sys
    raw = list(argv if argv is not None else sys.argv[1:])
    split, output = "test", "serving_artifact"
    for flag in ("--split", "--output"):
        if flag in raw:
            i = raw.index(flag)
            val = raw[i + 1]
            del raw[i:i + 2]
            if flag == "--split":
                split = val
            else:
                output = val
    args = test_args(raw)
    resolve_device(args.device)  # the card unless asked, before any work
    # --distributed: a multi-device artifact over the mesh's data axis
    mesh = setup_mesh(args)
    if mesh is not None:
        round_eval_batch(args, mesh)

    spec = DATASET_SPECS[args.datasetName]
    import pandas as pd
    df = pd.read_csv(args.csv_path, converters={"clip_id": str})
    labels, num_classes = encode_labels(list(df["annotation"]))
    sub = df[df["mode"] == split]
    ds = MMDataset(spec, sub, "/".join(args.csv_path.split("/")[:-1]),
                   labels[df["mode"] == split], split, False)

    cfg = build_model_config(args, num_classes)
    ckpt = os.path.join(args.model_ckpt_dir,
                        f"{args.datasetName}_{args.fusion_type}")
    tree, _ = restore_checkpoint(ckpt)
    pred = Predictor(tree["params"], cfg, batch_size=args.batch_size,
                     tokenizer=make_tokenizer(args),
                     media_loaders=make_loader_fns(args), device=args.device)
    n = min(len(ds), args.batch_size)
    example = _pad_batch(pred._collate_raw([ds[i][0] for i in range(n)]),
                         args.batch_size)
    export_artifact(pred.params, cfg, example, output, device=args.device,
                    mesh=mesh,
                    extra_manifest={"datasetName": args.datasetName,
                                    "fusion_type": args.fusion_type,
                                    "checkpoint": ckpt})
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        size = os.path.getsize(os.path.join(output, ARTIFACT_FILE))
        print(f"wrote {output} ({size / 1e6:.1f} MB, batch "
              f"{args.batch_size})")
    return output


if __name__ == "__main__":
    main()
