"""Batch inference entry point, after missm_tpu/cli/predict.py: load a
final checkpoint and write predictions for a label.csv-style dataset split
on `--device` (the card by default).

python -m missm_tpu_torch.cli.predict --datasetName mvsa \
    --csv_path .../label.csv --fusion_type sum --split test \
    --output predictions.csv

`--artifact` (the JAX package's exported StableHLO model) is not ported:
export is ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import os

import numpy as np

from ..compat.args import test_args
from ..data.datasets import DATASET_SPECS, MMDataset, encode_labels
from ..eval.predictor import Predictor
from .common import build_model_config, make_loader_fns, make_tokenizer


def main(argv=None):
    import sys
    raw = list(argv if argv is not None else sys.argv[1:])
    split = "test"
    output = "predictions.csv"
    for flag in ("--split", "--output", "--artifact"):
        if flag in raw:
            i = raw.index(flag)
            val = raw[i + 1]
            del raw[i:i + 2]
            if flag == "--split":
                split = val
            elif flag == "--output":
                output = val
            else:
                raise NotImplementedError(
                    f"--artifact {val}: serving artifacts (export) are not "
                    "ported yet, ROADMAP queue 1 item 6; predict from the "
                    "final checkpoint instead")
    args = test_args(raw)

    spec = DATASET_SPECS[args.datasetName]
    import pandas as pd
    df = pd.read_csv(args.csv_path, converters={"clip_id": str})
    labels, num_classes = encode_labels(list(df["annotation"]))
    sub = df[df["mode"] == split]
    ds = MMDataset(spec, sub, "/".join(args.csv_path.split("/")[:-1]),
                   labels[df["mode"] == split], split, False)
    samples = [ds[i][0] for i in range(len(ds))]

    cfg = build_model_config(args, num_classes)
    ckpt = os.path.join(args.model_ckpt_dir,
                        f"{args.datasetName}_{args.fusion_type}")
    pred = Predictor.from_checkpoint(
        ckpt, cfg, batch_size=args.batch_size,
        tokenizer=make_tokenizer(args), media_loaders=make_loader_fns(args),
        device=args.device)
    preds, probs = pred.predict(samples)

    out = pd.DataFrame({
        "index": np.arange(len(ds)),
        "label": [ds[i][1] for i in range(len(ds))],
        "pred": preds,
        "confidence": probs.max(axis=1),
    })
    out.to_csv(output, index=False)
    acc = float((out["label"] == out["pred"]).mean())
    print(f"wrote {output} ({len(out)} rows, accuracy {acc:.4f})")
    return out


if __name__ == "__main__":
    main()
