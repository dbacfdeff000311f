"""Batch inference entry point, after missm_tpu/cli/predict.py: load a
final checkpoint and write predictions for a label.csv-style dataset split
on `--device` (the card by default).

python -m missm_tpu_torch.cli.predict --datasetName mvsa \
    --csv_path .../label.csv --fusion_type sum --split test \
    --output predictions.csv

With `--artifact DIR` it serves from a cli.export artifact instead (no
checkpoint restore and no model config; the artifact's batch size).

With `--distributed` (and the layout flags of cli.train) the checkpoint is
restored and partitioned as cli.test does it, so each rank keeps its
partition of the params; the eval batch is rounded to the mesh
(round_eval_batch), each data rank predicts its shard of the rows at
`--batch_size` / n_data a batch, the rows are gathered, and rank 0 writes
them in dataset order (eval/predictor.py).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..compat.args import test_args
from ..data.datasets import DATASET_SPECS, MMDataset, encode_labels
from ..eval.predictor import Predictor
from ..train.checkpoint import restore_checkpoint
from .common import (build_model_config, make_loader_fns, make_tokenizer,
                     round_eval_batch, setup_layout, setup_mesh)


def _serve_artifact(path, samples, args):
    """(preds, probs) of `samples` from the artifact at `path`, in chunks
    of its batch size: the artifact carries the model and its params."""
    from ..eval.artifact import load_artifact

    art = load_artifact(path, device=args.device)
    tokenizer, loaders = make_tokenizer(args), make_loader_fns(args)
    preds, probs = [], []
    for i in range(0, len(samples), art.batch_size):
        chunk = samples[i:i + art.batch_size]
        data = {}
        for m in art.manifest["modality_types"]:
            col = [s[m] for s in chunk]
            if m == "language":
                data[m] = tokenizer(list(col))
            else:
                items = [loaders[m](x) for x in col]
                data[m] = (torch.stack(items) if torch.is_tensor(items[0])
                           else np.stack([np.asarray(x) for x in items]))
        p, pr = art.predict_arrays(data)
        preds.append(p)
        probs.append(pr)
    return np.concatenate(preds), np.concatenate(probs)


def main(argv=None):
    import sys
    raw = list(argv if argv is not None else sys.argv[1:])
    split = "test"
    output = "predictions.csv"
    artifact = None
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
                artifact = val
    args = test_args(raw)
    # --distributed: a multi-device artifact serves each rank's rows, a
    # checkpoint's Predictor each data rank's shard; rank 0 writes
    import torch.distributed as dist
    mesh = setup_mesh(args)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    spec = DATASET_SPECS[args.datasetName]
    import pandas as pd
    df = pd.read_csv(args.csv_path, converters={"clip_id": str})
    labels, num_classes = encode_labels(list(df["annotation"]))
    sub = df[df["mode"] == split]
    ds = MMDataset(spec, sub, "/".join(args.csv_path.split("/")[:-1]),
                   labels[df["mode"] == split], split, False)
    samples = [ds[i][0] for i in range(len(ds))]

    if artifact is not None:
        preds, probs = _serve_artifact(artifact, samples, args)
    else:
        rank_batch = round_eval_batch(args, mesh)
        cfg = build_model_config(args, num_classes, mesh=mesh)
        ckpt = os.path.join(args.model_ckpt_dir,
                            f"{args.datasetName}_{args.fusion_type}")
        tree, _ = restore_checkpoint(ckpt)
        # partitioned on the host: only this rank's part goes to its device
        cfg, params = setup_layout(args, cfg, tree["params"], mesh)
        del tree
        pred = Predictor(params, cfg, batch_size=rank_batch,
                         tokenizer=make_tokenizer(args),
                         media_loaders=make_loader_fns(args),
                         device=args.device)
        preds, probs = pred.predict(samples)

    out = pd.DataFrame({
        "index": np.arange(len(ds)),
        "label": [ds[i][1] for i in range(len(ds))],
        "pred": preds,
        "confidence": probs.max(axis=1),
    })
    if lead:
        out.to_csv(output, index=False)
        acc = float((out["label"] == out["pred"]).mean())
        print(f"wrote {output} ({len(out)} rows, accuracy {acc:.4f})")
    return out


if __name__ == "__main__":
    main()
