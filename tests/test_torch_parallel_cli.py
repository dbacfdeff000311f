"""cli.train across processes: two ranks of `python -m
missm_tpu_torch.cli.train --distributed file://...,2,i` on
tests/synthetic.py's mvsa tree, under --fsdp (DP 2 with the large leaves
sharded) and under --mesh_pipe 2 --pipe_schedule 1f1b (two stages), then a
one-process cli.test over what they wrote: rank 0 wrote the gathered final
model, at the full shapes of a fresh init, and the sweep runs on it. Then
cli.predict --distributed from that checkpoint on two ranks (a gloo world
of tests/torch_world.py), under the same layout flags and under one more
layout (DP 2 after --fsdp, --mesh_model 2 after the pipeline), against
one process's cli.predict: rank 0's predictions.csv holds the same rows,
labels and preds, the confidences within 1e-5 (f32); each data rank
collated only its shard of the rows, and each rank of a sharded layout
holds fewer parameter elements than the whole model.
"""
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from missm_tpu_torch.cli import predict as cli_predict
from missm_tpu_torch.cli import test as cli_test
from missm_tpu_torch.train.checkpoint import restore_checkpoint
from tests.synthetic import make_mvsa_tree
from tests.torch_world import REPO, run_world

pytestmark = pytest.mark.filterwarnings("ignore")

TINY = ["--modality_types", "language", "image", "--model_scale", "tiny",
        "--hash_tokenizer", "--device", "cpu"]


def _train_world(csv, run, extra, timeout=180):
    argv = ["--datasetName", "mvsa", "--csv_path", csv, "--fusion_type",
            "sum", *TINY, "--init", "random", "--batch_size", "4",
            "--num_epochs", "1", "--num_workers", "0", "--bf16", "false",
            *extra]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    rdv = f"file://{run}/rendezvous"
    logs = [open(os.path.join(run, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "missm_tpu_torch.cli.train", *argv,
         "--distributed", f"{rdv},2,{r}"], cwd=run, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    out = [open(os.path.join(run, f"rank{r}.log")).read() for r in range(2)]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        o[-3000:] for o in out)
    return out


@pytest.mark.parametrize("extra,also", [
    (["--fsdp"], []),
    (["--mesh_pipe", "2", "--pipe_schedule", "1f1b"], ["--mesh_model", "2"]),
], ids=["fsdp", "pipe_1f1b"])
def test_cli_train_on_two_ranks_then_test(extra, also, tmp_path,
                                          monkeypatch):
    csv = make_mvsa_tree(str(tmp_path / "mvsa"), write_media=True)
    run = tmp_path / "run"
    run.mkdir()
    out = _train_world(csv, str(run), extra)
    assert "Training completed!" in out[0]
    assert "Training completed!" not in out[1]  # rank 0 alone prints
    tree, _ = restore_checkpoint(str(run / "final_model" / "mvsa_sum"))
    params = tree["params"]
    assert len(params["encoder"]["image"]["vision"]["blocks"]) == 2
    fc1 = params["encoder"]["language"]["text"]["blocks"][0]["mlp"]["fc1"]
    assert tuple(fc1["w"].shape) == (32, 64)
    assert all(torch.isfinite(t).all() for t in (fc1["w"], fc1["b"]))
    monkeypatch.chdir(run)
    res = cli_test.main(["--datasetName", "mvsa", "--csv_path", csv,
                     "--fusion_type", "sum", "--test_types", "sum",
                     "--test_missing_type", "image", *TINY, "--batch_size",
                     "8", "--num_workers", "0", "--bf16", "false"])
    assert set(res["sum"]["image"]) and (
        run / "new_txt_experiment" / "mvsa_sum_image.txt").exists()

    # predictions from the checkpoint: one process, then two ranks under
    # the training layout and under `also`, in turn in one world
    pargv = ["--datasetName", "mvsa", "--csv_path", csv, "--fusion_type",
             "sum", *TINY, "--batch_size", "3", "--bf16", "false"]
    one = cli_predict.main(pargv + ["--output", "one.csv"])
    assert len(one) == 10  # the synthetic tree's test split
    full = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    layouts = [extra, also]
    ranks = run_world(2, "tests.torch_parallel_cases:predict_case",
                      tmp_path, argvs=[pargv + flags + [
                          "--output", f"two{i}.csv"]
                          for i, flags in enumerate(layouts)], cwd=str(run))
    for i, flags in enumerate(layouts):
        seen = [r[i] for r in ranks]
        # DP and FSDP: a data rank collates its 5 rows; TP and the
        # pipeline: one data replica, every row on both ranks
        n_data = 1 if {"--mesh_model", "--mesh_pipe"} & set(flags) else 2
        assert [r["rows"] for r in seen] == [10 // n_data] * 2, seen
        sharded = bool(flags)  # every layout flag shards the params
        assert all((r["numel"] < full) == sharded for r in seen), (
            seen, full)
        two = pd.read_csv(run / f"two{i}.csv")
        assert list(two.columns) == list(one.columns)
        for col in ("index", "label", "pred"):
            np.testing.assert_array_equal(two[col], one[col], err_msg=col)
        np.testing.assert_allclose(two["confidence"], one["confidence"],
                                   atol=1e-5, rtol=0)
