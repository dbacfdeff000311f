"""cli.train across processes: two ranks of `python -m
missm_tpu_torch.cli.train --distributed file://...,2,i` on
tests/synthetic.py's mvsa tree, under --fsdp (DP 2 with the large leaves
sharded) and under --mesh_pipe 2 --pipe_schedule 1f1b (two stages), then a
one-process cli.test over what they wrote: rank 0 wrote the gathered final
model, at the full shapes of a fresh init, and the sweep runs on it.
"""
import os
import subprocess
import sys

import pytest
import torch

from missm_tpu_torch.cli import test as cli_test
from missm_tpu_torch.train.checkpoint import restore_checkpoint
from tests.synthetic import make_mvsa_tree
from tests.torch_world import REPO

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


@pytest.mark.parametrize("extra", [["--fsdp"],
                                   ["--mesh_pipe", "2", "--pipe_schedule",
                                    "1f1b"]], ids=["fsdp", "pipe_1f1b"])
def test_cli_train_on_two_ranks_then_test(extra, tmp_path, monkeypatch):
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
