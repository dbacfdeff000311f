"""The parallel layouts' checkpoints, serving artifact and dryrun, on gloo
CPU worlds (tests/torch_world.py, each with its own timeout):

- FSDP-2 and TP-2 save after a train step (rank 0 writes the gathered tree
  and Adam state); a one-process restore equals the gathered tree, leaf
  for leaf, at the full shapes of a fresh init;
- the DP serving artifact (eval/artifact.py, mesh=) over 2 ranks against
  the one-rank artifact: preds equal, probs within 1e-6;
- `python -m missm_tpu_torch.parallel.dryrun 4 --device cpu`: the five
  layouts of the JAX dryrun at N = 4, each OK line printed.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from missm_tpu_torch.compat.from_jax import to_numpy
from missm_tpu_torch.models.finetune import init_model_params
from missm_tpu_torch.train.checkpoint import restore_checkpoint
from tests.torch_parallel_cases import model_config, numpy_batch
from tests.torch_world import REPO, run_world

TOWERS = ("image",)
FUSION = dict(fusion_type="sum", modality_types=("language", "image"),
              output_dims=3, feature_dims=24, fusion_dim=16,
              dropout_prob=0.0)


def _tree():
    return to_numpy(init_model_params(model_config(TOWERS, FUSION),
                                      device="cpu"))


def _leaves(t, path=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, t


@pytest.mark.parametrize("n_data, n_model, fsdp, local", [
    (2, 1, True, (32, 32)), (1, 2, False, (32, 32))], ids=["fsdp2", "tp2"])
def test_checkpoint_gathers_and_restores_in_one_process(
        n_data, n_model, fsdp, local, tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt")
    res = run_world(n_data * n_model, "tests.torch_parallel_cases:"
                    "checkpoint_case", tmp_path, tree=tree, towers=TOWERS,
                    fusion=FUSION, n_data=n_data, n_model=n_model, fsdp=fsdp,
                    path=path)
    assert all(r["local"] == local for r in res)
    restored, _ = restore_checkpoint(path)
    got = dict(_leaves(to_numpy(restored["params"])))
    want = dict(_leaves(res[0]["params"]))
    full = dict(_leaves(tree))
    assert set(got) == set(want) == set(full)
    for p, w in want.items():
        assert got[p].shape == full[p].shape, p
        np.testing.assert_array_equal(got[p], w, err_msg=p)
    # the Adam moments come back at full shape too
    opt = restored["opt_state"]
    assert opt["step"] == 1.0
    fc1 = opt["exp_avg"]["encoder"]["language"]["text"]["blocks"][0]["mlp"][
        "fc1"]["w"]
    assert tuple(fc1.shape) == (32, 64)


def test_dp_artifact_serves_over_two_ranks(tmp_path):
    tree = _tree()
    data, labels, missing = numpy_batch(4, 16, modalities=TOWERS)
    kw = dict(tree=tree, towers=TOWERS, fusion=FUSION,
              batch=(data, labels, missing))
    one = run_world(1, "tests.torch_parallel_cases:artifact_case", tmp_path,
                    out_dir=str(tmp_path / "one"), **kw)[0]
    two = run_world(2, "tests.torch_parallel_cases:artifact_case", tmp_path,
                    out_dir=str(tmp_path / "two"), **kw)
    assert one["manifest"]["num_devices"] == 1
    for r in two:
        assert r["manifest"]["num_devices"] == 2
        assert r["manifest"]["data_axis"] == "data"
        assert r["manifest"]["batch_size"] == 4
        np.testing.assert_array_equal(r["preds"], one["preds"])
        np.testing.assert_allclose(r["probs"], one["probs"], rtol=0,
                                   atol=1e-6)


def test_dryrun_four_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "missm_tpu_torch.parallel.dryrun", "4",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=400, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip(4)")]
    assert [ln.split("mesh=")[1].split(")")[0] for ln in lines] == [
        "(4x1", "(4x1 fsdp", "(2x2", "(2x1x2pipe", "(2x1x2pipe[1f1b]"]
    assert all(ln.endswith(" OK") for ln in lines)
