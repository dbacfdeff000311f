"""The port's plateau scheduler, contrastive objective and checkpoints
(missm_tpu_torch.train.{plateau,contrastive,checkpoint},
models.tower.tower_forward) against the JAX package's.

- plateau_update against missm_tpu.train.plateau.plateau_update and
  torch.optim.lr_scheduler.ReduceLROnPlateau (tests/test_plateau_resume.py:14):
  the scale equal at every epoch.
- clip_loss and tower_forward against missm_tpu.train.contrastive.clip_loss
  and missm_tpu.models.tower.tower_forward on tiny towers whose params are
  built in JAX and bridged with from_jax, f32 on the CPU: 1e-5 absolute
  (summation order only).
- The checkpoint writer, AsyncSaver and the crash-safe swap as
  tests/test_plateau_resume.py:65-145, tests/test_checkpoint_writer.py and
  tests/test_checkpoint_faultinject.py hold the JAX package's: exact.
"""
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import tower as jtower
from missm_tpu.train import contrastive as jcontrastive
from missm_tpu.train import plateau as jplateau
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models import tower as ttower
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train import checkpoint as ck
from missm_tpu_torch.train import contrastive as tcontrastive
from missm_tpu_torch.train import plateau as tplateau
from missm_tpu_torch.train.step import init_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's workers
    share the cores (torch's default of one thread a core each makes them
    spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# Plateau
# ---------------------------------------------------------------------------

SEQUENCES = {
    "reference": [0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.7, 0.7, 0.7, 0.7, 0.7,
                  0.7, 0.65, 0.71],
    "threshold": [0.0, 0.0, 0.3, 0.30002, 0.30002, 0.30002, 0.30002,
                  0.30004, 0.31, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_plateau_equals_jax_and_torch(name):
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="max", factor=0.1, patience=3)
    got, want = tplateau.plateau_init(), jplateau.plateau_init()
    for m in SEQUENCES[name]:
        sched.step(m)
        got = tplateau.plateau_update(got, m)
        want = jplateau.plateau_update(want, m)
        assert (got.best, got.num_bad_epochs, got.scale) == \
            (want.best, want.num_bad_epochs, want.scale), m
        assert got.scale == pytest.approx(opt.param_groups[0]["lr"]), m


# ---------------------------------------------------------------------------
# clip_loss and the dual-tower forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modality", ["image", "video"])
def test_tower_forward_and_clip_loss_equal_jax(modality):
    jcfg, tcfg = jax_tiny_tower(modality), tiny_tower(modality)
    tree = jax.tree_util.tree_map(
        np.asarray, jtower.init_tower_params(jax.random.PRNGKey(3), jcfg))
    params = from_jax(tree, device="cpu")
    rng = np.random.default_rng(0)
    n = 3
    ids = rng.integers(1, jcfg.text.vocab_size - 1, (n, 16)).astype(np.int32)
    ids[:, 9] = jcfg.text.vocab_size - 1  # EOT
    shape = ((n, 3, jcfg.vision.num_frames, 32, 32) if modality == "video"
             else (n, 3, 32, 32))
    pix = rng.standard_normal(shape).astype(np.float32)
    want = jtower.tower_forward(tree, jcfg, jnp.asarray(ids),
                                jnp.asarray(pix))
    got = ttower.tower_forward(params, tcfg, torch.as_tensor(ids),
                               torch.as_tensor(pix))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(
        tcontrastive.clip_loss(got[1]).item(),
        float(jcontrastive.clip_loss(want[1])), rtol=0, atol=ATOL)


def test_clip_loss_equals_jax_on_random_logits():
    x = np.random.default_rng(1).standard_normal((7, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tcontrastive.clip_loss(torch.as_tensor(x)).item(),
        float(jcontrastive.clip_loss(jnp.asarray(x))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _cfg():
    return tft.ModelConfig(
        towers=(("image", tiny_tower("image")),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=8,
                            dropout_prob=0.0))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 97, (4, 16)).astype(np.int32)
    ids[:, 5] = 98
    data = {"language": ids,
            "image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32)}
    return data, rng.integers(0, 3, 4), np.array([0, 1, 4, 0])


def _leaves(tree):
    out = []
    tft.tree_map(out.append, tree)
    return out


def test_checkpoint_roundtrip_keeps_structure_and_dtypes(tmp_path):
    """tests/test_e2e_train_eval.py:166 (test_checkpoint_roundtrip) on the
    port: every leaf back bit for bit, with its dtype, in the same tree."""
    cfg = _cfg()
    params = tft.init_model_params(cfg, seed=2, device="cpu")
    params["encoder"]["image"]["vision"]["pre_ln"]["scale"] = \
        params["encoder"]["image"]["vision"]["pre_ln"]["scale"].bfloat16()
    p = str(tmp_path / "ck")
    ck.save_checkpoint(p, {"params": params, "step": 3, "none": None},
                       metadata={"epoch": 3})
    assert sorted(os.listdir(p)) == [ck.META_FILE, ck.TREE_FILE]
    tree, meta = ck.restore_checkpoint(p)
    assert meta == {"epoch": 3} and tree["step"] == 3 and tree["none"] is None
    a, b = _leaves(params), _leaves(tree["params"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert isinstance(tree["params"]["encoder"]["image"]["vision"]["blocks"],
                      list)


def test_resume_from_best_checkpoint_restores_adam_exactly(tmp_path):
    """tests/test_plateau_resume.py:29 on the port: restore the params and
    the optimizer's state_dict into a freshly built state and keep
    training. The Adam moments and step come back bit for bit, and the
    resumed step equals the uninterrupted one bit for bit."""
    cfg = _cfg()
    data, labels, missing = _batch()
    params = tft.init_model_params(cfg, seed=0, device="cpu")
    state, tx = init_train_state(params, cfg)
    step = make_train_step(cfg, tx, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, data, labels, missing, 1e-3, gen)

    p = str(tmp_path / "ck")
    ck.save_checkpoint(p, {"params": state.params,
                           "opt_state": tx.state_dict()},
                       metadata={"epoch": 0})
    state, m_full = step(state, data, labels, missing, 1e-3, gen)

    tree, meta = ck.restore_checkpoint(p)
    state2, tx2 = init_train_state(tree["params"], cfg)
    tx2.load_state_dict(tree["opt_state"])
    for (i, a), b in zip(tree["opt_state"]["state"].items(),
                         tx2.state_dict()["state"].values()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k]), (i, k)
    step2 = make_train_step(cfg, tx2, device="cpu")
    state2, m = step2(state2, data, labels, missing, 1e-3,
                      torch.Generator().manual_seed(0))
    assert m["loss"].item() == m_full["loss"].item()
    for a, b in zip(_leaves(state.params), _leaves(state2.params)):
        assert torch.equal(a, b)


def test_async_saver_roundtrip_and_order(tmp_path):
    path = str(tmp_path / "ckpt")
    saver = ck.AsyncSaver()
    saver.save(path, {"w": torch.arange(8.0)}, metadata={"epoch": 0})
    saver.save(path, {"w": torch.arange(8.0) * 3}, metadata={"epoch": 1})
    saver.wait()
    tree, meta = ck.restore_checkpoint(path)
    assert torch.equal(tree["w"], torch.arange(8.0) * 3)
    assert meta["epoch"] == 1


def test_async_saver_error_surfaces(tmp_path, monkeypatch):
    def boom(path, host_tree, metadata):
        raise OSError("disk full")
    monkeypatch.setattr(ck, "_write", boom)
    saver = ck.AsyncSaver()
    saver.save(str(tmp_path / "x"), {"w": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()  # the error is consumed: the saver is reusable


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_async_saver_snapshot_precedes_mutation(tmp_path, kind):
    """save() copies to the host before it returns: the train step updates
    params in place, and a CPU tensor's .cpu() is the same storage."""
    path = str(tmp_path / "snap")
    src = {"w": torch.ones(4) if kind == "tensor" else np.ones(4, np.float32)}
    saver = ck.AsyncSaver()
    ck._WRITER.submit(lambda: time.sleep(0.2))  # the write queues
    saver.save(path, src)
    src["w"] *= 100.0
    saver.wait()
    tree, _ = ck.restore_checkpoint(path)
    assert torch.equal(tree["w"], torch.ones(4))


def test_checkpoint_crash_preserves_previous_best(tmp_path):
    """tests/test_plateau_resume.py:98: a process exiting with a write in
    flight exits with its own code and leaves a complete checkpoint (the
    port finishes the submitted write at exit, so epoch 1), never a torn
    one."""
    path = str(tmp_path / "crash_ckpt")
    prog = (
        "import sys; sys.path.insert(0, %r); import torch; "
        "from missm_tpu_torch.train.checkpoint import AsyncSaver; "
        "s = AsyncSaver(); "
        "s.save(%r, {'w': torch.zeros(6)}, metadata={'epoch': 0}); "
        "s.wait(); "
        "s.save(%r, {'w': torch.ones(6)}, metadata={'epoch': 1}); "
        "raise SystemExit(7)" % (REPO, path, path))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 7, r.stderr[-2000:]
    tree, meta = ck.restore_checkpoint(path)
    assert meta["epoch"] == 1
    assert torch.equal(tree["w"], torch.ones(6))


def test_writer_executes_in_submission_order():
    order = []
    j1 = ck._WRITER.submit(lambda: (time.sleep(0.25), order.append("slow")))
    j2 = ck._WRITER.submit(lambda: order.append("fast"))
    assert j2.done.wait(10) and j1.done.wait(10)
    assert order == ["slow", "fast"]


def test_writer_surfaces_errors_per_job():
    j1 = ck._WRITER.submit(lambda: (_ for _ in ()).throw(RuntimeError("x")))
    j2 = ck._WRITER.submit(lambda: None)
    assert j2.done.wait(10)
    assert isinstance(j1.err, RuntimeError)
    assert j2.err is None


def test_two_savers_and_sync_save_interleaved(tmp_path):
    best, last = ck.AsyncSaver(), ck.AsyncSaver()
    for i in range(3):
        best.save(str(tmp_path / "best"), {"x": torch.full((4,), i)},
                  metadata={"i": i})
        last.save(str(tmp_path / "last"), {"x": torch.full((4,), 100 + i)},
                  metadata={"i": 100 + i})
    ck.save_checkpoint(str(tmp_path / "final"), {"x": torch.full((4,), 7)},
                       metadata={"i": 7})
    best.wait()
    last.wait()
    for name, want in (("best", 2), ("last", 102), ("final", 7)):
        tree, meta = ck.restore_checkpoint(str(tmp_path / name))
        assert torch.equal(tree["x"], torch.full((4,), want))
        assert meta["i"] == want


def test_async_save_snapshots_metadata_at_submission(tmp_path):
    s = ck.AsyncSaver()
    ck._WRITER.submit(lambda: time.sleep(0.3))
    hist = [{"epoch": 0}]
    s.save(str(tmp_path / "c"), {"x": torch.zeros(2)}, metadata={"h": hist})
    hist.append({"epoch": 1})
    s.wait()
    assert ck.read_metadata(str(tmp_path / "c"))["h"] == [{"epoch": 0}]


def test_old_dir_is_recovered_and_a_new_write_replaces_it(tmp_path):
    """The crash window between _write's two renames leaves only
    `path.old`: restore and read_metadata resolve it, and the next write
    lands at `path` and removes the `.old` and any `.tmp` debris."""
    path = str(tmp_path / "last")
    ck.save_checkpoint(path, {"x": torch.full((3,), 5.0)},
                       metadata={"epoch": 5})
    os.rename(path, path + ".old")
    os.makedirs(path + ".tmp")  # a write that died before its swap
    tree, meta = ck.restore_checkpoint(path)
    assert meta["epoch"] == 5 and torch.equal(tree["x"],
                                              torch.full((3,), 5.0))
    assert ck.read_metadata(path)["epoch"] == 5
    ck.save_checkpoint(path, {"x": torch.full((3,), 6.0)},
                       metadata={"epoch": 6})
    assert sorted(os.listdir(tmp_path)) == ["last"]
    assert ck.read_metadata(path)["epoch"] == 6


def test_checkpoints_refuse_more_than_one_process(tmp_path, monkeypatch):
    """Across processes rank 0 alone writes, and every save ends on a
    barrier of all ranks (the JAX package's swap barrier); a restore reads
    the whole tree on any rank. Ranks 1 and 0 of a world of 2, one after
    the other, with the barrier counted."""
    barriers = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "barrier",
                        lambda: barriers.append(1))
    tree = {"x": torch.arange(3.0)}
    for rank in (1, 0):
        monkeypatch.setattr(torch.distributed, "get_rank", lambda r=rank: r)
        a, b = str(tmp_path / f"a{rank}"), str(tmp_path / f"b{rank}")
        ck.save_checkpoint(a, tree, metadata={"rank": rank})
        saver = ck.AsyncSaver()
        saver.save(b, tree)
        saver.wait()
        saver.wait()  # nothing in flight: no second barrier
        assert os.path.isdir(a) == os.path.isdir(b) == (rank == 0)
    assert len(barriers) == 4
    got, meta = ck.restore_checkpoint(str(tmp_path / "a0"))
    assert torch.equal(got["x"], tree["x"]) and meta == {"rank": 0}


# ---------------------------------------------------------------------------
# SIGKILL fuzz (tests/test_checkpoint_faultinject.py:66 on the port's writer)
# ---------------------------------------------------------------------------

_WORKER = """
import sys
sys.path.insert(0, sys.argv[2])
import torch
from missm_tpu_torch.train.checkpoint import save_checkpoint
e = int(sys.argv[3])
while True:
    e += 1
    save_checkpoint(sys.argv[1], {
        "epoch_arr": torch.full((256, 256), float(e)),
        "nested": {"w": torch.full((8,), float(e) * 2.0)}},
        metadata={"epoch": e})
    print(f"WROTE {e}", flush=True)
"""
N_KILLS = 4


def _spawn(path, start_epoch):
    return subprocess.Popen(
        [sys.executable, "-c", _WORKER, path, REPO, str(start_epoch)],
        stdout=subprocess.PIPE, text=True, cwd=REPO)


def _wait_first_write(proc, timeout=120.0):
    t0 = time.time()
    line = proc.stdout.readline()
    while not line.startswith("WROTE"):
        assert time.time() - t0 < timeout, "child never wrote"
        assert proc.poll() is None, "child died before its first write"
        line = proc.stdout.readline()
    return int(line.split()[1])


def _assert_consistent(path):
    tree, meta = ck.restore_checkpoint(path)
    e = meta["epoch"]
    assert torch.equal(tree["epoch_arr"], torch.full((256, 256), float(e)))
    assert torch.equal(tree["nested"]["w"], torch.full((8,), float(e) * 2))
    assert ck.read_metadata(path)["epoch"] == e
    return e


def test_sigkill_fuzz_preserves_checkpoint_invariant(tmp_path):
    """A child writes checkpoints back to back and is SIGKILLed at random
    points of its write cadence: every survivor restores whole (tensors
    match the metadata's epoch), never goes backwards, and a fresh writer
    carries on from it past the .tmp/.old debris."""
    rng = np.random.default_rng(2025)
    path = str(tmp_path / "last")
    last_epoch = 0
    for _ in range(N_KILLS):
        proc = _spawn(path, last_epoch)
        try:
            first = _wait_first_write(proc)
            time.sleep(float(rng.uniform(0.0, 0.05)))
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
        e = _assert_consistent(path)
        assert e >= first and e >= last_epoch, (e, first, last_epoch)
        last_epoch = e
    proc = _spawn(path, last_epoch)
    try:
        assert _wait_first_write(proc) == last_epoch + 1
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
    assert _assert_consistent(path) >= last_epoch
