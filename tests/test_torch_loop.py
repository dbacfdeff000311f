"""The port's train loop (missm_tpu_torch.train.loop.train_loop) against the
JAX package's (missm_tpu.train.loop.train_loop), and its resume and
preemption on its own.

- Against JAX: a tiny image+text `sum` model in f32 on the CPU, params
  built in JAX and bridged with from_jax, dropout 0 (dropout cannot be
  pinned by seed across frameworks), the same mvsa tree through each
  package's training_loader, 5 epochs at lr 1e-3 (enough for the plateau
  to cut the rate). Each epoch's train and val loss within 1e-5 relative
  (f32 summation order), accuracy, F1 and AUC equal, the same best epoch,
  and the same plateau state in the last resume checkpoint.
- Resume within the port, bit for bit: checkpoint_every + resume_from
  against an uninterrupted run, with head dropout on (params, Adam moments
  and step, the generator's state, plateau), after
  tests/test_e2e_train_eval.py:87; and the port versions of
  tests/test_preemption.py (a SIGTERM mid-epoch and between epochs, the
  `random` stream across a resume).
"""
import os
import re
import signal
import zlib

import jax
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.data.loaders import training_loader as jax_training_loader
from missm_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.train import checkpoint as jck
from missm_tpu.train.loop import train_loop as jax_train_loop
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.data.loaders import testing_loader, training_loader
from missm_tpu_torch.data.tokenizer import HashTokenizer
from missm_tpu_torch.eval.sweep import run_missing_sweep
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train.checkpoint import (read_metadata,
                                              restore_checkpoint,
                                              save_checkpoint)
from missm_tpu_torch.train.loop import PreemptedError, train_loop
from missm_tpu_torch.train.step import make_eval_step
from tests.synthetic import Args, make_mvsa_tree

pytestmark = pytest.mark.filterwarnings("ignore")

LOSS_RTOL = 1e-5
EPOCHS = 5
quiet = lambda *a: None


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's workers
    share the cores (torch's default of one thread a core each makes them
    spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fusion(dropout_prob):
    return dict(fusion_type="sum", modality_types=("language", "image"),
                output_dims=3, feature_dims=24, fusion_dim=8,
                dropout_prob=dropout_prob)


def _cfg(dropout_prob=0.1):
    return tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**_fusion(dropout_prob)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 24 train rows = 6 batches an epoch: room for a mid-epoch SIGTERM
    root = tmp_path_factory.mktemp("mvsa_loop")
    return make_mvsa_tree(str(root), n_train=24)


def _image(path):
    """A fake image decoder seeded by the file's name: the same arrays in
    every process (tests/synthetic.py's seeds by hash(), which the
    interpreter salts per process), so the epochs' metrics are fixed."""
    seed = zlib.crc32(os.path.basename(str(path)).encode())
    return np.random.default_rng(seed).standard_normal(
        (3, 32, 32)).astype(np.float32)


def _loaders(csv, args=None):
    args = args or Args(fusion_type="sum", batch_size=4)
    return training_loader(args, csv, HashTokenizer(99, 16),
                           {"image": _image})[:2]


def _params(cfg, seed=0):
    return tft.init_model_params(cfg, seed=seed, device="cpu")


def _run(params, cfg, loaders, save_dir, **kw):
    kw = dict(dict(num_epochs=4, learning_rate=1e-3, save_dir=save_dir,
                   device="cpu", log=quiet), **kw)
    return train_loop(params, cfg, *loaders, **kw)


# ---------------------------------------------------------------------------
# Against the JAX package's loop
# ---------------------------------------------------------------------------

def test_train_loop_equals_jax(tree, tmp_path):
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=JaxFusionConfig(**_fusion(0.0)))
    cfg = _cfg(0.0)
    jparams = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg))
    args = Args(fusion_type="sum", batch_size=4)
    _, want = jax_train_loop(
        jax.tree_util.tree_map(np.array, jparams), jcfg,
        *jax_training_loader(args, tree, JaxHashTokenizer(99, 16),
                             {"image": _image})[:2],
        num_epochs=EPOCHS, learning_rate=1e-3,
        save_dir=str(tmp_path / "jax"), checkpoint_every=1, log=quiet)
    _, got = _run(from_jax(jparams, device="cpu"), cfg, _loaders(tree, args),
                  str(tmp_path / "port"), num_epochs=EPOCHS,
                  checkpoint_every=1)
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"] and g["n_batches"] == w["n_batches"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL)
        for k in ("val_accuracy", "val_f1", "val_auc"):
            assert g[k] == w[k], (g["epoch"], k)
    gm = read_metadata(str(tmp_path / "port" / "last"))["loop"]
    wm = jck.read_metadata(str(tmp_path / "jax" / "last"))["loop"]
    for k in ("epoch", "plateau", "best_metric", "best_epoch", "bad_epochs"):
        assert gm[k] == wm[k], k
    assert gm["plateau"]["scale"] < 1.0  # the plateau cut the rate


# ---------------------------------------------------------------------------
# The loop, its checkpoints and the sweep (tests/test_e2e_train_eval.py)
# ---------------------------------------------------------------------------

def test_train_loop_and_sweep(tree, tmp_path):
    cfg = _cfg()
    save_dir = str(tmp_path / "ckpt")
    final = str(tmp_path / "final_model")
    best, hist = _run(_params(cfg), cfg, _loaders(tree), save_dir,
                      num_epochs=2, final_path=final)
    assert len(hist) == 2
    assert os.path.isdir(os.path.join(save_dir, "best_model"))
    restored, meta = restore_checkpoint(final)
    assert set(restored) == {"params"}
    args = Args(fusion_type="sum", batch_size=4)
    _, test_loaders, _ = testing_loader(args, tree, HashTokenizer(99, 16),
                                        {"image": _image})
    out_dir = str(tmp_path / "txt")
    results = run_missing_sweep(restored["params"], cfg,
                                make_eval_step(cfg, device="cpu"),
                                test_loaders, out_dir, "mvsa", "sum",
                                verbose=False, device="cpu")
    assert set(results) == {"language", "image", "mixed"}
    text = open(os.path.join(out_dir, "mvsa_sum_language.txt")).read()
    blocks = [b for b in text.split("\n\n") if b.strip()]
    assert len(blocks) == 10
    pat = (r"Testing with missing ratio: [\d.]+\nTest Results:\n"
           r"Test Loss: -?\d+\.\d{4}\nTest Accuracy: \d+\.\d{4}\n"
           r"Test F1 Score: \d+\.\d{4}\nTest AUC: \d+\.\d{4}")
    assert all(re.match(pat, b) for b in blocks)


def _equal_states(a_dir, b_dir):
    a, am = restore_checkpoint(os.path.join(a_dir, "last"))
    b, bm = restore_checkpoint(os.path.join(b_dir, "last"))
    assert am["loop"]["epoch"] == bm["loop"]["epoch"]
    fa, fb = [], []
    tft.tree_map(fa.append, {"p": a["params"], "o": a["opt_state"]["state"]})
    tft.tree_map(fb.append, {"p": b["params"], "o": b["opt_state"]["state"]})
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert torch.equal(x, y)
    assert a["step"] == b["step"]
    for k in ("generator_state", "plateau", "py_random", "best_metric",
              "best_epoch", "bad_epochs"):
        assert am["loop"][k] == bm["loop"][k], k
    return a, am


def test_checkpoint_every_resume_exact(tree, tmp_path):
    """Two epochs, stop, resume for two more: bit for bit the uninterrupted
    four-epoch run, head dropout on so the generator's state matters."""
    cfg = _cfg(0.1)
    full, half = str(tmp_path / "full"), str(tmp_path / "half")
    _run(_params(cfg), cfg, _loaders(tree), full, checkpoint_every=1)
    _run(_params(cfg), cfg, _loaders(tree), half, num_epochs=2,
         checkpoint_every=1)
    _, hist = _run(_params(cfg), cfg, _loaders(tree), half,
                   checkpoint_every=1,
                   resume_from=os.path.join(half, "last"))
    assert len(hist) == 4
    tree_, meta = _equal_states(full, half)
    assert meta["loop"]["epoch"] == 3 and tree_["step"] == 4 * 6
    assert len(tree_["opt_state"]["state"]) > 0


def test_resume_requires_loop_state(tree, tmp_path):
    cfg = _cfg()
    params = _params(cfg)
    path = str(tmp_path / "not_resumable")
    save_checkpoint(path, {"params": params, "opt_state": {},
                           "teacher_fusion": None, "step": 0})
    with pytest.raises(ValueError, match="no loop state"):
        _run(params, cfg, _loaders(tree), None, num_epochs=1,
             resume_from=path)


def test_train_loop_refuses_more_than_one_process(tmp_path):
    """train_loop across processes (DP over 2 gloo ranks, each its shard of
    13 rows): a SIGTERM on rank 1 alone, mid-epoch, stops both ranks at
    the same batch (`_agreed_stop`; a rank that broke at another batch
    would leave its peer's collectives waiting until the world's timeout)
    before the collective resume save, which rank 0 writes; `--resume`
    then runs both ranks to the end, their params equal."""
    from missm_tpu_torch.compat.from_jax import to_numpy
    from missm_tpu_torch.models.finetune import init_model_params
    from tests.torch_parallel_cases import model_config, numpy_batch
    from tests.torch_world import run_world

    fusion = dict(fusion_type="sum", modality_types=("language", "image"),
                  output_dims=3, feature_dims=24, fusion_dim=16,
                  dropout_prob=0.1)
    towers = ("image",)
    tree = to_numpy(init_model_params(model_config(towers, fusion),
                                      device="cpu"))
    kw = dict(tree=tree, batch=numpy_batch(13, 16, modalities=towers),
              towers=towers, fusion=fusion, save_dir=str(tmp_path / "run"))
    first = run_world(2, "tests.torch_parallel_cases:loop_case", tmp_path,
                      sigterm_at=(1, 0, 1), **kw)
    assert [r["end"] for r in first] == ["preempted", "preempted"]
    assert first[0]["meta"] == first[1]["meta"]
    assert first[0]["meta"]["epoch"] == 0
    assert first[0]["meta"]["batches_done"] in (1, 2)
    done = run_world(2, "tests.torch_parallel_cases:loop_case", tmp_path,
                     resume=True, **kw)
    assert [r["end"] for r in done] == ["done", "done"]
    assert done[0]["epochs"] == done[1]["epochs"] == 2

    def flat(t, out):
        for v in t.values():
            flat(v, out) if isinstance(v, dict) else out.append(v)
        return out
    for a, b in zip(flat(done[0]["params"], []), flat(done[1]["params"], [])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Preemption (tests/test_preemption.py)
# ---------------------------------------------------------------------------

class _SigtermOnEpoch:
    """Loader wrapper: raises SIGTERM in-process partway through iteration
    number `epoch` of this wrapper, in whatever thread iterates (the
    prefetch thread for the train loader); CPython runs the handler on the
    main thread, the production delivery path."""

    def __init__(self, loader, epoch: int, after: int = 0):
        self.loader = loader
        self.batch_size = loader.batch_size
        self.epoch = epoch
        self.after = after
        self._iters = -1

    def __iter__(self):
        self._iters += 1
        for i, b in enumerate(self.loader):
            if self._iters == self.epoch and i == self.after:
                signal.raise_signal(signal.SIGTERM)
            yield b


def test_sigterm_mid_epoch_checkpoints_and_resumes(tree, tmp_path):
    cfg = _cfg()
    save_dir = str(tmp_path / "ckpt")
    tl, vl = _loaders(tree)
    with pytest.raises(PreemptedError):
        _run(_params(cfg), cfg, (_SigtermOnEpoch(tl, epoch=1, after=1), vl),
             save_dir, num_epochs=3)
    last = os.path.join(save_dir, "last")
    meta = read_metadata(last)
    assert meta["preempted"]["epoch"] == 1
    assert meta["preempted"]["batches_done"] >= 1
    # epoch 0 completed; the interrupted epoch 1 re-runs on resume, the
    # generator rewound to its start (= the state after epoch 0)
    assert meta["loop"]["epoch"] == 0 and len(meta["loop"]["history"]) == 1
    _, hist = _run(_params(cfg), cfg, _loaders(tree), save_dir,
                   num_epochs=3, resume_from=last)
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL

    # the rewound generator is the one an uninterrupted run had after
    # epoch 0
    ref = str(tmp_path / "ref")
    _run(_params(cfg), cfg, _loaders(tree), ref, num_epochs=1,
         checkpoint_every=1)
    assert (meta["loop"]["generator_state"]
            == read_metadata(os.path.join(ref, "last"))["loop"]
            ["generator_state"])


def test_sigterm_between_epochs_resumes_exactly(tree, tmp_path):
    """Signal during epoch 1's eval: epoch 1 completes, the stop is taken at
    the top of epoch 2, and the resumed run equals an uninterrupted one
    bit for bit."""
    cfg = _cfg(0.1)
    full, half = str(tmp_path / "full"), str(tmp_path / "half")
    _run(_params(cfg), cfg, _loaders(tree), full, checkpoint_every=1)
    tl, vl = _loaders(tree)
    with pytest.raises(PreemptedError):
        _run(_params(cfg), cfg, (tl, _SigtermOnEpoch(vl, epoch=1)), half)
    meta = read_metadata(os.path.join(half, "last"))
    assert meta["loop"]["epoch"] == 1
    assert meta["preempted"]["batches_done"] == 0
    _run(_params(cfg), cfg, _loaders(tree), half, checkpoint_every=1,
         resume_from=os.path.join(half, "last"))
    _, meta = _equal_states(full, half)
    assert meta["loop"]["epoch"] == 3


class _DrawRecorder:
    """One process-global `random` draw per batch, a stand-in for the
    datasets' train-missing / retrieval random.choice draws."""

    def __init__(self, loader, draws: list):
        self.loader = loader
        self.batch_size = loader.batch_size
        self.draws = draws

    def __iter__(self):
        import random as _r
        for b in self.loader:
            self.draws.append(_r.random())
            yield b


def test_resume_continues_python_random_stream(tree, tmp_path):
    import random as _r
    cfg = _cfg()
    _r.seed(123)
    full_draws = []
    tl, vl = _loaders(tree)
    _run(_params(cfg), cfg, (_DrawRecorder(tl, full_draws), vl),
         str(tmp_path / "full"), checkpoint_every=1)
    _r.seed(123)
    half_draws = []
    tl, vl = _loaders(tree)
    _run(_params(cfg), cfg, (_DrawRecorder(tl, half_draws), vl),
         str(tmp_path / "half"), num_epochs=2, checkpoint_every=1)
    _r.seed(999)  # resume must restore the position, not trust the seed
    tl, vl = _loaders(tree)
    _run(_params(cfg), cfg, (_DrawRecorder(tl, half_draws), vl),
         str(tmp_path / "half"), checkpoint_every=1,
         resume_from=str(tmp_path / "half" / "last"))
    assert len(full_draws) == len(half_draws) == 4 * 6
    assert full_draws == half_draws


def test_profile_dir_writes_a_chrome_trace(tree, tmp_path):
    """--profile_dir: epoch-0 batches 4-6 under torch.profiler, written as
    a Chrome trace (the JAX loop's jax.profiler window)."""
    cfg = _cfg()
    prof = str(tmp_path / "trace")
    _run(_params(cfg), cfg, _loaders(tree), None, num_epochs=1,
         profile_dir=prof)
    import json
    with open(os.path.join(prof, "train_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
