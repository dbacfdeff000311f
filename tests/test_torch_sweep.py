"""The port's evaluation layer (missm_tpu_torch.eval, .metrics, .data.missing,
.utils.prefetch) against the JAX package's.

A tiny image+text model with the `concat` head, f32 on the CPU, params
initialised in JAX and bridged with `from_jax`, inputs made with numpy and
served by a ListLoader as in tests/test_eval_parity.py. The JAX eval step
compiles once, module-scoped.

Tolerances: metrics, the missing codes and the report's format are exact;
batch losses 1e-5 relative; probabilities 1e-5 absolute; the statistics
1e-5; the sweep's reports line for line, every non-numeric line identical
and every number within 1e-4 (one unit in the 4th decimal, where the two
frameworks' f32 sums round to either side).
"""
import math
import os
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.data import missing as jmissing
from missm_tpu.data.tokenizer import HashTokenizer
from missm_tpu.eval import predictor as jpredictor
from missm_tpu.eval import sweep as jsweep
from missm_tpu import metrics as jmetrics
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.train.step import make_eval_step as jax_make_eval_step
from missm_tpu_torch import metrics as tmetrics
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.data import missing as tmissing
from missm_tpu_torch.eval import predictor as tpredictor
from missm_tpu_torch.eval import sweep as tsweep
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train.step import make_eval_step
from missm_tpu_torch.utils.prefetch import prefetch
from tests.synthetic import synthetic_image_loader

FUSION = dict(fusion_type="concat", modality_types=("language", "image"),
              output_dims=3, feature_dims=24, fusion_dim=8)
LOSS_RTOL = 1e-5
PROB_ATOL = 1e-5
STAT_ATOL = 1e-5
REPORT_ATOL = 1e-4


class ListLoader:
    """Slices arrays into (data, labels, missing) batches; the last one may
    be partial."""

    def __init__(self, data, labels, missing, batch_size):
        self.data = data
        self.labels = labels
        self.missing = missing
        self.batch_size = batch_size

    def __iter__(self):
        n = len(self.labels)
        for i in range(0, n, self.batch_size):
            sl = slice(i, min(i + self.batch_size, n))
            yield ({k: v[sl] for k, v in self.data.items()},
                   self.labels[sl], self.missing[sl])

    def __len__(self):
        return math.ceil(len(self.labels) / self.batch_size)


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    ids = np.ones((n, 16), np.int32)
    ids[:, 1:6] = rng.integers(2, 90, size=(n, 5))
    data = {"language": ids,
            "image": rng.standard_normal((n, 3, 32, 32)).astype(np.float32)}
    labels = rng.integers(0, 3, n).astype(np.int32)
    missing = rng.choice([0, 1, 4], n).astype(np.int32)
    return data, labels, missing


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, numpy JAX params, JAX eval step, port eval
    step); the concat head's statistics non-zero."""
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=JaxFusionConfig(**FUSION))
    tcfg = tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**FUSION))
    tree = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(9)
    tree["fusion"]["statistics"] = {
        m: rng.standard_normal(24).astype(np.float32) for m in FUSION[
            "modality_types"]}
    return (jcfg, tcfg, tree, jax_make_eval_step(jcfg),
            make_eval_step(tcfg, device="cpu"))


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# Metrics and the report format
# ---------------------------------------------------------------------------

def _metric_inputs(seed):
    """Labels over 4 classes with class 2 absent (seeds 0-2) or all present,
    probs rounded to one decimal so that scores tie."""
    rng = np.random.default_rng(seed)
    n = 40
    classes = [0, 1, 3] if seed < 3 else [0, 1, 2, 3]
    labels = rng.choice(classes, n)
    probs = rng.random((n, 4))
    probs = np.round(probs / probs.sum(1, keepdims=True), 1)
    preds = rng.integers(0, 4, n)
    return labels, preds, probs


@pytest.mark.parametrize("seed", range(6))
def test_metrics_equal_jax(seed):
    labels, preds, probs = _metric_inputs(seed)
    for name in ("accuracy", "macro_f1"):
        assert getattr(tmetrics, name)(labels, preds) == getattr(
            jmetrics, name)(labels, preds)
    np.testing.assert_equal(tmetrics.auc_ovo(labels, probs),
                            jmetrics.auc_ovo(labels, probs))
    np.testing.assert_equal(
        tmetrics.compute_metrics(labels, preds, probs, loss=0.25),
        jmetrics.compute_metrics(labels, preds, probs, loss=0.25))
    # the binary paths: two classes, and a single score column
    b = labels % 2
    np.testing.assert_equal(tmetrics.auc_ovo(b, probs[:, :2]),
                            jmetrics.auc_ovo(b, probs[:, :2]))
    np.testing.assert_equal(tmetrics.auc_ovo(b, probs[:, 1]),
                            jmetrics.auc_ovo(b, probs[:, 1]))


@pytest.mark.parametrize("metrics", [
    {"loss": 1.23456789, "accuracy": 0.5, "f1": 1 / 3, "auc": 0.99995},
    {"loss": 0.0, "accuracy": 1.0, "f1": 1.0, "auc": float("nan")},
    {"loss": 12.000049, "accuracy": 0.0, "f1": 0.0, "auc": 0.5}])
@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_format_report_block_is_byte_identical(ratio, metrics):
    got = tsweep.format_report_block(ratio, metrics)
    assert got.encode() == jsweep.format_report_block(ratio, metrics).encode()


# ---------------------------------------------------------------------------
# evaluate_loader, statistics_pass
# ---------------------------------------------------------------------------

def _assert_loader_outputs(got, want):
    (gl, glab, gpred, gprob), (wl, wlab, wpred, wprob) = got, want
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(glab, wlab)
    np.testing.assert_array_equal(gpred, wpred)
    np.testing.assert_allclose(gprob, wprob, rtol=0, atol=PROB_ATOL)


def test_evaluate_loader_partial_batch_matches_jax(model):
    """7 rows in batches of 3: the last batch padded to 3, its loss the
    1-row mean."""
    _, _, tree, jev, tev = model
    loader = ListLoader(*_arrays(7, 0), batch_size=3)
    got = tsweep.evaluate_loader(from_jax(tree, device="cpu"), tev, loader)
    want = jsweep.evaluate_loader(_jparams(tree), jev, loader)
    assert len(got[0]) == 3 and got[3].shape == (7, 3)
    _assert_loader_outputs(got, want)
    # the padded batch's loss is the unpadded one-row batch's
    d, lab, miss = list(loader)[-1]
    alone = tev(from_jax(tree, device="cpu"), d, lab, miss)
    assert got[0][-1] == pytest.approx(float(alone["loss"]), rel=1e-6)


@pytest.mark.parametrize("real", [5, 4])
def test_evaluate_loader_shard_real_count_matches_jax(model, real):
    """Rows past shard_real_count are out of the loss and the outputs; a
    batch of duplicates only (real = 4) is skipped."""
    _, _, tree, jev, tev = model

    class ShardLoader(ListLoader):
        shard_real_count = real

    loader = ShardLoader(*_arrays(6, 1), batch_size=4)
    got = tsweep.evaluate_loader(from_jax(tree, device="cpu"), tev, loader)
    want = jsweep.evaluate_loader(_jparams(tree), jev, loader)
    assert len(got[1]) == real and len(got[0]) == (2 if real == 5 else 1)
    _assert_loader_outputs(got, want)


def test_evaluate_loader_refuses_several_processes(model, tmp_path):
    """Across processes evaluate_loader gathers (the JAX package's
    multi-host branch, tests/test_three_process.py): 13 rows on 3 gloo
    ranks at 2 rows a rank-batch, each rank its BatchLoader-style shard
    (shards 1 and 2 end in wrap-around duplicates, and the last batch of
    both holds nothing real). Exactly the 13 rows come back, each once,
    as JAX's one-process evaluate_loader at the global batch of 6 gives
    them; the last batch's loss is the one real row's; and the concat_mean
    statistics are one process's."""
    from tests.torch_world import run_world

    _, tcfg, tree, jev, tev = model
    data, labels, missing = _arrays(13, 5)
    res = run_world(3, "tests.torch_parallel_cases:eval_case", tmp_path,
                    tree=tree, batch=(data, labels, missing),
                    towers=("image",), fusion=FUSION, batch_size=2)
    want = jsweep.evaluate_loader(_jparams(tree), jev,
                                  ListLoader(data, labels, missing, 6))
    # gathered rank by rank: batch k holds rank r's rows (2k + j) * 3 + r
    order = [(2 * k + j) * 3 + r for k in range(3) for r in range(3)
             for j in range(2) if (2 * k + j) * 3 + r < 13]
    assert sorted(order) == list(range(13))
    for r in res:
        losses, got_labels, preds, probs = (r["losses"], r["labels"],
                                            r["preds"], r["probs"])
        assert len(got_labels) == 13
        np.testing.assert_array_equal(got_labels, labels[order])
        np.testing.assert_array_equal(preds, np.asarray(want[2])[order])
        np.testing.assert_allclose(probs, np.asarray(want[3])[order],
                                   rtol=0, atol=PROB_ATOL)
        np.testing.assert_allclose(losses, want[0], rtol=LOSS_RTOL)
        # the last batch: the single real row (12)'s nll
        nll = -np.log(np.asarray(want[3])[12, labels[12]])
        assert losses[-1] == pytest.approx(nll, rel=LOSS_RTOL)
        one = tsweep.statistics_pass(from_jax(tree, device="cpu"), tcfg,
                                     ListLoader(data, labels, missing, 4),
                                     "mean", device="cpu")
        for m, v in one.items():
            np.testing.assert_allclose(r["stats"][m], v, rtol=0,
                                       atol=STAT_ATOL)


def test_evaluate_metrics_matches_jax(model):
    _, _, tree, jev, tev = model
    loader = ListLoader(*_arrays(9, 3), batch_size=4)
    got = tsweep.evaluate_metrics(from_jax(tree, device="cpu"), tev, loader)
    want = jsweep.evaluate_metrics(_jparams(tree), jev, loader)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k


@pytest.mark.parametrize("stat", ["mean", "median"])
def test_statistics_pass_matches_jax(model, stat):
    """11 train rows in batches of 4 (the last ragged); an even count in
    the median's second case (10 rows) takes the mean of the middle two."""
    jcfg, tcfg, tree, _, _ = model
    for n in (11, 10):
        loader = ListLoader(*_arrays(n, 6), batch_size=4)
        got = tsweep.statistics_pass(from_jax(tree, device="cpu"), tcfg,
                                     loader, stat, device="cpu")
        want = jsweep.statistics_pass(_jparams(tree), jcfg, loader, stat)
        for m in FUSION["modality_types"]:
            assert got[m].shape == (24,) and got[m].dtype == np.float32
            np.testing.assert_allclose(got[m], np.asarray(want[m]), rtol=0,
                                       atol=STAT_ATOL, err_msg=m)


# ---------------------------------------------------------------------------
# The missing sweep
# ---------------------------------------------------------------------------

NUMBER = re.compile(r"-?\d+\.\d+|nan")


def _sweep_loaders(n=11, batch=4):
    """{missing type: {ratio: loader}} with the codes of the ported
    simulate_missing_modality, and a train loader."""
    data, labels, _ = _arrays(n, 4)
    modal = ["language", "image", "mixed"]
    test = {mt: {r: ListLoader(data, labels, np.asarray(
        tmissing.simulate_missing_modality(n, mt, r, modal), np.int32), batch)
        for r in (0.1, 0.5, 0.9)} for mt in modal}
    train = ListLoader(*_arrays(10, 5), batch_size=batch)
    return test, train


@pytest.mark.parametrize("test_type,normalizer", [
    ("concat_median", "reference"), ("concat_mean", "batches")])
def test_run_missing_sweep_matches_jax(model, tmp_path, test_type,
                                       normalizer):
    jcfg, tcfg, tree, jev, tev = model
    test, train = _sweep_loaders()
    got = tsweep.run_missing_sweep(
        from_jax(tree, device="cpu"), tcfg, tev, test, str(tmp_path / "t"),
        "mvsa", test_type, train_loader=train, loss_normalizer=normalizer,
        verbose=False, device="cpu")
    want = jsweep.run_missing_sweep(
        _jparams(tree), jcfg, jev, test, str(tmp_path / "j"), "mvsa",
        test_type, train_loader=train, loss_normalizer=normalizer,
        verbose=False)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == [f"mvsa_{test_type}_{m}.txt" for m in
                                        ("image", "language", "mixed")]
    for name in os.listdir(tmp_path / "j"):
        g = (tmp_path / "t" / name).read_text().splitlines()
        w = (tmp_path / "j" / name).read_text().splitlines()
        assert len(g) == len(w) == 3 * 7
        for a, b in zip(g, w):
            assert NUMBER.sub("#", a) == NUMBER.sub("#", b)
            np.testing.assert_allclose(
                [float(x) for x in NUMBER.findall(a)],
                [float(x) for x in NUMBER.findall(b)], rtol=0,
                atol=REPORT_ATOL, err_msg=a)
    for mt in want:
        for r in want[mt]:
            for k in want[mt][r]:
                np.testing.assert_allclose(got[mt][r][k], want[mt][r][k],
                                           rtol=LOSS_RTOL, err_msg=k)


def test_run_missing_sweep_needs_a_train_loader_for_statistics(model,
                                                               tmp_path):
    _, tcfg, tree, _, tev = model
    with pytest.raises(ValueError, match="train_loader"):
        tsweep.run_missing_sweep(from_jax(tree, device="cpu"), tcfg, tev, {},
                                 str(tmp_path), "mvsa", "concat_mean",
                                 device="cpu")


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

def test_predict_arrays_partial_batch_matches_jax(model):
    jcfg, tcfg, tree, _, _ = model
    data, _, missing = _arrays(5, 7)
    got = tpredictor.Predictor(from_jax(tree, device="cpu"), tcfg,
                               batch_size=8, device="cpu").predict_arrays(
                                   data, missing)
    want = jpredictor.Predictor(_jparams(tree), jcfg, batch_size=8) \
        .predict_arrays(data, missing)
    assert got[0].shape == (5,) and got[1].shape == (5, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(got[1].sum(1), 1.0, atol=1e-6)


def test_predict_raw_samples_matches_jax(model):
    """Injected tokenizer and media loader, chunks of 4 over 10 samples."""
    jcfg, tcfg, tree, _, _ = model
    kw = dict(batch_size=4, tokenizer=HashTokenizer(99, 16),
              media_loaders={"image": synthetic_image_loader()})
    samples = [{"language": f"text {i}", "image": f"/fake/{i}.jpg"}
               for i in range(10)]
    got = tpredictor.Predictor(from_jax(tree, device="cpu"), tcfg,
                               device="cpu", **kw).predict(samples)
    want = jpredictor.Predictor(_jparams(tree), jcfg, **kw).predict(samples)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=PROB_ATOL)


def test_predictor_moves_params_once_and_refuses_what_it_cannot_take(
        model, tmp_path):
    """Also the from_checkpoint round trip (missm_tpu/eval/predictor.py:46):
    a Predictor restored from a port checkpoint predicts what one built
    from the same params does, exactly."""
    from missm_tpu_torch.train.checkpoint import save_checkpoint

    _, tcfg, tree, _, _ = model
    params = from_jax(tree, device="cpu")
    p = tpredictor.Predictor(params, tcfg, batch_size=2, device="cpu")
    assert p.params["fusion"]["proj"]["image"]["w"].device.type == "cpu"
    data, _, _ = _arrays(5, 0)
    with pytest.raises(ValueError, match="compiled batch_size"):
        p.predict_arrays(data)
    path = str(tmp_path / "final")
    save_checkpoint(path, {"params": params}, metadata={"best_epoch": 0})
    q = tpredictor.Predictor.from_checkpoint(path, tcfg, batch_size=8,
                                             device="cpu")
    ref = tpredictor.Predictor(params, tcfg, batch_size=8, device="cpu")
    for a, b in zip(q.predict_arrays(data), ref.predict_arrays(data)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Missing codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("missing_type", ["language", "image", "mixed"])
@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.9])
def test_simulate_missing_modality_equals_jax(missing_type, ratio):
    modal = ["language", "image", "mixed"]
    for n, seed in ((101, 2025), (37, 7)):
        assert tmissing.simulate_missing_modality(
            n, missing_type, ratio, modal, seed) == \
            jmissing.simulate_missing_modality(n, missing_type, ratio, modal,
                                               seed)


def test_generate_missing_index_equals_jax_and_round_trips(tmp_path):
    sizes = {"train": 30, "valid": 7, "test": 11}
    mods = ("language", "video", "audio")
    got = tmissing.generate_missing_index(sizes, mods)
    assert got == jmissing.generate_missing_index(sizes, mods)
    assert tmissing.MISSING_RATIOS == jmissing.MISSING_RATIOS
    path = str(tmp_path / "missing_index.pkl")
    tmissing.save_missing_index(path, got)
    assert tmissing.load_missing_index(path) == got
    assert jmissing.load_missing_index(path) == got


# ---------------------------------------------------------------------------
# Prefetcher (as tests/test_prefetch.py)
# ---------------------------------------------------------------------------

def _workers():
    return [t for t in threading.enumerate() if t.name == "missm-prefetch"]


def _wait_no_workers(timeout=10.0):
    deadline = time.time() + timeout
    while _workers() and time.time() < deadline:
        time.sleep(0.02)
    return _workers()


def test_prefetch_normal_exhaustion():
    assert list(prefetch(iter(range(7)), depth=2)) == list(range(7))
    assert _wait_no_workers() == []


def test_prefetch_error_propagates():
    def gen():
        yield 1
        raise ValueError("boom")

    it = iter(prefetch(gen(), depth=2))
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)
    assert _wait_no_workers() == []


def test_prefetch_abandon_releases_nested_workers():
    """Closing the outer generator after 2 items of a nested prefetcher over
    an infinite source joins both workers, with bounded readahead."""
    produced = []

    def infinite():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = iter(prefetch(prefetch(infinite(), depth=2), depth=2,
                       transfer=lambda x: x * 10))
    assert next(it) == 0
    assert next(it) == 10
    assert len(_workers()) == 2
    it.close()  # what a for-loop break does in CPython
    assert _wait_no_workers() == []
    assert len(produced) <= 10


def test_prefetch_transfer_applies_in_worker():
    seen = set()

    def mark(x):
        seen.add(threading.current_thread().name)
        return x + 1

    assert list(prefetch(iter(range(3)), transfer=mark)) == [1, 2, 3]
    assert seen == {"missm-prefetch"}
    assert _wait_no_workers() == []
