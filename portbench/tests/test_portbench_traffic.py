"""The traffic generators: the same seed gives the same rows and codes,
different seeds different ones; the missing codes follow the reference's
rule; the harness's metrics equal the port's."""
import numpy as np
import pytest
import torch

from conftest import tiny_config
from portbench import harness, inputs
from portbench.checks import metrics

BIG = 2 ** 31 + 12345


def _draw(seed, name="lb-image-text"):
    cfg = tiny_config(name)
    model = harness.family(cfg, "port")
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    text = model.text(cfg, 9, rng, (3, 12))
    return (text, model.media(cfg, 9, gen, block=4),
            inputs.labels(9, 3, rng), inputs.train_codes(9, [0, 1, 4], rng),
            inputs.missing_codes(9, "mixed", 0.5, ["language", "image"], seed))


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_same_seed_same_rows(seed):
    assert all(_same(x, y) for x, y in zip(_draw(seed), _draw(seed)))


def test_different_seeds_differ():
    a, b = _draw(BIG), _draw(BIG + 1)
    for x, y in zip(a, b):
        assert not _same(x, y)


def test_every_seed_the_same_sizes():
    for seed in (1, 2, BIG):
        text, media, labels, codes, missing = _draw(seed)
        assert text["input_ids"].shape == (9, 16)
        assert media["image"].shape == (9, 3, 32, 32)
        assert (missing != 0).sum() == 4          # int(9 * 0.5)


def test_token_layout():
    text = _draw(3)[0]
    ids, mask = text["input_ids"], text["attention_mask"]
    assert (ids[:, 0] == 97).all()                # SOT = vocab - 2
    for row, m in zip(ids, mask):
        n = int(m.sum())
        assert row[n - 1] == 98 and (row[n:] == 98).all()
        assert (row[1:n - 1] < 97).all()
        assert np.argmax(row) == n - 1            # EOT pooling's position


@pytest.mark.parametrize("mtype", ["language", "video", "mixed"])
@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_missing_codes_follow_the_reference_rule(mtype, ratio):
    from missm_tpu_torch.data.missing import simulate_missing_modality
    modal = ["language", "video", "audio", "mixed"]
    ours = inputs.missing_codes(457, mtype, ratio, modal[:-1], 2025)
    theirs = simulate_missing_modality(457, mtype, ratio, modal, 2025)
    assert ours.tolist() == theirs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_ports(seed):
    from missm_tpu_torch.metrics import compute_metrics
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, 200)
    probs = rng.dirichlet(np.ones(3), 200).astype(np.float32)
    probs[:20] = probs[20:40]                     # ties across classes' rows
    preds = probs.argmax(1)
    ours, theirs = metrics(labels, preds, probs), compute_metrics(
        labels, preds, probs)
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], abs=1e-12)
