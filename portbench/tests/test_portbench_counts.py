"""The yardstick's FLOP and byte counts against the arithmetic written out
here, independently, for both configurations."""
from collections import Counter

import pytest

from conftest import load
from portbench import harness
from portbench.counts import flops


def _vision(d, f, L, n, patch_in, T=1, temporal=False, r=2, proj=768):
    """(forward, training) FLOP of one sample of a LoRA'd vision tower."""
    tok = T * n
    dense = 8 * tok * d * d * L + 4 * tok * d * f * L     # qkvo, MLP
    attn = 4 * T * n * n * d * L
    patch = 2 * T * (n - 1) * patch_in * d
    lora = 4 * L * (2 * tok * d * r + 2 * tok * r * d)
    head = 2 * d * proj
    fwd = dense + attn + patch + lora + head
    if temporal:
        fwd += 8 * tok * d * d * L + 4 * n * T * T * d * L
    # backward: frozen products their input gradient only, attention both
    # inputs, the patch its weight only, LoRA and the projection both
    bwd = dense + 2 * attn + patch + 2 * lora + 2 * head
    if temporal:
        bwd += 8 * tok * d * d * L + 2 * 4 * n * T * T * d * L
    return fwd, fwd + bwd


def _text(d=768, f=3072, L=12, n=77, proj=768):
    fwd = (8 * n * d * d + 4 * n * d * f) * L + 4 * (n * (n + 1) // 2) * d * L \
        + 2 * d * proj
    return fwd, 3 * fwd            # every product trains and passes gradient


def _head(mods, feat=768, fd=256, classes=3):
    fwd = 2 * feat * fd * mods + 2 * fd * fd + 2 * fd * classes
    return fwd, 3 * fwd


@pytest.mark.parametrize("name", ["lb-image-text", "lb-video-audio-text"])
def test_model_flop(name):
    cfg = load("configs", name)
    parts = [_text(), _head(len(cfg["modality_types"]))]
    if name == "lb-image-text":
        parts.append(_vision(1024, 4096, 24, 257, 588))
    else:
        parts.append(_vision(1024, 4096, 24, 257, 588, T=8, temporal=True))
        parts.append(_vision(1024, 4096, 24, 8 * 74 + 1, 588))
    products = _products(cfg)
    assert flops.forward_flop(products) == sum(p[0] for p in parts)
    assert flops.train_flop(products) == sum(p[1] for p in parts)


def test_flagship_forward_is_the_known_175_gflop():
    cfg = load("configs", "lb-image-text")
    assert flops.forward_flop(_products(cfg)) == pytest.approx(175.4e9,
                                                               rel=1e-3)


def _products(cfg):
    return harness.family(cfg, "counts").products(cfg)


def _attention_calls(cfg, batch, train):
    return harness.family(cfg, "counts").attention_calls(cfg, batch, train)


def test_attention_calls():
    cfg = load("configs", "lb-video-audio-text")
    calls = _attention_calls(cfg, 16, train=True)
    kinds = [c.kind for c in calls]
    assert kinds.count("forward") == 24 + 24 + 12
    assert kinds.count("backward") == 48
    assert kinds.count("short") == kinds.count("short_backward") == 24
    video = calls[0]
    assert (video.batch, video.n, video.heads, video.head_dim) == (128, 257, 16, 64)
    assert video.flop == 4 * 128 * 16 * 257 * 257 * 64
    t = 128 * 257 * 1024 * 2
    assert video.bytes == 4 * t + 128 * 16 * 257 * 4
    short = next(c for c in calls if c.kind == "short")
    assert (short.batch, short.n) == (16 * 257, 8)
    assert short.bytes == 4 * 16 * 257 * 8 * 1024 * 2
    text = calls[-1]
    assert text.causal and not text.kbias and text.pairs == 77 * 78 // 2
    back = next(c for c in calls if c.kind == "backward")
    assert back.flop == 2 * 4 * back.batch * 16 * back.n ** 2 * 64
    assert back.bound_s == max(back.bytes / 3.35e12, back.flop / 989e12)


def test_flagship_text_attention_reads_its_key_bias():
    cfg = load("configs", "lb-image-text")
    text = _attention_calls(cfg, 64, train=False)[-1]
    assert text.kbias
    assert text.bytes == 4 * 64 * 77 * 768 * 2 + 64 * 77 * 4


# Read off the counts before they moved into the model family's file
# (counts/languagebind.py): each configuration's model FLOP, and for each
# (batch, train) of its cells its attention calls' least times, as
# [(kind, bound_s, calls)].
BEFORE = {
    "lb-image-text": (175420388864, 370730082816, {
        (64, False): [("forward", 9.04398328358209e-06, 12),
                      ("forward", 4.022149731343284e-05, 24)],
        (64, True): [("backward", 8.075722507462686e-05, 24),
                     ("forward", 9.04398328358209e-06, 12),
                     ("forward", 4.053572776119403e-05, 24)]}),
    "lb-video-audio-text": (2120457041408, 4344322073088, {
        (64, False): [("forward", 9.038099104477612e-06, 12),
                      ("forward", 9.3207963049545e-05, 24),
                      ("forward", 0.0003217719785074627, 24),
                      ("short", 0.0003217719785074627, 24)],
        (16, True): [("backward", 4.66039815247725e-05, 24),
                     ("backward", 0.00016151445014925373, 24),
                     ("forward", 2.259524776119403e-06, 12),
                     ("forward", 2.338296358208955e-05, 24),
                     ("forward", 8.107145552238806e-05, 24),
                     ("short", 8.044299462686568e-05, 24),
                     ("short_backward", 0.00014077524059701493, 24)]}),
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_counts_are_what_they_were(name):
    """The family's counts give exactly the numbers the harness read
    before a configuration named its family."""
    cfg = load("configs", name)
    fwd, train, bounds = BEFORE[name]
    products = _products(cfg)
    assert (flops.forward_flop(products),
            flops.train_flop(products)) == (fwd, train)
    for (batch, is_train), want in bounds.items():
        got = Counter((c.kind, c.bound_s)
                      for c in _attention_calls(cfg, batch, is_train))
        assert sorted((k, b, n) for (k, b), n in got.items()) == want
