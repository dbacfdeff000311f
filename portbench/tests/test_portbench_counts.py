"""The yardstick's FLOP and byte counts against the arithmetic written out
here, independently, for both configurations."""
import pytest

from conftest import load
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
    assert flops.forward_flop(cfg) == sum(p[0] for p in parts)
    assert flops.train_flop(cfg) == sum(p[1] for p in parts)


def test_flagship_forward_is_the_known_175_gflop():
    cfg = load("configs", "lb-image-text")
    assert flops.forward_flop(cfg) == pytest.approx(175.4e9, rel=1e-3)


def test_attention_calls():
    cfg = load("configs", "lb-video-audio-text")
    calls = flops.attention_calls(cfg, 16, train=True)
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
    text = flops.attention_calls(cfg, 64, train=False)[-1]
    assert text.kbias
    assert text.bytes == 4 * 64 * 77 * 768 * 2 + 64 * 77 * 4
