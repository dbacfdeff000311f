"""The port's attention (kernels/attention.py, ops/attention.py) against the
JAX package.

On the CPU the port's kernel wrappers compute their plain versions; these
are held against the Pallas kernels they replace, run in interpret mode
(missm_tpu.kernels.flash_attention.fused_attention_cls for K1,
fused_attention(causal=True, kbias=...) for K2), and the port's
multi_head_attention against the JAX one (einsum branch on the CPU). All in
f32 with the tolerances of tests/test_flash_attention.py. The kernels
themselves are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.kernels.flash_attention import (fused_attention,
                                               fused_attention_cls)
from missm_tpu.ops import attention as jattn
from missm_tpu_torch.kernels import attention as kernels
from missm_tpu_torch.ops import attention as tattn

ATOL, RTOL = 2e-5, 1e-4
NEG = np.finfo(np.float32).min


def _qkv(rng, b, n, d):
    return [rng.standard_normal((b, n, d)).astype(np.float32)
            for _ in range(3)]


def _padding_bias(rng, b, n):
    kb = np.zeros((b, 1, n), np.float32)
    for i, length in enumerate(rng.integers(4, n, size=b)):
        kb[i, 0, length:] = NEG
    return kb


@pytest.mark.parametrize("n,heads", [(129, 2), (257, 4)])
def test_attention_plain_matches_cls_split_kernel(rng, n, heads):
    """K1: the TPU kernel takes K/V split into a CLS row and the rest; the
    port takes them whole."""
    q, k, v = _qkv(rng, 2, n, heads * 64)
    ref = fused_attention_cls(jnp.asarray(q), jnp.asarray(k[:, :1]),
                              jnp.asarray(k[:, 1:]), jnp.asarray(v[:, :1]),
                              jnp.asarray(v[:, 1:]), heads, interpret=True)
    kt = torch.cat([torch.from_numpy(k[:, :1]), torch.from_numpy(k[:, 1:])], 1)
    vt = torch.cat([torch.from_numpy(v[:, :1]), torch.from_numpy(v[:, 1:])], 1)
    got = kernels.attention(torch.from_numpy(q), kt, vt, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("n", [16, 77])
@pytest.mark.parametrize("with_pad", [False, True])
def test_causal_attention_plain_matches_causal_kernel(rng, n, with_pad):
    """K2 mode a. Without padding the JAX text path hands the kernel an
    all-zero key bias; the port passes none."""
    heads = 2
    q, k, v = _qkv(rng, 3, n, heads * 64)
    kb = _padding_bias(rng, 3, n) if with_pad else np.zeros((3, 1, n),
                                                            np.float32)
    ref = fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          heads, causal=True, kbias=jnp.asarray(kb),
                          interpret=True)
    got = kernels.causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kb) if with_pad else None, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _attn_params(rng, d, lora_r):
    p = {}
    for name in ("q", "k", "v", "out"):
        p[name] = {"w": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
                   "b": rng.standard_normal(d).astype(np.float32) * 0.1}
        if lora_r:
            p[name]["lora_a"] = rng.standard_normal((d, lora_r)).astype(
                np.float32) * 0.1
            p[name]["lora_b"] = rng.standard_normal((lora_r, d)).astype(
                np.float32) * 0.1
    return p


@pytest.mark.parametrize("case", ["bias_free", "causal_key_bias",
                                  "dense_bias"])
def test_multi_head_attention_matches_jax(rng, case):
    b, n, heads, hd = 2, 17, 2, 16
    d = heads * hd
    params = _attn_params(rng, d, lora_r=2 if case == "bias_free" else 0)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    kw = {}
    if case == "bias_free":
        kw = dict(lora_scaling=8.0)
    elif case == "causal_key_bias":
        kw = dict(causal=True, key_bias=_padding_bias(rng, b, n))
    else:
        kw = dict(bias=rng.standard_normal((b, 1, n, n)).astype(np.float32))

    def tree(conv):
        return {m: {k: conv(a) for k, a in p.items()}
                for m, p in params.items()}

    jkw = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()}
    tkw = {k: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()}
    ref = jattn.multi_head_attention(tree(jnp.asarray), jnp.asarray(x),
                                     num_heads=heads, **jkw)
    got = tattn.multi_head_attention(tree(torch.from_numpy),
                                     torch.from_numpy(x), num_heads=heads,
                                     **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_mask_helpers_match_jax(rng):
    np.testing.assert_array_equal(tattn.causal_bias(9).numpy(),
                                  np.asarray(jattn.causal_bias(9)))
    pad = rng.random((3, 9)) < 0.3
    np.testing.assert_array_equal(
        tattn.key_padding_bias(torch.from_numpy(pad)).numpy(),
        np.asarray(jattn.key_padding_bias(jnp.asarray(pad))))


def test_wrappers_on_cpu_use_the_plain_version_and_count_nothing(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 8, 32))
    kernels.reset_launches()
    kernels.attention(q, k, v, 2)
    kernels.causal_attention(q, k, v, None, 2)
    assert kernels.LAUNCHES == {"attention": 0, "causal_attention": 0}
