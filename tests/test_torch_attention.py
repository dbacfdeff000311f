"""The port's attention (kernels/attention.py, ops/attention.py) against the
JAX package.

On the CPU the port's kernel wrappers compute their plain versions; these
are held against the Pallas kernels they replace, run in interpret mode
(missm_tpu.kernels.flash_attention.fused_attention_cls for K1,
fused_attention(causal=True, kbias=...) for K2 mode a, fused_attention
unmasked for K2 mode b, fused_attention(block_diag=T) on packed rows for K2
mode c, fused_attention_cls_bwd for K3, fused_attention_bwd unmasked and in
block-diagonal mode on packed rows for K4), the causal backward against the
JAX package's einsum gradient, and the port's multi_head_attention and
short_attention, forward and gradients, against the JAX ones (einsum
branches on the CPU). All in f32 with the tolerances of
tests/test_flash_attention.py. The kernels themselves are held against the
plain versions on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.kernels import flash_attention as jfa
from missm_tpu.kernels.flash_attention import (_einsum_bwd, _einsum_reference,
                                               fused_attention,
                                               fused_attention_bwd,
                                               fused_attention_cls,
                                               fused_attention_cls_bwd)
from missm_tpu.ops import attention as jattn
from missm_tpu_torch.kernels import attention as kernels
from missm_tpu_torch.ops import attention as tattn

ATOL, RTOL = 2e-5, 1e-4
BWD_ATOL, BWD_RTOL = 2e-4, 1e-3  # tests/test_flash_attention.py's backward
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


@pytest.mark.parametrize("n", [97, 593])
def test_unsplit_attention_plain_matches_unmasked_kernel(rng, n):
    """K2 mode b: where the CLS split does not apply (N - 1 not a multiple
    of 128: the audio tower's N = 593), the JAX package takes the unmasked
    fused kernel, and the port's `attention` wrapper the same forward as
    K1, counted under its own name."""
    heads = 2
    q, k, v = _qkv(rng, 1, n, heads * 64)
    assert kernels.attention_route(n, heads, 64) == "attention_unsplit"
    ref = fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          heads, interpret=True)
    got = kernels.attention(*(torch.from_numpy(a) for a in (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("n,heads,hd,route", [
    (257, 16, 64, "attention"), (129, 2, 64, "attention"),
    (593, 16, 64, "attention_unsplit"), (257, 16, 32, "attention_unsplit"),
    (257, 3, 64, "attention_unsplit"), (77, 12, 64, "attention_unsplit"),
    (5, 2, 16, "attention_unsplit")])
def test_attention_route_follows_the_cls_split(n, heads, hd, route):
    """The launch count a bias-free call goes to is the TPU kernel the JAX
    package would run: K1 where it takes the CLS split."""
    assert kernels.attention_route(n, heads, hd) == route
    assert jfa.cls_split_available(heads, hd, n) == (route == "attention")


def _packed(x, t):
    """[M, T, D] -> the TPU's packed rows [M*T/128, 128, D]."""
    m, _, d = x.shape
    return jnp.asarray(x.reshape(m * t // 128, 128, d))


@pytest.mark.parametrize("m", [16, 48])
def test_short_attention_plain_matches_block_diag_kernel(rng, m):
    """K2 mode c: per-instance attention over [M, T, D] against the TPU
    kernel's block-diagonal mode on the packed rows (16 instances of T=8
    per 128-token row, tests/test_packed_attention.py) and against
    _einsum_reference on the same rows."""
    heads, hd, t = 2, 64, 8
    q, k, v = _qkv(rng, m, t, heads * hd)
    packed = [_packed(a, t) for a in (q, k, v)]
    got = kernels.short_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  heads).numpy()
    for ref in (fused_attention(*packed, heads, block_diag=t, interpret=True),
                _einsum_reference(*packed, heads, block_diag=t)):
        np.testing.assert_allclose(got, np.asarray(ref).reshape(m, t, -1),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("m", [16, 37])
def test_short_attention_matches_jax(rng, m):
    """ops.attention.short_attention, LoRA non-zero, forward and gradients
    against the JAX one (its einsum fallback on the CPU). M = 37 leaves a
    remainder that the TPU's packing would run apart; the port has none."""
    heads, hd, t = 2, 16, 4
    d = heads * hd
    params = _attn_params(rng, d, lora_r=2)
    x = rng.standard_normal((m, t, d)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out = jattn.short_attention(p, x, num_heads=heads, lora_scaling=8.0)
        return (out * cot).sum(), out

    (_, ref), (jp, jx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        _tree(params, jnp.asarray), jnp.asarray(x))
    tp = _tree(params, lambda a: torch.from_numpy(a).requires_grad_())
    tx = torch.from_numpy(x).requires_grad_()
    out = tattn.short_attention(tp, tx, num_heads=heads, lora_scaling=8.0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx),
                               atol=BWD_ATOL, rtol=BWD_RTOL)
    for name, p in tp.items():
        for key, t_ in p.items():
            np.testing.assert_allclose(t_.grad.numpy(),
                                       np.asarray(jp[name][key]),
                                       atol=BWD_ATOL, rtol=BWD_RTOL,
                                       err_msg=f"{name}/{key}")


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


@pytest.mark.parametrize("n,heads", [(129, 2), (257, 4)])
def test_attention_bwd_plain_matches_cls_split_bwd_kernel(rng, n, heads):
    """K3: the TPU backward returns the K/V gradients split into the CLS row
    and the rest; the port's come whole."""
    q, k, v, g = _qkv(rng, 2, n, heads * 64) + [
        rng.standard_normal((2, n, heads * 64)).astype(np.float32)]
    dq, dkc, dkm, dvc, dvm = fused_attention_cls_bwd(
        *(jnp.asarray(a) for a in (q, k[:, :1], k[:, 1:], v[:, :1], v[:, 1:],
                                   g)), heads, interpret=True)
    want = (dq, np.concatenate([dkc, dkm], 1), np.concatenate([dvc, dvm], 1))
    got = kernels.attention_bwd_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v, g)), heads)
    for name, x, w in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("n", [97, 593])
def test_unsplit_attention_bwd_plain_matches_unmasked_bwd_kernel(rng, n):
    """K4 unmasked: where the CLS split does not apply (the audio tower's
    N = 593), the JAX package's gradient is fused_attention_bwd without a
    mask; the port's is the K3 kernel's, whose plain version this is."""
    heads = 2
    q, k, v, g = _qkv(rng, 1, n, heads * 64) + [
        rng.standard_normal((1, n, heads * 64)).astype(np.float32)]
    want = fused_attention_bwd(*(jnp.asarray(a) for a in (q, k, v, g)), heads,
                               interpret=True)
    got = kernels.attention_bwd_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v, g)), heads)
    for name, x, w in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("m", [16, 48])
def test_short_attention_bwd_plain_matches_block_diag_bwd_kernel(rng, m):
    """K4 block-diagonal: the per-instance gradient of [M, T, D] against the
    TPU kernel's block-diagonal mode on the packed rows (16 instances of
    T=8 per 128-token row) and against _einsum_bwd, the JAX package's
    gradient off the TPU, on the same rows."""
    heads, hd, t = 2, 64, 8
    q, k, v, g = _qkv(rng, m, t, heads * hd) + [
        rng.standard_normal((m, t, heads * hd)).astype(np.float32)]
    packed = [_packed(a, t) for a in (q, k, v, g)]
    got = kernels.short_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, g)), heads)
    for ref in (fused_attention_bwd(*packed, heads, block_diag=t,
                                    interpret=True),
                _einsum_bwd(heads, t, tuple(packed[:3]), packed[3])):
        for name, x, w in zip("qkv", got, ref):
            np.testing.assert_allclose(
                x.numpy(), np.asarray(w).reshape(m, t, -1), atol=BWD_ATOL,
                rtol=BWD_RTOL, err_msg=f"d{name}")


def _jax_causal_attention(q, k, v, kbias, heads):
    """The JAX package's einsum path (ops/attention.py:107-126) for causal
    attention with the key bias."""
    B, N, D = q.shape
    hd = D // heads
    bias = jattn.causal_bias(N) + kbias[:, :, None, :]
    s = jnp.einsum("bqhd,bkhd->bhqk", (q * hd ** -0.5).reshape(B, N, heads, hd),
                   k.reshape(B, N, heads, hd)) + bias
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p,
                      v.reshape(B, N, heads, hd)).reshape(B, N, D)


@pytest.mark.parametrize("with_pad", [False, True])
def test_causal_bwd_plain_matches_jax(rng, with_pad):
    """K2(a)'s plain backward, key-bias gradient included, against jax.vjp
    of the einsum path and the JAX package's own VJP of the causal kernel
    (flash_attention._fca_bwd)."""
    heads, n = 2, 77
    q, k, v = _qkv(rng, 3, n, heads * 64)
    g = rng.standard_normal(q.shape).astype(np.float32)
    kb = _padding_bias(rng, 3, n) if with_pad else np.zeros((3, 1, n),
                                                            np.float32)
    _, vjp = jax.vjp(lambda *a: _jax_causal_attention(*a, heads),
                     *(jnp.asarray(a) for a in (q, k, v, kb)))
    want = vjp(jnp.asarray(g))
    own = jfa._fca_bwd(heads, tuple(jnp.asarray(a) for a in (q, k, v, kb)),
                       jnp.asarray(g))
    got = kernels.causal_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, kb, g)), heads)
    for name, x, w, o in zip(("dq", "dk", "dv", "dkbias"), got, want, own):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=name)
        np.testing.assert_allclose(x.numpy(), np.asarray(o), atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_wrappers_differentiate_as_the_plain_versions(rng, causal):
    """On CPU tensors the wrappers' ops compute the plain versions, their
    gradients are the plain backwards exactly, and the plain backwards equal
    autograd of the plain forward."""
    heads = 2
    arrays = _qkv(rng, 2, 33, heads * 16) + [_padding_bias(rng, 2, 33)]
    g = torch.from_numpy(rng.standard_normal((2, 33, 32)).astype(np.float32))

    def grads(fn):
        t = [torch.from_numpy(a).requires_grad_() for a in arrays]
        if causal:
            out = fn(*t, causal=True)
            return torch.autograd.grad(out, t, g)
        return torch.autograd.grad(fn(*t[:3]), t[:3], g)

    def wrapper(q, k, v, kb=None, causal=False):
        if causal:
            return kernels.causal_attention(q, k, v, kb, heads)
        return kernels.attention(q, k, v, heads)

    def plain(q, k, v, kb=None, causal=False):
        return kernels.attention_plain(q, k, v, heads, causal=causal,
                                       kbias=kb)

    kernels.reset_launches()
    got, want = grads(wrapper), grads(plain)
    assert sum(kernels.LAUNCHES.values()) == 0
    t = [torch.from_numpy(a) for a in arrays]
    if causal:
        bwd = kernels.causal_attention_bwd_plain(*t, g, heads)
    else:
        bwd = kernels.attention_bwd_plain(*t[:3], g, heads)
    for x, w, b in zip(got, want, bwd):
        torch.testing.assert_close(x, b, atol=0, rtol=0)
        torch.testing.assert_close(b, w, atol=ATOL, rtol=RTOL)


def test_cpu_short_wrapper_differentiates_as_its_plain_backward(rng):
    """On CPU tensors short_attention is the plain version under autograd,
    whose gradient is short_attention_bwd_plain (the kernel's plain
    version on the card)."""
    heads = 2
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(rng, 11, 8, heads * 16)
                  + [rng.standard_normal((11, 8, 32)).astype(np.float32)])
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    kernels.reset_launches()
    got = torch.autograd.grad(kernels.short_attention(*t, heads), t, g)
    assert sum(kernels.LAUNCHES.values()) == 0
    for x, w in zip(got, kernels.short_attention_bwd_plain(q, k, v, g, heads)):
        torch.testing.assert_close(x, w, atol=ATOL, rtol=RTOL)


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


def _mha_case(rng, case):
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
    jkw = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()}
    tkw = {k: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()}
    return params, x, heads, jkw, tkw


def _tree(params, conv):
    return {m: {k: conv(a) for k, a in p.items()} for m, p in params.items()}


@pytest.mark.parametrize("case", ["bias_free", "causal_key_bias",
                                  "dense_bias"])
def test_multi_head_attention_matches_jax(rng, case):
    params, x, heads, jkw, tkw = _mha_case(rng, case)
    ref = jattn.multi_head_attention(_tree(params, jnp.asarray),
                                     jnp.asarray(x), num_heads=heads, **jkw)
    got = tattn.multi_head_attention(_tree(params, torch.from_numpy),
                                     torch.from_numpy(x), num_heads=heads,
                                     **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("case", ["bias_free", "causal_key_bias",
                                  "dense_bias"])
def test_multi_head_attention_grads_match_jax(rng, case):
    """Gradients of x and of every projection param (LoRA factors
    included) against jax.grad of the JAX einsum path: each branch of the
    port's routing differentiates."""
    params, x, heads, jkw, tkw = _mha_case(rng, case)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        return (jattn.multi_head_attention(p, x, num_heads=heads, **jkw)
                * cot).sum()

    jp, jx = jax.grad(jloss, argnums=(0, 1))(_tree(params, jnp.asarray),
                                             jnp.asarray(x))
    tp = _tree(params, lambda a: torch.from_numpy(a).requires_grad_())
    tx = torch.from_numpy(x).requires_grad_()
    out = tattn.multi_head_attention(tp, tx, num_heads=heads, **tkw)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx),
                               atol=BWD_ATOL, rtol=BWD_RTOL)
    for m, p in tp.items():
        for k, t in p.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jp[m][k]),
                                       atol=BWD_ATOL, rtol=BWD_RTOL,
                                       err_msg=f"{m}/{k}")


def test_mask_helpers_match_jax(rng):
    np.testing.assert_array_equal(tattn.causal_bias(9).numpy(),
                                  np.asarray(jattn.causal_bias(9)))
    pad = rng.random((3, 9)) < 0.3
    np.testing.assert_array_equal(
        tattn.key_padding_bias(torch.from_numpy(pad)).numpy(),
        np.asarray(jattn.key_padding_bias(jnp.asarray(pad))))


def test_wrappers_on_cpu_use_the_plain_version_and_count_nothing(rng):
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(rng, 1, 8, 32))
    kernels.reset_launches()
    out = (kernels.attention(q, k, v, 2)
           + kernels.causal_attention(q, k, v, None, 2)
           + kernels.short_attention(q, k, v, 2))
    out.sum().backward()
    assert kernels.LAUNCHES == {"attention": 0, "attention_unsplit": 0,
                                "attention_bwd": 0, "attention_unsplit_bwd": 0,
                                "causal_attention": 0, "short_attention": 0,
                                "short_attention_bwd": 0, "ln_linear": 0,
                                "mlp_bwd_dx": 0, "attn_probe_fused": 0,
                                "tower_bhne": 0, "tower_scratch": 0,
                                "tower_packed_debug": 0}


# ---------------------------------------------------------------------------
# The bf16 kernels' plans (kernels/attention.py::plan, mirrored by the C
# launchers of csrc/attention.cu and csrc/attention_bwd.cu)
# ---------------------------------------------------------------------------

EDGE_N = (1, 8, 15, 16, 17, 63, 64, 65, 77, 127, 128, 129, 257, 593)
PLANS = [("forward", False), ("forward", True), ("dq", False),
         ("dkdv", False)]


@pytest.mark.parametrize("kernel", ["forward", "dq", "dkdv"])
@pytest.mark.parametrize("head_dim", kernels._HEAD_DIMS)
def test_every_plan_fits_the_shared_memory(head_dim, kernel):
    p = kernels.plan(593, head_dim, kernel)
    assert 0 < p.smem_bytes <= kernels.SMEM_LIMIT == 232_448


@pytest.mark.parametrize("kernel,causal", PLANS)
@pytest.mark.parametrize("n", EDGE_N)
def test_plan_tiles_cover_n_once(n, kernel, causal):
    """Every row of the (batch, head) is in one block's tile, and every key
    (query, for dkdv) a row tile sees (causal: up to its last row) is in
    one of its column tiles, which are as wide as their live columns
    rounded up to 8 and no wider than a full tile."""
    p = kernels.plan(n, 64, kernel, causal=causal)
    width = kernels.dkdv_rows(64) if kernel == "dkdv" else kernels.ROWS
    rows = [r for first, live in p.rows for r in range(first, first + live)]
    assert rows == list(range(n))
    assert all(first % kernels.ROWS == 0 and 0 < live <= kernels.ROWS
               for first, live in p.rows)
    assert [live for _, live in p.rows][:-1] == [kernels.ROWS] * (p.blocks - 1)
    for (first, _), cols in zip(p.rows, p.cols):
        end = min(n, first + kernels.ROWS) if causal else n
        seen = []
        for c0, w in cols:
            live = min(width, end - c0)
            assert c0 % width == 0 and w % 8 == 0 and live <= w < live + 8
            seen += range(c0, c0 + live)
        assert seen == list(range(end))


@pytest.mark.parametrize("n,kernel,causal,scores,exponentials", [
    (257, "forward", False, 84_480, 71_808),
    (593, "forward", False, 384_000, 364_800),
    (77, "forward", True, 9_216, 5_376),
    (257, "dq", False, 84_480, 71_808),
    (593, "dq", False, 384_000, 364_800),
    (257, "dkdv", False, 84_480, 71_808),
    (593, "dkdv", False, 384_000, 364_800),
])
def test_plan_products_are_the_ones_perf_md_reports(n, kernel, causal,
                                                    scores, exponentials):
    """Scores computed per (batch, head) (every block's 64 rows by the
    widths of its column tiles) and exponentials taken (the warps with a
    live row), against the old grid of whole 64 x 64 tiles: 102,400 at N =
    257, 409,600 at 593, 16,384 at 77."""
    p = kernels.plan(n, 64, kernel, causal=causal)
    assert (p.scores, p.exponentials) == (scores, exponentials)
    whole = -(-n // 64) * 64
    assert p.scores < whole * whole
