"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA GPU and nvcc; skips elsewhere. Imports no JAX, so it runs on a
machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
(`--noconftest`: tests/conftest.py sets up JAX for the rest of the suite).
"""
import numpy as np
import pytest
import torch

from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.kernels import attention as kernels
from missm_tpu_torch.kernels import ln_linear as lnl
from missm_tpu_torch.kernels import mlp_bwd
from missm_tpu_torch.kernels import probe_attention as pa
from missm_tpu_torch.models import finetune
from missm_tpu_torch.models.fusion import (FUSION_TYPES, FusionConfig,
                                            fusion_forward, init_fusion)
from missm_tpu_torch.train.step import (EMA_DECAY, init_train_state,
                                        make_train_step)
from missm_tpu_torch.train.trainability import leaves

pytestmark = pytest.mark.cuda

# f32: the kernel and the plain version differ only in summation order.
# bf16: they round P at different places (the kernel rounds the
# unnormalised exponentials, the plain version the probabilities) and the
# output to bf16, whose ulp is 2^-7 of the value at most.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2 ** -7)}
# Gradients, as ||got - ref|| / ||ref|| per tensor. f32: summation order
# only. bf16: the kernels round P and dS to bf16 as product operands (K3
# also takes D = rowsum(dO O) from the bf16 output), where the plain version
# keeps f32 throughout; each output is rounded to bf16 (2^-9 relative).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SHAPES = [(2, 257, 16, 64), (3, 77, 12, 64), (2, 16, 2, 16), (2, 33, 2, 128),
          (2, 70, 3, 48), (2, 593, 16, 64)]
# short_attention (K2 mode c): (M, T, heads, hd). M need not be a multiple
# of anything; T up to 32 (T=32 at hd=128 in f32 takes more than 48 KB of
# shared memory per warp).
SHORT_SHAPES = [(37, 8, 2, 64), (64, 4, 3, 16), (19, 4, 2, 64), (40, 8, 4, 16),
                (11, 13, 3, 48), (5, 32, 2, 128), (4112, 8, 16, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _inputs(gen, b, n, heads, hd, dtype, pad):
    q, k, v = (torch.randn(b, n, heads * hd, generator=gen, device=gen.device)
               .to(dtype) for _ in range(3))
    kb = None
    if pad:
        kb = torch.zeros(b, 1, n, device=gen.device)
        for i in range(b):
            kb[i, 0, n // 2 + i:] = torch.finfo(torch.float32).min
    return q, k, v, kb


def _rel(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _counts(**launched):
    """Every launch count 0 but those given."""
    return dict(dict.fromkeys(kernels.LAUNCHES, 0), **launched)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,t,heads,hd", SHORT_SHAPES)
def test_short_kernel_matches_plain(cuda, dtype, m, t, heads, hd):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(m, t, heads * hd, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    kernels.reset_launches()
    got = kernels.short_attention(q, k, v, heads)
    ref = kernels.short_attention_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert kernels.LAUNCHES == _counts(short_attention=1)


def test_short_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(4, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        kernels.short_attention(q.half(), q.half(), q.half(), 2)      # dtype
    with pytest.raises(ValueError):
        kernels.short_attention(q, q, q, 8)                           # hd 8
    with pytest.raises(ValueError):
        kernels.short_attention(q, q.bfloat16(), q, 2)                # mixed
    with pytest.raises(ValueError):
        kernels.short_attention(q, q[:2], q, 2)                       # shape
    with pytest.raises(ValueError):
        kernels.short_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                                q, q, 2)                              # strides
    long = torch.zeros(2, 33, 64, device=cuda)
    with pytest.raises(ValueError):
        kernels.short_attention(long, long, long, 2)                  # T > 32
    with pytest.raises(ValueError):
        kernels.short_attention(q[0], q[0], q[0], 2)                  # 2-D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_wrapper_carries_gradients(cuda, dtype):
    """A recorded call launches the K2(c) forward and, through autograd, the
    K4 block-diagonal backward kernel, whose gradients match
    short_attention_bwd_plain; the same inputs under no_grad or inference
    mode launch the forward alone and keep no graph."""
    m, t, heads, hd = 24, 8, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, g = (torch.randn(m, t, heads * hd, generator=gen, device=cuda)
                  .to(dtype) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    kernels.reset_launches()
    out = kernels.short_attention(*leaves, heads)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _counts(short_attention=1,
                                       short_attention_bwd=1)
    for name, x, r in zip(("dq", "dk", "dv"), got,
                          kernels.short_attention_bwd_plain(q, k, v, g,
                                                            heads)):
        assert x.dtype == dtype and x.abs().sum() > 0, name
        assert _rel(x, r) <= GRAD_TOL[dtype], (name, _rel(x, r))
    kernels.reset_launches()
    with torch.no_grad():
        nograd = kernels.short_attention(*leaves, heads)
    with torch.inference_mode():
        inference = kernels.short_attention(*leaves, heads)
    assert nograd.grad_fn is None and inference.grad_fn is None
    assert kernels.LAUNCHES == _counts(short_attention=2)
    atol, rtol = TOL[dtype]
    ref = kernels.short_attention_plain(q, k, v, heads)
    torch.testing.assert_close(nograd.float(), ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(out.detach(), nograd, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,t,heads,hd", SHORT_SHAPES)
def test_short_backward_kernel_matches_plain(cuda, dtype, m, t, heads, hd):
    """K4 block-diagonal against short_attention_bwd_plain over K2(c)'s
    shapes (ragged M, T from 4 to 32, hd from 16 to 128), launched on a
    non-contiguous cotangent as the temporal relayout hands it over."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(m, t, heads * hd, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    g = (torch.randn(t, m, heads * hd, generator=gen, device=cuda)
         .to(dtype).transpose(0, 1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    kernels.reset_launches()
    got = torch.autograd.grad(kernels.short_attention(*leaves, heads),
                              leaves, g)
    ref = kernels.short_attention_bwd_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _counts(short_attention=1,
                                       short_attention_bwd=1)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert x.dtype == dtype and x.shape == q.shape, name
        assert torch.isfinite(x).all(), name
        assert _rel(x, r) <= GRAD_TOL[dtype], (name, _rel(x, r))


def test_short_backward_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(4, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        kernels._launch_short_bwd(q, q, q, q.bfloat16(), 2)          # g dtype
    with pytest.raises(ValueError):
        kernels._launch_short_bwd(q, q, q, q[:2], 2)                 # g shape
    with pytest.raises(ValueError):
        kernels._launch_short_bwd(q.half(), q.half(), q.half(), q.half(), 2)
    with pytest.raises(ValueError):
        kernels._launch_short_bwd(q, q, q, q, 8)                     # hd 8
    with pytest.raises(ValueError):
        kernels._launch_short_bwd(q, q, q, q.transpose(0, 1)
                                  .contiguous().transpose(0, 1), 2)  # strides
    long = torch.zeros(2, 33, 64, device=cuda)
    with pytest.raises(ValueError):
        kernels._launch_short_bwd(long, long, long, long, 2)         # T > 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,hd", SHAPES)
@pytest.mark.parametrize("mode", ["attention", "causal", "causal_pad"])
def test_kernel_matches_plain(cuda, dtype, b, n, heads, hd, mode):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, kb = _inputs(gen, b, n, heads, hd, dtype, mode == "causal_pad")
    kernels.reset_launches()
    if mode == "attention":
        got = kernels.attention(q, k, v, heads)
        ref = kernels.attention_plain(q, k, v, heads)
    else:
        got = kernels.causal_attention(q, k, v, kb, heads)
        ref = kernels.attention_plain(q, k, v, heads, causal=True, kbias=kb)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    name = (kernels.attention_route(n, heads, hd) if mode == "attention"
            else "causal_attention")
    assert kernels.LAUNCHES[name] == 1 and sum(kernels.LAUNCHES.values()) == 1


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        kernels.attention(q.half(), q.half(), q.half(), 2)      # dtype
    with pytest.raises(ValueError):
        kernels.attention(q, q, q, 8)                           # hd 8
    with pytest.raises(ValueError):
        kernels.attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                          q, q, 2)                              # strides
    with pytest.raises(ValueError):
        kernels.causal_attention(q, q, q, torch.zeros(2, 1, 8, device=cuda,
                                                      dtype=torch.bfloat16), 2)


def test_tiny_model_on_the_card_matches_the_cpu(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = finetune.ModelConfig(
        towers=(("image", tiny_tower("image")),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=16))
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 98, size=(4, 16)).astype(np.int32)
    ids[:, 9] = 98
    data = {"language": {"input_ids": ids,
                         "attention_mask": (np.arange(16) < 10)[None].repeat(
                             4, 0).astype(np.int32)},
            "image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32)}
    missing = np.array([0, 1, 4, 0], np.int32)
    ref, _ = finetune.model_forward(params, cfg, data, missing, device="cpu")
    card = finetune.tree_map(lambda t: t.to(cuda), params)
    kernels.reset_launches()
    got, _ = finetune.model_forward(card, cfg, data, missing, device=cuda)
    # N = 5 image tokens: the unsplit route
    assert kernels.LAUNCHES == _counts(attention_unsplit=2, causal_attention=2)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


def test_tiny_video_audio_model_on_the_card_matches_the_cpu(cuda,
                                                           monkeypatch):
    """The eval3 model at tiny size (video with the temporal MLP, audio, the
    audio tower's text), f32, temporal LoRA B non-zero: the card's logits
    against the CPU's plain path, and the launches of each route."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = finetune.ModelConfig(
        towers=(("video", tiny_tower("video", temporal_mlp=True)),
                ("audio", tiny_tower("audio"))),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "video", "audio"),
                            output_dims=3, feature_dims=24, fusion_dim=16))
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(6)
    for block in params["encoder"]["video"]["vision"]["blocks"]:
        for proj in [*block["tattn"].values(), *block["tmlp"].values()]:
            proj["lora_b"].normal_(0.0, 0.05, generator=gen)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 98, size=(4, 16)).astype(np.int32)
    ids[:, 9] = 98
    data = {"language": ids,
            "video": rng.standard_normal((4, 3, 4, 32, 32)).astype(np.float32),
            "audio": rng.standard_normal((4, 3, 32, 48)).astype(np.float32)}
    missing = np.array([0, 1, 2, 3], np.int32)
    ref, _ = finetune.model_forward(params, cfg, data, missing, device="cpu")
    card = finetune.tree_map(lambda t: t.to(cuda), params)
    kernels.reset_launches()
    got, _ = finetune.model_forward(card, cfg, data, missing, device=cuda)
    # 2 layers per tower; the spatial N = 5 (video) and 7 (audio) take the
    # unsplit route
    assert kernels.LAUNCHES == _counts(attention_unsplit=4, short_attention=2,
                                       causal_attention=2)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,hd", SHAPES)
def test_backward_kernel_matches_plain(cuda, dtype, b, n, heads, hd):
    """K3 against attention_bwd_plain, from the forward kernel's output and
    log-sum-exp."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, g = (torch.randn(b, n, heads * hd, generator=gen, device=cuda)
                  .to(dtype) for _ in range(4))
    out, lse = kernels._launch(q, k, v, None, heads, causal=False,
                               want_lse=True)
    got = kernels._launch_bwd(q, k, v, out, lse, g, heads)
    ref = kernels.attention_bwd_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert x.dtype == dtype and torch.isfinite(x).all(), name
        assert _rel(x, r) <= GRAD_TOL[dtype], (name, _rel(x, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["attention", "causal_pad"])
def test_wrappers_carry_gradients(cuda, dtype, mode):
    """Autograd through each CUDA wrapper (K1 forward + K3 backward, K2
    forward + plain backward) against autograd of the plain version: the
    kernels' outputs keep their grad_fn."""
    b, n, heads, hd = 2, 77, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, kb = _inputs(gen, b, n, heads, hd, dtype, mode == "causal_pad")
    g = torch.randn(b, n, heads * hd, generator=gen, device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if kb is not None:
        leaves.append(kb.clone().requires_grad_())

    def grads(fn):
        t = [x.detach().clone().requires_grad_() for x in leaves]
        return torch.autograd.grad(fn(*t), t, g)

    if mode == "attention":
        run = lambda q, k, v: kernels.attention(q, k, v, heads)  # noqa: E731
        plain = lambda q, k, v: kernels.attention_plain(  # noqa: E731
            q, k, v, heads)
    else:
        run = lambda q, k, v, kb: kernels.causal_attention(  # noqa: E731
            q, k, v, kb, heads)
        plain = lambda q, k, v, kb: kernels.attention_plain(  # noqa: E731
            q, k, v, heads, causal=True, kbias=kb)
    kernels.reset_launches()
    got = grads(run)
    torch.cuda.synchronize()
    if mode == "attention":  # N = 77: the unsplit route
        assert kernels.LAUNCHES == _counts(attention_unsplit=1,
                                           attention_unsplit_bwd=1)
    else:
        assert kernels.LAUNCHES == _counts(causal_attention=1)
    want = grads(plain)
    for i, (x, w) in enumerate(zip(got, want)):
        assert x is not None and x.abs().sum() > 0, i
        assert _rel(x, w) <= GRAD_TOL[dtype], (i, _rel(x, w))


def test_backward_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 8, 64, device=cuda)
    lse = torch.zeros(2, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        kernels._launch_bwd(q, q, q, q, lse, q.bfloat16(), 2)   # g dtype
    with pytest.raises(ValueError):
        kernels._launch_bwd(q, q, q, q, lse[:, :1], q, 2)       # lse shape


# The tile edges of the bf16 kernels (64-row tiles, narrow last tiles in
# steps of 8) and the main path's N.
EDGE_N = (1, 8, 15, 16, 17, 63, 64, 65, 77, 127, 128, 129, 257, 593)


def _edge_kbias(b, n, mode, device):
    """causal_pad: keys from n // 2 + i on padded in row i of the batch, as
    _inputs pads them (key 0 never); causal_key0: every key but key 0
    padded, so that each query row keeps only key 0."""
    kb = torch.zeros(b, 1, n, device=device)
    neg = torch.finfo(torch.float32).min
    for i in range(b):
        kb[i, 0, (max(1, n // 2 + i) if mode == "causal_pad" else 1):] = neg
    return kb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("mode", ["attention", "causal", "causal_pad",
                                  "causal_key0"])
def test_kernel_edges_match_plain(cuda, dtype, n, mode):
    """The forward kernel at every tile edge, bias-free, causal, causal
    with padded keys and causal with every key but key 0 padded."""
    b, heads = 2, 2
    gen = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn(b, n, heads * 64, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    if mode == "attention":
        got, _ = kernels._launch(q, k, v, None, heads, causal=False)
        ref = kernels.attention_plain(q, k, v, heads)
    else:
        kb = None if mode == "causal" else _edge_kbias(b, n, mode, cuda)
        got, _ = kernels._launch(q, k, v, kb, heads, causal=True)
        ref = kernels.attention_plain(q, k, v, heads, causal=True, kbias=kb)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", EDGE_N)
def test_recorded_forward_writes_the_log_sum_exp(cuda, dtype, n):
    """The log-sum-exp [B, H, N] the recorded forward writes against
    torch.logsumexp of the plain scores (q scaled in its own type, f32
    products). f32 sums in another order; bf16 the same."""
    b, heads, hd = 2, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn(b, n, heads * hd, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    _, lse = kernels._launch(q, k, v, None, heads, causal=False,
                             want_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk",
                     (q * hd ** -0.5).reshape(b, n, heads, hd).float(),
                     k.reshape(b, n, heads, hd).float())
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", EDGE_N)
def test_backward_edges_match_plain(cuda, dtype, n):
    """The backward kernel at every tile edge, from the forward kernel's
    output and log-sum-exp: each of dq, dk and dv."""
    b, heads = 2, 2
    gen = torch.Generator(device=cuda).manual_seed(n)
    q, k, v, g = (torch.randn(b, n, heads * 64, generator=gen, device=cuda)
                  .to(dtype) for _ in range(4))
    out, lse = kernels._launch(q, k, v, None, heads, causal=False,
                               want_lse=True)
    got = kernels._launch_bwd(q, k, v, out, lse, g, heads)
    ref = kernels.attention_bwd_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert x.dtype == dtype and torch.isfinite(x).all(), name
        if n == 1 and name != "dv":
            # one key: P = 1, so dS = P (dP - D) and with it dq and dk are
            # exactly 0; the kernel's are what is left of dP - D, held
            # against the scale of dv (= dO) instead of a zero norm
            assert x.float().norm() <= GRAD_TOL[dtype] * got[2].float().norm()
        else:
            assert _rel(x, r) <= GRAD_TOL[dtype], (name, _rel(x, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(16, 257), (8, 593)])
def test_backward_at_the_train_steps_shapes(cuda, dtype, b, n):
    """K3 at the train step's microbatch [16, 257, 16*64] and K4 unmasked
    at train3's [8, 593, 16*64]: each of dq, dk and dv."""
    heads = 16
    gen = torch.Generator(device=cuda).manual_seed(b + n)
    q, k, v, g = (torch.randn(b, n, heads * 64, generator=gen, device=cuda)
                  .to(dtype) for _ in range(4))
    out, lse = kernels._launch(q, k, v, None, heads, causal=False,
                               want_lse=True)
    got = kernels._launch_bwd(q, k, v, out, lse, g, heads)
    ref = kernels.attention_bwd_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(x).all(), name
        assert _rel(x, r) <= GRAD_TOL[dtype], (name, _rel(x, r))


def test_plans_ask_for_the_kernels_shared_memory(cuda):
    """kernels/attention.py::plan's dynamic shared memory is what the C
    launchers ask for, at every head dim."""
    import ctypes

    from missm_tpu_torch.kernels import build
    fwd = build.function("attention", "missm_attention_forward_smem",
                         [ctypes.c_int])
    bwd = build.function("attention_bwd", "missm_attention_backward_smem",
                         [ctypes.c_int, ctypes.c_int])
    for hd in kernels._HEAD_DIMS:
        assert fwd(hd) == kernels.plan(257, hd).smem_bytes, hd
        assert bwd(hd, 0) == kernels.plan(257, hd, "dq").smem_bytes, hd
        assert bwd(hd, 1) == kernels.plan(257, hd, "dkdv").smem_bytes, hd


def _tiny_train(device, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = finetune.ModelConfig(
        towers=(("image", tiny_tower("image")),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=16,
                            dropout_prob=0.0))
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for block in params["encoder"]["image"]["vision"]["blocks"]:
        for proj in block["attn"].values():
            proj["lora_b"].normal_(0.0, 0.05, generator=gen)
    params = finetune.tree_map(lambda t: t.to(device), params)
    state, tx = init_train_state(params, cfg)
    step = make_train_step(cfg, tx, accum_steps=2, device=device)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 98, size=(4, 16)).astype(np.int32)
    ids[:, 9] = 98
    data = {"language": {"input_ids": ids,
                         "attention_mask": (np.arange(16) < 12)[None].repeat(
                             4, 0).astype(np.int32)},
            "image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32)}
    state, m = step(state, data, np.array([0, 1, 2, 0]),
                    np.array([0, 1, 4, 0]), 1e-3,
                    torch.Generator(device=device).manual_seed(0))
    return float(m["loss"]), [t.grad.cpu() for t in leaves(params)
                              if t.grad is not None]


def test_tiny_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One accum-2 step in f32: the card's loss and every trainable leaf's
    gradient against the CPU's plain path, and the main path's launches."""
    loss_cpu, grads_cpu = _tiny_train("cpu", monkeypatch)
    kernels.reset_launches()
    loss_gpu, grads_gpu = _tiny_train(cuda, monkeypatch)
    torch.cuda.synchronize()
    # 2 layers per tower, 2 microbatches; N = 5 image tokens: unsplit route
    assert kernels.LAUNCHES == _counts(attention_unsplit=4,
                                       attention_unsplit_bwd=4,
                                       causal_attention=4)
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-5)
    assert len(grads_gpu) == len(grads_cpu)
    for i, (x, w) in enumerate(zip(grads_gpu, grads_cpu)):
        assert _rel(x, w) <= 1e-4 or (w.norm() < 1e-8 and x.norm() < 1e-8), i


def _tiny_train3(device, monkeypatch):
    """One step of the video+audio+language model at tiny size, f32, LoRA B
    non-zero on the temporal and the audio attention: (loss, the trainable
    leaves' gradients)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = finetune.ModelConfig(
        towers=(("video", tiny_tower("video")), ("audio", tiny_tower("audio"))),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "video", "audio"),
                            output_dims=3, feature_dims=24, fusion_dim=16,
                            dropout_prob=0.0))
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(8)
    for mod, attn in (("video", "tattn"), ("audio", "attn")):
        for block in params["encoder"][mod]["vision"]["blocks"]:
            for proj in block[attn].values():
                proj["lora_b"].normal_(0.0, 0.05, generator=gen)
    params = finetune.tree_map(lambda t: t.to(device), params)
    state, tx = init_train_state(params, cfg)
    step = make_train_step(cfg, tx, accum_steps=1, device=device)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 98, size=(4, 16)).astype(np.int32)
    ids[:, 9] = 98
    data = {"language": ids,
            "video": rng.standard_normal((4, 3, 4, 32, 32)).astype(np.float32),
            "audio": rng.standard_normal((4, 3, 32, 48)).astype(np.float32)}
    state, m = step(state, data, np.array([0, 1, 2, 0]),
                    np.array([0, 1, 2, 3]), 1e-3,
                    torch.Generator(device=device).manual_seed(0))
    return float(m["loss"]), [t.grad.cpu() for t in leaves(params)
                              if t.grad is not None]


def test_tiny_video_audio_train_step_on_the_card_matches_the_cpu(
        cuda, monkeypatch):
    """The train3 step at tiny size in f32: the card's loss and every
    trainable leaf's gradient against the CPU's plain path, and the
    launches of each route, the K4 block-diagonal backward among them."""
    loss_cpu, grads_cpu = _tiny_train3("cpu", monkeypatch)
    kernels.reset_launches()
    loss_gpu, grads_gpu = _tiny_train3(cuda, monkeypatch)
    torch.cuda.synchronize()
    # 2 layers per tower; the spatial N = 5 (video) and 7 (audio) take the
    # unsplit route
    assert kernels.LAUNCHES == _counts(attention_unsplit=4,
                                       attention_unsplit_bwd=4,
                                       short_attention=2,
                                       short_attention_bwd=2,
                                       causal_attention=2)
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-5)
    assert len(grads_gpu) == len(grads_cpu)
    for i, (x, w) in enumerate(zip(grads_gpu, grads_cpu)):
        assert _rel(x, w) <= 1e-4 or (w.norm() < 1e-8 and x.norm() < 1e-8), i


# ---------------------------------------------------------------------------
# K5 (ln_linear) and K6 (mlp_bwd_dx)
# ---------------------------------------------------------------------------


def _ln_inputs(gen, shape, f, dtype, bias):
    d = shape[-1]
    x = torch.randn(*shape, generator=gen, device=gen.device) * 2 + 0.5
    ln = {"scale": 1 + 0.1 * torch.randn(d, generator=gen, device=gen.device),
          "bias": 0.1 * torch.randn(d, generator=gen, device=gen.device)}
    lin = {"w": torch.randn(d, f, generator=gen, device=gen.device)
           * (2 * d) ** -0.5}
    if bias:
        lin["b"] = 0.1 * torch.randn(f, generator=gen, device=gen.device)
    cast = finetune.cast_tree
    return x.to(dtype), cast(ln, dtype), cast(lin, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("m", [1232, 1000])
def test_ln_linear_kernel_matches_plain(cuda, monkeypatch, m, d, bias, dtype):
    """K5 at ragged row counts (1232 = 16 * 77, a train microbatch's text
    rows, and 1000: neither a multiple of the 64-row tile), against its
    plain version."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(9)
    x, ln, lin = _ln_inputs(gen, (m, d), 4 * d, dtype, bias)
    kernels.reset_launches()
    got = lnl.ln_linear(x, ln, lin)
    ref = lnl.ln_linear_plain(x, ln, lin)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, 4 * d)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert kernels.LAUNCHES == _counts(ln_linear=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_linear_kernel_takes_3d_input_and_bf16_vectors(cuda, monkeypatch,
                                                          dtype):
    """[16, 77, 768] input, the text tower's shape; in bf16 with gamma, beta
    and the bias left in f32 (the kernel reads either type)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(10)
    x, ln, lin = _ln_inputs(gen, (16, 77, 768), 3072, dtype, True)
    if dtype == torch.bfloat16:
        ln = finetune.cast_tree(ln, torch.float32)
        lin["b"] = lin["b"].float()
    kernels.reset_launches()
    got = lnl.ln_linear(x, ln, lin)
    ref = lnl.ln_linear_plain(x, ln, lin)
    torch.cuda.synchronize()
    assert got.shape == (16, 77, 3072) and got.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert kernels.LAUNCHES == _counts(ln_linear=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frozen", [False, True])
def test_ln_linear_wrapper_carries_gradients(cuda, monkeypatch, dtype, frozen):
    """Autograd through the wrapper (K5 forward, plain backward) against
    autograd of the plain version in f32: dx, dgamma, dbeta, dW and db, or
    no dW for a frozen W."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, ln, lin = _ln_inputs(gen, (1232, 768), 3072, dtype, True)
    g = torch.randn(1232, 3072, generator=gen, device=cuda).to(dtype)
    leaves = [x, ln["scale"], ln["bias"], lin["w"], lin["b"]]
    for i, t in enumerate(leaves):
        t.requires_grad_(not (frozen and i == 3))
    kernels.reset_launches()
    out = lnl.ln_linear(x, ln, lin)
    want = [t for t in leaves if t.requires_grad]
    got = torch.autograd.grad(out, want, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _counts(ln_linear=1)
    assert lin["w"].requires_grad != frozen
    ref_leaves = [t.detach().float().requires_grad_(t.requires_grad)
                  for t in leaves]
    ref_out = lnl.ln_linear_plain(
        ref_leaves[0], {"scale": ref_leaves[1], "bias": ref_leaves[2]},
        {"w": ref_leaves[3], "b": ref_leaves[4]})
    ref = torch.autograd.grad(ref_out, [t for t in ref_leaves
                                        if t.requires_grad], g.float())
    assert len(got) == len(ref) == (4 if frozen else 5)
    for i, (x_, r) in enumerate(zip(got, ref)):
        assert x_.dtype == dtype and torch.isfinite(x_).all(), i
        assert _rel(x_, r) <= GRAD_TOL[dtype], (i, _rel(x_, r))


def test_ln_linear_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(8, 256, device=cuda)
    ln = {"scale": torch.ones(256, device=cuda),
          "bias": torch.zeros(256, device=cuda)}
    w = torch.zeros(256, 384, device=cuda)
    with pytest.raises(ValueError):
        lnl.ln_linear(x.half(), ln, {"w": w.half()})                  # dtype
    with pytest.raises(ValueError):
        lnl.ln_linear(x, ln, {"w": w.bfloat16()})                     # mixed
    with pytest.raises(ValueError):
        lnl.ln_linear(x[:, :200], {k: v[:200] for k, v in ln.items()},
                      {"w": w[:200]})                                 # D
    with pytest.raises(ValueError):
        lnl.ln_linear(x, ln, {"w": w[:, :300].contiguous()})          # F
    with pytest.raises(ValueError):
        lnl.ln_linear(x, ln, {"w": w, "b": torch.zeros(3, device=cuda)})
    with pytest.raises(ValueError):
        lnl.ln_linear(x, {"scale": ln["scale"].half(), "bias": ln["bias"]},
                      {"w": w})                                       # gamma
    wide = torch.zeros(8, 16384, device=cuda, dtype=torch.bfloat16)
    ones = torch.ones(16384, device=cuda)
    with pytest.raises(ValueError):                                   # smem
        lnl.ln_linear(wide, {"scale": ones, "bias": ones},
                      {"w": torch.zeros(16384, 128, device=cuda,
                                        dtype=torch.bfloat16)})


# Every edge of the bf16 kernel's plan (kernels/ln_linear.py::plan): rows
# around its 128-row tiles and a train microbatch's 1232 and 4112, the
# 64-column depth steps at D = 128 / 768 / 1024, and F at one and three
# 128-wide tiles and the paths' 3072 and 4096 (256-wide tiles, clusters of
# 1 to 8 blocks).
LN_EDGE_M = (8, 56, 64, 72, 120, 128, 136, 1232, 4112)
LN_EDGE_D = (128, 768, 1024)
LN_EDGE_F = (128, 384, 3072, 4096)


@pytest.mark.parametrize("f", LN_EDGE_F)
@pytest.mark.parametrize("d", LN_EDGE_D)
@pytest.mark.parametrize("m", LN_EDGE_M)
def test_ln_linear_kernel_edges_match_plain(cuda, monkeypatch, m, d, f):
    """K5 in bf16 with the bias, and in f32 without it, at every edge,
    against its plain version; one launch each."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(m + d + f)
    for dtype, bias in ((torch.bfloat16, True), (torch.float32, False)):
        x, ln, lin = _ln_inputs(gen, (m, d), f, dtype, bias)
        kernels.reset_launches()
        got = lnl.ln_linear(x, ln, lin)
        ref = lnl.ln_linear_plain(x, ln, lin)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (m, f)
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        assert kernels.LAUNCHES == _counts(ln_linear=1)


@pytest.mark.parametrize("vectors", ["bf16", "f32", "mixed"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(16448, 1024), (64, 257, 1024),
                                   (16, 77, 768), (1, 72, 128)])
def test_ln_linear_kernel_takes_each_variant(cuda, monkeypatch, shape, bias,
                                             vectors):
    """bf16 K5 on 2-D and 3-D input (the eval image rows, the image and
    text towers' [B, N, D]), with and without the bias, gamma, beta and b
    in bf16, in f32, or gamma and beta in f32 beside a bf16 bias."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    f = 4 * shape[-1]
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + bias)
    x, ln, lin = _ln_inputs(gen, shape, f, torch.bfloat16, bias)
    if vectors != "bf16":
        ln = finetune.cast_tree(ln, torch.float32)
    if vectors == "f32" and bias:
        lin["b"] = lin["b"].float()
    kernels.reset_launches()
    got = lnl.ln_linear(x, ln, lin)
    ref = lnl.ln_linear_plain(x, ln, lin)
    torch.cuda.synchronize()
    assert got.shape == (*shape[:-1], f) and got.dtype == torch.bfloat16
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert kernels.LAUNCHES == _counts(ln_linear=1)


def test_ln_linear_plan_is_what_the_launcher_computes(cuda):
    """kernels/ln_linear.py::plan's tile width, cluster, stages and shared
    memory are what the C launcher takes, at every edge and path shape."""
    import ctypes

    from missm_tpu_torch.kernels import build
    fn = build.function("ln_linear", "missm_ln_linear_plan",
                        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    smem = build.function("ln_linear", "missm_ln_linear_smem",
                          [ctypes.c_int] * 3)
    out = (ctypes.c_int * 4)()
    for m in (*LN_EDGE_M, 4928, 16448):
        for d in (*LN_EDGE_D, 8192, 16384):
            for f in LN_EDGE_F:
                p = lnl.plan(m, d, f)
                fn(m, d, f, ctypes.addressof(out))
                assert tuple(out) == (p.bn, p.groups, p.stages,
                                      p.smem_bytes), (m, d, f)
                assert smem(m, d, f) == p.smem_bytes


MLP_CASES = [(80, 1024, 4096), (4112, 1024, 4096), (16448, 1024, 4096),
             (80, 128, 256), (200, 768, 3072)]


def _mlp_inputs(gen, m, d, ff, dtype):
    dy = torch.randn(m, d, generator=gen, device=gen.device)
    wide = torch.randn(m, ff, generator=gen, device=gen.device) * 0.5
    w1 = torch.randn(d, ff, generator=gen, device=gen.device) * 0.02
    w2 = torch.randn(ff, d, generator=gen, device=gen.device) * 0.02
    return [t.to(dtype) for t in (dy, wide, w1, w2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,ff", MLP_CASES)
def test_mlp_bwd_dx_kernel_matches_plain(cuda, monkeypatch, m, d, ff, dtype):
    """K6 at M = 80 (one ragged block), 4112 (a microbatch of 16 images)
    and 16448 (the probe's 64 images), and at other widths."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(12)
    args = _mlp_inputs(gen, m, d, ff, dtype)
    kernels.reset_launches()
    got = mlp_bwd.mlp_bwd_dx(*args)
    ref = mlp_bwd.mlp_bwd_dx_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, d)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert kernels.LAUNCHES == _counts(mlp_bwd_dx=1)


@pytest.mark.parametrize("tile", mlp_bwd.TILES)
def test_mlp_bwd_dx_kernel_tiles_agree(cuda, tile):
    """Every tile the probe sweeps, (rows, cluster), gives the plain
    version's result."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    args = _mlp_inputs(gen, 4112, 1024, 4096, torch.bfloat16)
    got = mlp_bwd.mlp_bwd_dx(*args, tile=tile)
    ref = mlp_bwd.mlp_bwd_dx_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def test_active_cluster_tables_are_the_cards(cuda):
    """kernels/ln_linear.py and kernels/mlp_bwd.py plan their waves with
    ACTIVE_CLUSTERS, clusters a card runs at once: each entry is what
    cudaOccupancyMaxActiveClusters says for the bf16 kernels at their
    flagship shared memory on an H100 (a cluster stays within a GPC)."""
    import ctypes

    from missm_tpu_torch.kernels import build
    if "H100" not in torch.cuda.get_device_name(0):
        pytest.skip("the tables are an H100's")
    args = [ctypes.c_int] * 3
    k5 = build.function("ln_linear", "missm_ln_linear_active_clusters", args)
    k6 = build.function("mlp_bwd", "missm_mlp_bwd_active_clusters", args)
    smem5 = lnl.plan(16448, 1024, 4096).smem_bytes
    smem6 = mlp_bwd.plan(16448, 1024, 4096).smem_bytes
    for g, n in lnl.ACTIVE_CLUSTERS.items():
        assert k5(256, g, smem5) == n, g
    for c, n in mlp_bwd.ACTIVE_CLUSTERS.items():
        assert k6(128, c, smem6) == n, c


# Rows around the 128-row cluster tiles (the last cluster's rows past M),
# and a train microbatch's 4112; FF = 3072 is a whole number of steps of
# every built tile.
MLP_EDGE_M = (8, 56, 64, 72, 120, 128, 136, 4112)


@pytest.mark.parametrize("d", mlp_bwd.D_SIZES)
@pytest.mark.parametrize("m", MLP_EDGE_M)
def test_mlp_bwd_dx_kernel_edges_match_plain(cuda, monkeypatch, m, d):
    """K6 at each width with each tile built for it in bf16, and in f32,
    against its plain version; one launch each."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    for dtype, tile in ([(torch.bfloat16, t) for t in mlp_bwd.tiles(d)]
                        + [(torch.float32, None)]):
        args = _mlp_inputs(gen, m, d, 3072, dtype)
        kernels.reset_launches()
        got = mlp_bwd.mlp_bwd_dx(*args, tile=tile)
        ref = mlp_bwd.mlp_bwd_dx_plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (m, d)
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol, msg=lambda e: f"{tile}: {e}")
        assert kernels.LAUNCHES == _counts(mlp_bwd_dx=1)


def test_mlp_bwd_dx_is_the_same_on_every_run(cuda):
    """No atomics: two launches give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    args = _mlp_inputs(gen, 4112, 1024, 4096, torch.bfloat16)
    for tile in mlp_bwd.TILES:
        a = mlp_bwd.mlp_bwd_dx(*args, tile=tile)
        b = mlp_bwd.mlp_bwd_dx(*args, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(a, b), tile


def test_mlp_bwd_plan_asks_for_the_kernels_shared_memory(cuda):
    """kernels/mlp_bwd.py::plan's shared memory is what the C launcher asks
    for at every built tile, and 0 for a tile it was not built for."""
    import ctypes

    from missm_tpu_torch.kernels import build
    smem = build.function("mlp_bwd", "missm_mlp_bwd_smem", [ctypes.c_int] * 3)
    for d in mlp_bwd.D_SIZES:
        for tile in mlp_bwd.tiles(d):
            assert smem(d, *tile) == mlp_bwd.plan(128, d, 3072,
                                                  tile).smem_bytes, (d, tile)
    assert smem(1024, 128, 2) == smem(1024, 32, 32) == smem(192, 128, 1) == 0


def test_mlp_bwd_dx_rejects_what_the_kernel_does_not_take(cuda):
    dy, wide, w1, w2 = _mlp_inputs(torch.Generator(device=cuda), 16, 128, 256,
                                   torch.bfloat16)
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(dy.float(), wide, w1, w2)                  # mixed
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(dy, wide[:, :128], w1, w2)                 # shape
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(dy, wide, w1, w2, tile=(16, 32))           # tile
    d = torch.zeros(16, 192, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(d, wide, w1[:1].expand(192, 256).contiguous(),
                           w2[:, :1].expand(256, 192).contiguous())   # D
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(dy, wide[:, :200].contiguous(), w1[:, :200]
                           .contiguous(), w2[:200].contiguous())      # FF
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(dy, wide, w1, w2, tile=(128, 2))           # NOUT 64
    big = _mlp_inputs(torch.Generator(device=cuda), 16, 1024, 2304,
                      torch.bfloat16)
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(*big, tile=(128, 8))                       # FF step
    with pytest.raises(ValueError):
        mlp_bwd.mlp_bwd_dx(*big, tile=(128, 16))                      # cluster


def test_fused_tiny_eval_step_on_the_card(cuda, monkeypatch):
    """A tiny image+text model at width 128 (which the gate admits) with the
    switch on: each block's ln2 -> fc1 launches K5, and the card's f32 eval
    outputs match the CPU's (the plain version through the same switch)."""
    import dataclasses

    from missm_tpu_torch.train.step import make_eval_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(lnl, "FUSE_LN2_FC1", True)
    wide = dict(hidden_size=128, intermediate_size=256)
    tower = tiny_tower("image", **wide)
    tower = dataclasses.replace(tower, text=dataclasses.replace(tower.text,
                                                                **wide))
    cfg = finetune.ModelConfig(
        towers=(("image", tower),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=16))
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 98, size=(8, 16)).astype(np.int32)
    ids[:, 9] = 98
    data = {"language": ids,
            "image": rng.standard_normal((8, 3, 32, 32)).astype(np.float32)}
    labels, missing = np.arange(8) % 3, np.array([0, 1, 4, 0] * 2)
    ref = make_eval_step(cfg, device="cpu")(params, data, labels, missing)
    card = finetune.tree_map(lambda t: t.to(cuda), params)
    kernels.reset_launches()
    got = make_eval_step(cfg, device=cuda)(card, data, labels, missing)
    torch.cuda.synchronize()
    # 2 layers per tower; the image tower's N = 5 takes the unsplit route
    assert kernels.LAUNCHES == _counts(attention_unsplit=2, causal_attention=2,
                                       ln_linear=4)
    torch.testing.assert_close(got["probs"].cpu(), ref["probs"], atol=1e-4,
                               rtol=1e-4)


# The timing probes' kernels (P1-P4): (LAUNCHES name, the wrapper on q, k,
# v, the plain version, the input shape at N tokens). P3 and P4 take 3
# heads of 64 in the token-major layout.
PROBE_ROUTES = {
    "P1": ("attn_probe_fused", pa.attn_probe_fused, pa.rows_attention_plain,
           lambda n: (6, n, 64)),
    "P2": ("tower_bhne", pa.tower_bhne, pa.rows_attention_plain,
           lambda n: (2, 3, n, 64)),
    "P3": ("tower_scratch", lambda q, k, v: pa.tower_scratch(q, k, v, 3),
           lambda q, k, v: pa.rows_attention_plain(q, k, v, layout="tokens",
                                                   num_heads=3),
           lambda n: (2, n, 192)),
    **{f"P4 {mode}": ("tower_packed_debug",
                      lambda q, k, v, mode=mode:
                      pa.tower_packed_debug(q, k, v, 3, mode),
                      lambda q, k, v, mode=mode:
                      pa.packed_attention_plain(q, k, v, 3, mode),
                      lambda n: (2, n, 192)) for mode in pa.MODES},
}


# The kernel each route launches in bf16 (`pa.plan`'s name; f32 has its
# own CUDA-core kernels with their own limits).
PROBE_KERNELS = {"P3": "scratch", "P4 nostage": "nostage"}
# Every tile edge of the bf16 kernels (8-key groups, 16-key steps, 64-row
# tiles, the two warpgroups of the batch-row kernel), and the route's limit.
PROBE_EDGE_N = (1, 8, 15, 16, 17, 63, 64, 65, 127, 128, 129, 257, 320,
                "limit")


def _probe_matches_plain(cuda, route, n, dtype):
    """One launch of the route's wrapper at N = n against its plain
    version, on seeded inputs of the route's shape."""
    name, run, plain, shape = PROBE_ROUTES[route]
    gen = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn(*shape(n), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    kernels.reset_launches()
    with torch.no_grad():
        got = run(q, k, v)
        ref = plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if route == "P4 noexp" and n == 1:
        # one key: den = sum(s - m) = 0 and e = 0, so the function is 0 / 0
        assert got.isnan().all() and ref.isnan().all()
        assert kernels.LAUNCHES == _counts(**{name: 1})
        return
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    if route == "P4 dotsonly":
        # outputs are sums of s v (tens); a score straddling a bf16
        # rounding boundary moves one by an ulp of s times v: held within
        # 1e-4 of the output's scale in f32 and 2^-8 in norm in bf16
        scale = max(1.0, ref.float().abs().max().item())
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=atol * scale, rtol=0)
        else:
            assert _rel(got, ref) <= 2 ** -8
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    assert kernels.LAUNCHES == _counts(**{name: 1})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [257, 77, 5, 320])
@pytest.mark.parametrize("route", PROBE_ROUTES)
def test_probe_kernel_matches_plain(cuda, route, n, dtype):
    """Each probe route and mode against its plain version at the probes'
    N = 257 and at ragged N (one partial key step, fewer keys than one
    tile, the batch-row kernel with one warpgroup), one launch each."""
    _probe_matches_plain(cuda, route, n, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", PROBE_EDGE_N)
@pytest.mark.parametrize("route", PROBE_ROUTES)
def test_probe_kernel_edges_match_plain(cuda, route, n, dtype):
    """Each probe route and mode at every tile edge and at the largest N
    its kernel takes in the type, against its plain version."""
    if n == "limit":
        # the bf16 whole-row and nostage kernels keep no score row and have
        # no limit: a row longer than any kernel's limit instead
        n = pa.max_n(PROBE_KERNELS.get(route, "rows"),
                     bf16=dtype == torch.bfloat16) or 1025
    _probe_matches_plain(cuda, route, n, dtype)


@pytest.mark.parametrize("n", [897, 1025, 2048])
def test_probe_nostage_takes_long_rows(cuda, n):
    """The bf16 nostage kernel keeps no score row in shared memory, so it
    takes N past 896, where 64 f32 score rows would outgrow a block's
    shared memory: against packed_attention_plain(mode="nostage")."""
    _probe_matches_plain(cuda, "P4 nostage", n, torch.bfloat16)


@pytest.mark.parametrize("g", [1, 67])
@pytest.mark.parametrize("rows", pa.ROWS)
def test_probe_kernel_partial_wave(cuda, rows, g):
    """P1 over slice counts whose blocks fill no whole wave of the card
    (67 slices of 257 rows: 335 or 201 blocks), at each tile."""
    gen = torch.Generator(device=cuda).manual_seed(g)
    q, k, v = (torch.randn(g, 257, 64, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    got = pa.attn_probe_fused(q, k, v, rows=rows)
    ref = pa.rows_attention_plain(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def test_probe_plans_ask_for_the_kernels_shared_memory(cuda):
    """kernels/probe_attention.py::plan's dynamic shared memory is what the
    C launchers ask for, for every bf16 kernel at every edge and limit."""
    import ctypes

    from missm_tpu_torch.kernels import build
    smem = build.function("probe_attention", "missm_probe_attention_smem",
                          [ctypes.c_int] * 3)
    for kernel, rows in (("rows", 64), ("rows", 128), ("scratch", 64),
                         ("nostage", 64)):
        limit = pa.max_n(kernel, rows) or 1025
        for n in (*PROBE_EDGE_N[:-1], 768, 769, limit, limit + 1):
            assert smem(pa.KERNELS.index(kernel), n, rows) == pa.plan(
                n, kernel, rows).smem_bytes, (kernel, rows, n)


@pytest.mark.parametrize("rows", pa.ROWS)
def test_probe_kernel_tiles_agree(cuda, rows):
    """Every query-row tile P1's probe sweeps gives the plain version's
    result, at N = 257 and at a row longer than any kernel's limit (the
    whole-row kernel keeps no score row, so it takes any N)."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    for n in (257, 1025):
        q, k, v = (torch.randn(4, n, 64, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(3))
        got = pa.attn_probe_fused(q, k, v, rows=rows)
        ref = pa.rows_attention_plain(q, k, v)
        torch.cuda.synchronize()
        atol, rtol = TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("route", PROBE_ROUTES)
def test_probe_kernel_raises_on_a_recorded_call(cuda, route):
    """The probe kernels are forward only: a call autograd records raises
    (and launches nothing); the same call under no_grad runs."""
    _, run, _, shape = PROBE_ROUTES[route]
    q, k, v = (torch.randn(*shape(17), device=cuda, requires_grad=True)
               for _ in range(3))
    kernels.reset_launches()
    with pytest.raises(NotImplementedError):
        run(q, k, v)
    assert sum(kernels.LAUNCHES.values()) == 0
    with torch.no_grad():
        run(q, k, v)


def test_probe_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(4, 17, 64, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError):
            pa.attn_probe_fused(q.half(), q.half(), q.half())         # dtype
        with pytest.raises(ValueError):
            pa.attn_probe_fused(q, q.bfloat16(), q)                   # mixed
        with pytest.raises(ValueError):
            pa.attn_probe_fused(q, q.cpu(), q)                        # device
        with pytest.raises(ValueError):
            pa.attn_probe_fused(q, q[:2], q)                          # shape
        with pytest.raises(ValueError):
            pa.attn_probe_fused(q[..., :32].contiguous(),
                                q[..., :32].contiguous(),
                                q[..., :32].contiguous())             # hd
        t = q.transpose(0, 1).contiguous().transpose(0, 1)
        with pytest.raises(ValueError):
            pa.attn_probe_fused(t, q, q)                              # strides
        with pytest.raises(ValueError):
            pa.attn_probe_fused(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                                rows=48)                              # tile
        with pytest.raises(ValueError):
            pa.tower_bhne(q, q, q)                                    # 3-D
        x = torch.zeros(2, 17, 128, device=cuda)
        with pytest.raises(ValueError):
            pa.tower_scratch(x, x, x, 4)                              # hd 32
        with pytest.raises(ValueError):
            pa.tower_packed_debug(x, x, x, 2, "nodots")               # mode
        xb = x.bfloat16()
        with pytest.raises(ValueError):
            pa._launch_rows(xb, xb, xb, 2, 17, 2, "full", after=True,
                            rows=128)                                 # tile
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            long = torch.zeros(1, pa.max_n("scratch", bf16=bf16) + 1, 128,
                               device=cuda, dtype=dtype)
            with pytest.raises(ValueError):
                pa.tower_scratch(long, long, long, 2)                 # N
        # bf16 nostage keeps no score row and has no N limit
        longer = torch.zeros(1, 1025, 128, device=cuda, dtype=torch.bfloat16)
        assert pa.tower_packed_debug(longer, longer, longer, 2,
                                     "nostage").shape == longer.shape
        longest = torch.zeros(1, pa.max_n("rows", bf16=False) + 1, 64,
                              device=cuda)
        with pytest.raises(ValueError):
            pa.attn_probe_fused(longest, longest, longest)            # N


# ---------------------------------------------------------------------------
# The fusion heads and the distillation step (plain PyTorch on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ftype", FUSION_TYPES)
def test_head_on_the_card_matches_the_cpu(cuda, monkeypatch, ftype):
    """Every head's f32 logits and the gradient of their sum with respect
    to every head param, card (TF32 off) against the CPU, codes rotating
    over {0, 1, 2, 3}; no kernel launches. Gradients: ||err|| / ||ref||
    per leaf, ||ref|| taken as at least 1e-3 of the head's largest
    gradient norm (a zero or cancelling gradient holds float noise of the
    size of the larger sums)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = FusionConfig(fusion_type=ftype,
                       modality_types=("language", "video", "audio"),
                       output_dims=10, feature_dims=48, fusion_dim=32)
    params = init_fusion(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    embeds = {m: torch.randn(12, 48, generator=gen)
              for m in cfg.modality_types}
    codes = torch.arange(12) % 4

    def run(device):
        p = finetune.tree_map(
            lambda t: t.detach().to(device, copy=True).requires_grad_(),
            params)
        logits, _ = fusion_forward(
            p, cfg, {m: e.to(device) for m, e in embeds.items()},
            codes.to(device))
        logits.sum().backward()
        return logits.detach().cpu(), [t.grad.cpu() for t in leaves(p)]

    ref, grads_cpu = run("cpu")
    kernels.reset_launches()
    got, grads_gpu = run(cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _counts()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    floor = 1e-3 * max(w.norm() for w in grads_cpu)
    for i, (x, w) in enumerate(zip(grads_gpu, grads_cpu)):
        assert (x - w).norm() <= 1e-4 * max(w.norm(), floor), i


def _tiny_distill(device, monkeypatch):
    """One accum-2 MTD_stu step of the tiny image+text model in f32 with a
    teacher: (loss, the trainable leaves' gradients, the teacher after the
    EMA update, the teacher before it, the updated student fusion)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    fusion = dict(modality_types=("language", "image"), output_dims=3,
                  feature_dims=24, fusion_dim=16, dropout_prob=0.0)
    cfg = finetune.ModelConfig(
        towers=(("image", tiny_tower("image")),),
        fusion=FusionConfig(fusion_type="MTD_stu", **fusion))
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for block in params["encoder"]["image"]["vision"]["blocks"]:
        for proj in block["attn"].values():
            proj["lora_b"].normal_(0.0, 0.05, generator=gen)
    teacher = init_fusion(gen, FusionConfig(fusion_type="Distill_tea",
                                            **fusion))
    params = finetune.tree_map(lambda t: t.to(device), params)
    teacher = finetune.tree_map(lambda t: t.to(device), teacher)
    state, tx = init_train_state(params, cfg, teacher_fusion=teacher)
    old = [t.clone() for t in leaves(state.teacher_fusion)]
    step = make_train_step(cfg, tx, accum_steps=2, device=device)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 98, size=(4, 16)).astype(np.int32)
    ids[:, 9] = 98
    data = {"language": {"input_ids": ids,
                         "attention_mask": (np.arange(16) < 12)[None].repeat(
                             4, 0).astype(np.int32)},
            "image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32)}
    state, m = step(state, data, np.array([0, 1, 2, 0]),
                    np.array([0, 1, 4, 0]), 1e-3,
                    torch.Generator(device=device).manual_seed(0),
                    np.array([True, True, True, False]))
    return (float(m["loss"]), [t.grad.cpu() for t in leaves(params)
                               if t.grad is not None],
            [t.cpu() for t in leaves(state.teacher_fusion)],
            [t.cpu() for t in old], [t.cpu() for t in leaves(params["fusion"])])


def test_tiny_distill_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One MTD_stu step with a padded row: the card's loss, gradients and
    EMA teacher against the CPU's, and the launches of the student's and
    the teacher's forwards."""
    loss_cpu, grads_cpu, teacher_cpu, _, _ = _tiny_distill("cpu", monkeypatch)
    kernels.reset_launches()
    loss_gpu, grads_gpu, teacher_gpu, old, student = _tiny_distill(
        cuda, monkeypatch)
    torch.cuda.synchronize()
    # 2 layers per tower, 2 microbatches, a student and a teacher forward
    # each; N = 5 image tokens: the unsplit route
    assert kernels.LAUNCHES == _counts(attention_unsplit=8,
                                       attention_unsplit_bwd=4,
                                       causal_attention=8)
    assert loss_gpu == pytest.approx(loss_cpu, rel=1e-5)
    assert len(grads_gpu) == len(grads_cpu)
    for i, (x, w) in enumerate(zip(grads_gpu, grads_cpu)):
        assert _rel(x, w) <= 1e-4 or (w.norm() < 1e-8 and x.norm() < 1e-8), i
    for x, w in zip(teacher_gpu, teacher_cpu, strict=True):
        torch.testing.assert_close(x, w, atol=1e-7, rtol=0)
    # the card's teacher is the rule applied to the card's updated student,
    # within 4 units of f32 rounding of the rule's terms; the EMA taken
    # toward the student before its Adam step would be off by up to
    # (1 - decay) x lr = 1e-6
    eps = torch.finfo(torch.float32).eps
    for t, o, s in zip(teacher_gpu, old, student, strict=True):
        terms = o.abs() * EMA_DECAY + s.abs() * (1.0 - EMA_DECAY)
        assert ((t - (o * EMA_DECAY + s * (1.0 - EMA_DECAY))).abs()
                <= 4 * eps * terms).all()


# ---------------------------------------------------------------------------
# The data layer's device transforms: the card against the same call on the
# CPU (the CPU against JAX: tests/test_torch_transforms.py), at the
# tolerances tests/test_host_transforms.py holds the JAX package's two
# transform paths to
# ---------------------------------------------------------------------------

def test_transforms_on_the_card_match_the_cpu(cuda):
    from missm_tpu_torch.ops import image_transforms as tit
    from missm_tpu_torch.ops import melfbank as tmel

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
    frames = rng.integers(0, 256, (8, 90, 160, 3), dtype=np.uint8)
    raw = rng.integers(0, 12000, (120, 160)).astype(np.float32)
    calls = [lambda d: tit.image_transform(img, 224, device=d),
             lambda d: tit.video_transform(frames, 224, True, device=d),
             lambda d: tit.depth_transform(raw, 224, 0.0, device=d),
             lambda d: tit.depth_transform(raw, 224, 10.0, device=d)]
    for call in calls:
        got = call(cuda)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), call("cpu"), atol=2e-4,
                                   rtol=1e-4)
    cfg = tmel.FbankConfig()
    for n in (48000, 16000 * 15):
        wav = rng.standard_normal(n).astype(np.float32)
        frames_n = tmel.num_frames(n, cfg)
        idx = ((0, 0, 0) if frames_n <= 1036 else tuple(
            int(r[-1]) for r in tmel.chunk_ranges(frames_n, 1036)))
        args = (wav, cfg, 1036, idx, -4.2677393, 4.5689974)
        got = tmel.audio_model_input(*args, device=cuda)
        torch.testing.assert_close(
            got.cpu(), torch.from_numpy(tmel.audio_model_input_host(*args)),
            atol=2e-3, rtol=1e-4)


def test_loader_batches_on_the_card_match_the_cpu(cuda, tmp_path):
    """A tiny mvsa tree through training_loader with the media loaders on
    the card and on the CPU: the same batches, the card's images there."""
    import argparse

    from PIL import Image

    from missm_tpu_torch.data.loaders import training_loader
    from missm_tpu_torch.data.missing import (generate_missing_index,
                                              save_missing_index)
    from missm_tpu_torch.data.preprocess import make_media_loaders
    from missm_tpu_torch.data.tokenizer import HashTokenizer

    rng = np.random.default_rng(10)
    (tmp_path / "data").mkdir()
    with open(tmp_path / "label.csv", "w") as f:
        f.write("ID,language,annotation,mode\n")
        for i in range(12):
            f.write(f"{i},text {i},{['a', 'b'][i % 2]},"
                    f"{'train' if i < 8 else 'valid'}\n")
            Image.fromarray(rng.integers(0, 256, (40 + i, 56, 3),
                                         dtype=np.uint8)).save(
                tmp_path / "data" / f"{i}.jpg")
    save_missing_index(str(tmp_path / "missing_index.pkl"),
                       generate_missing_index(
                           {"train": 8, "valid": 4, "test": 0},
                           ["language", "image"]))
    args = argparse.Namespace(datasetName="mvsa", fusion_type="sum",
                              train_missing=False, batch_size=3,
                              num_workers=3)
    towers = {"image": tiny_tower("image")}
    batches = {}
    for dev in (cuda, "cpu"):
        train, valid, n = training_loader(args, str(tmp_path / "label.csv"),
                                          HashTokenizer(99, 16),
                                          make_media_loaders(towers,
                                                             device=dev))
        batches[str(dev)] = list(train) + list(valid)
    assert n == 2 and len(batches["cpu"]) == 5
    for (gd, gl, gm), (cd, cl, cm) in zip(batches[str(cuda)],
                                          batches["cpu"]):
        assert gd["image"].device.type == "cuda"
        torch.testing.assert_close(gd["image"].cpu(), cd["image"],
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_array_equal(gd["language"]["input_ids"],
                                      cd["language"]["input_ids"])
        np.testing.assert_array_equal(gl, cl)
        np.testing.assert_array_equal(gm, cm)


def test_media_loaders_on_the_card_match_the_cpu(cuda, tmp_path):
    """make_media_loaders built for the card: image, depth and audio
    samples are tensors there, equal to the CPU-built loaders' within the
    transforms' limits."""
    import wave

    from PIL import Image

    from missm_tpu_torch.data.preprocess import make_media_loaders

    rng = np.random.default_rng(12)
    paths = {"image": str(tmp_path / "i.jpg"), "depth": str(tmp_path / "d.png"),
             "audio": str(tmp_path / "a.wav")}
    Image.fromarray(rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)).save(
        paths["image"])
    Image.fromarray(rng.integers(0, 12000, (60, 80), dtype=np.uint16)).save(
        paths["depth"])
    with wave.open(paths["audio"], "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.standard_normal(32000) * 4000).astype(
            "<i2").tobytes())
    towers = {m: tiny_tower(m) for m in paths}
    card = make_media_loaders(towers, device=cuda)
    cpu = make_media_loaders(towers, device="cpu")
    for m, path in paths.items():
        got, want = card[m](path), cpu[m](path)
        assert got.device.type == "cuda" and want.device.type == "cpu"
        tol = (dict(atol=2e-3, rtol=1e-4) if m == "audio"
               else dict(atol=2e-4, rtol=1e-4))
        torch.testing.assert_close(got.cpu(), want, **tol)


# ---------------------------------------------------------------------------
# The custom ops, the named remat policies and the serving artifact on the
# card
# ---------------------------------------------------------------------------


def _op_args(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)

    def t(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q, k, v, g = t(2, 257, 128), t(2, 257, 128), t(2, 257, 128), t(2, 257, 128)
    out, lse = kernels._launch(q, k, v, None, 2, causal=False, want_lse=True)
    sq, sk, sv, sg = t(37, 8, 128), t(37, 8, 128), t(37, 8, 128), t(37, 8, 128)
    x, w = t(128, 256), t(256, 512)
    gamma, beta, b = t(256), t(256), t(512)
    kb = _inputs(gen, 2, 257, 2, 64, dtype, True)[3]
    return {
        "attention": ((q, k, v, 2, True), "attention"),
        "attention_bwd": ((q, k, v, out, lse, g, 2), "attention_bwd"),
        "causal_attention": ((q, k, v, kb, 2), "causal_attention"),
        "short_attention": ((sq, sk, sv, 2), "short_attention"),
        "short_attention_bwd": ((sq, sk, sv, sg, 2), "short_attention_bwd"),
        "ln_linear": ((x, gamma, beta, w, b, 1e-5), "ln_linear")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["attention", "attention_bwd",
                                "causal_attention", "short_attention",
                                "short_attention_bwd", "ln_linear"])
def test_custom_op_launches_its_kernel_once(cuda, dtype, op):
    """A CUDA call of each `missm` op launches its hand kernel once, counted
    under the kernel's name, and its fake gives the real output's shapes
    and types."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args, counter = _op_args(cuda, dtype)[op]
    fn = getattr(torch.ops.missm, op).default
    kernels.reset_launches()
    real = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _counts(**{counter: 1})
    mode = FakeTensorMode()
    fakes = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
    with mode:
        fake = fn(*fakes)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype, f.device.type) for f in fake] == [
        (r.shape, r.dtype, r.device.type) for r in real]


def test_custom_op_raises_on_what_its_kernel_does_not_take(cuda):
    """No fall-back to the plain version: a head dim the kernels were not
    built for raises."""
    q = torch.randn(1, 9, 2 * 24, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        torch.ops.missm.attention(q, q, q, 2, False)


@pytest.mark.parametrize("policy", [True, "save_attn_mlp_qkv",
                                    "save_attn_mlp_qkv_kern", "save_most"])
def test_remat_policy_launches_on_the_card(cuda, policy):
    """The tiny image + text model's f32 gradients under a policy equal no
    remat's; the forward kernels run again in the backward exactly where
    the policy does not keep their output."""
    from missm_tpu_torch.train.step import compute_loss, partition_trainable

    cfg = finetune.ModelConfig(
        towers=(("image", tiny_tower("image", hidden_size=128, num_heads=2,
                                     intermediate_size=256)),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=16,
                            dropout_prob=0.0))
    params = finetune.init_model_params(cfg, seed=0, device=cuda)
    partition_trainable(params, cfg)
    gen = torch.Generator(device=cuda).manual_seed(1)
    data = {"language": torch.randint(1, 97, (4, 16), generator=gen,
                                      device=cuda),
            "image": torch.randn(4, 3, 32, 32, generator=gen, device=cuda)}
    labels = torch.tensor([0, 1, 2, 0], device=cuda)
    codes = torch.tensor([0, 1, 4, 0], device=cuda)

    def grads(remat):
        for t in leaves(params):
            t.grad = None
        kernels.reset_launches()
        loss, _ = compute_loss(params, None, _with_remat(cfg, remat), data,
                               labels, codes, None, device=cuda)
        loss.backward()
        torch.cuda.synchronize()
        return ([t.grad.clone() for t in leaves(params) if t.grad is not None],
                dict(kernels.LAUNCHES))

    ref, base = grads(False)
    got, launched = grads(policy)
    replay = policy is True or policy == "save_attn_mlp_qkv"
    want = dict(base, **{k: base[k] * (2 if replay else 1)
                         for k in ("attention_unsplit", "causal_attention")})
    assert launched == want
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def _with_remat(cfg, remat):
    import dataclasses

    return dataclasses.replace(cfg, remat=remat)


def test_artifact_on_the_card_equals_the_predictor(cuda, tmp_path):
    """The tiny model exported on the card: preds equal the Predictor's,
    probs within 1e-6, and its kernels launch from the loaded program."""
    from missm_tpu_torch.eval.artifact import export_artifact, load_artifact
    from missm_tpu_torch.eval.predictor import Predictor

    cfg = finetune.ModelConfig(
        towers=(("image", tiny_tower("image")),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=16))
    params = finetune.init_model_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 97, (4, 16)).astype(np.int32)
    ids[:, 9] = 98
    data = {"language": {"input_ids": ids, "attention_mask":
                         (np.arange(16)[None] <= 9).repeat(4, 0)
                         .astype(np.int32)},
            "image": rng.integers(0, 256, (4, 3, 32, 32)).astype(np.uint8)}
    export_artifact(params, cfg, data, str(tmp_path))
    art = load_artifact(str(tmp_path))
    codes = np.array([0, 1, 4, 0], np.int32)
    kernels.reset_launches()
    preds, probs = art.predict_arrays(data, codes)
    torch.cuda.synchronize()
    layers = cfg.towers[0][1].vision.num_layers
    assert kernels.LAUNCHES == _counts(attention_unsplit=layers,
                                       causal_attention=layers)
    want_preds, want_probs = Predictor(params, cfg, batch_size=4,
                                       device=cuda).predict_arrays(data, codes)
    np.testing.assert_array_equal(preds, want_preds)
    np.testing.assert_allclose(probs, want_probs, atol=1e-6, rtol=0)
