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
from missm_tpu_torch.models import finetune
from missm_tpu_torch.models.fusion import FusionConfig

pytestmark = pytest.mark.cuda

# f32: the kernel and the plain version differ only in summation order.
# bf16: they round P at different places (the kernel rounds the
# unnormalised exponentials, the plain version the probabilities) and the
# output to bf16, whose ulp is 2^-7 of the value at most.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2 ** -7)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,hd", [(2, 257, 16, 64), (3, 77, 12, 64),
                                          (2, 16, 2, 16), (2, 33, 2, 128),
                                          (2, 70, 3, 48)])
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
    name = "attention" if mode == "attention" else "causal_attention"
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
    assert kernels.LAUNCHES == {"attention": 2, "causal_attention": 2}
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)

