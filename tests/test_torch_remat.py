"""The named remat policies of the port (missm_tpu_torch/models/tower.py::
REMAT_POLICIES, and ops/basic.py::keep_contexts) against the JAX package's
(missm_tpu/models/tower.py::_block_forward's checkpoint policies).

For each of the nine policies, on the tiny image, text and video towers
(the temporal MLP off and on): the loss and the gradient of every leaf
against jax.grad of the JAX tower under the same policy, f32, atol 1e-5
(rtol 1e-5 beside it for the large sums);
what one block keeps for the backward (its input aside) is exactly the
values the policy names, read from the block's keeper
(ops/basic.py::_Keeper), and the attention ops run again in the
backward's recompute exactly where their output is not kept. An unknown
policy raises, as in the JAX package.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import tower as jtower
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.kernels import attention as kernels
from missm_tpu_torch.kernels import ln_linear as lnl
from missm_tpu_torch.models import tower as ttower
from missm_tpu_torch.ops import basic
from missm_tpu_torch.ops.basic import get_activation

POLICIES = tuple(ttower.REMAT_POLICIES)
TOWERS = ("image", "text", "video", "video_tmlp")
ATOL = 1e-5
RTOL = 1e-5  # f32 sums in another order: the text tower's position
#              embedding gradient sums every row's, up to |g| ~ 50
B = 2
BLOCK_TAGS = {  # the names a block of each tower produces
    "image": {"qkv", "attn_kernel_out", "attn_out", "mlp_wide",
              "mlp_wide_act", "act_sig"},
    "text": {"qkv", "attn_kernel_out", "attn_out", "mlp_wide",
             "mlp_wide_act", "act_sig"},
    "video": {"qkv", "attn_kernel_out", "attn_out", "mlp_wide",
              "mlp_wide_act", "act_sig", "tqkv", "tattn_kernel_out"},
}
BLOCK_TAGS["video_tmlp"] = BLOCK_TAGS["video"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redrawn(tree, seed):
    """Every zero/one-initialised leaf (biases, LoRA B, LN) redrawn, so that
    each reaches the output."""
    rng = np.random.default_rng(seed)

    def redraw(x):
        if np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if np.all(x == 1):
            return (1 + rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x

    return jax.tree_util.tree_map(redraw, tree)


@functools.lru_cache(maxsize=None)
def _case(tower):
    """(JAX config, port config, numpy params, numpy input, numpy output
    weights) of one tiny tower."""
    modality = "video" if tower.startswith("video") else "image"
    over = dict(temporal_mlp=True) if tower == "video_tmlp" else {}
    jcfg = jax_tiny_tower(modality, **over)
    tcfg = tiny_tower(modality, **over)
    tree = _redrawn(jax.tree_util.tree_map(np.asarray, jtower.init_tower_params(
        jax.random.PRNGKey(3), jcfg)), 4)
    rng = np.random.default_rng(5)
    if tower == "text":
        ids = rng.integers(1, 97, size=(B, 8)).astype(np.int32)
        ids[:, 5] = 98
        mask = np.ones((B, 8), np.int32)
        mask[0, 6:] = 0
        x = (ids, mask)
        params = tree["text"]
        tcfg, jcfg = tcfg.text, jcfg.text
    else:
        shape = (B, 3, 4, 32, 32) if modality == "video" else (B, 3, 32, 32)
        x = rng.standard_normal(shape).astype(np.float32)
        params = tree["vision"]
        tcfg, jcfg = tcfg.vision, jcfg.vision
    return jcfg, tcfg, params, x, rng.standard_normal(32).astype(np.float32)


def _jax_loss(params, jcfg, x, w, remat, text):
    if text:
        ids, mask = x
        _, pooled = jtower.text_features(params, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask), remat=remat)
    else:
        pooled = jtower.vision_features(params, jcfg, jnp.asarray(x),
                                        remat=remat)
    return jnp.sum(jnp.tanh(pooled) * w)


def _port_loss(params, tcfg, x, w, remat, text):
    if text:
        ids, mask = x
        _, pooled = ttower.text_features(params, tcfg, torch.from_numpy(ids),
                                         torch.from_numpy(mask), remat=remat)
    else:
        pooled = ttower.vision_features(params, tcfg, torch.from_numpy(x),
                                        remat=remat)
    return (torch.tanh(pooled) * torch.from_numpy(w)).sum()


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unstack(tree):
    """The JAX gradient tree with its [L, ...] block stacks as per-layer
    leaves, named as the port's list of blocks."""
    out = {}
    for path, a in _leaves(tree):
        if path.startswith("blocks/"):
            for i in range(a.shape[0]):
                out[f"blocks/{i}/{path[len('blocks/'):]}"] = np.asarray(a[i])
        else:
            out[path] = np.asarray(a)
    return out


@pytest.mark.parametrize("tower", TOWERS)
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_loss_and_grads_match_jax(policy, tower):
    """jax.grad of the JAX tower under `policy` against the port's loss and
    gradient of every leaf under the same policy."""
    jcfg, tcfg, params, x, w = _case(tower)
    text = tower == "text"
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss),
                     static_argnums=(1, 4, 5))(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        jax.tree_util.tree_map(jnp.asarray, x), jnp.asarray(w), policy, text)
    tp = from_jax(params, device="cpu")
    leaves = dict(_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    loss = _port_loss(tp, tcfg, x, w, policy, text)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss.detach()) == pytest.approx(float(jl), abs=ATOL)
    want = _unstack(jg)
    assert set(want) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def _block_run(tower, remat, monkeypatch):
    """One block of the tower's port params under `remat`, forward and
    backward: (the values kept [(name, op, tensor)], the attention ops run
    in the forward and in the backward by kind, the block's input)."""
    _, tcfg, params, x, _ = _case(tower)
    tp = from_jax(params, device="cpu")
    block = tp["blocks"][0]
    for _, t in _leaves(block):
        t.requires_grad_(True)
    rng = np.random.default_rng(9)
    text = tower == "text"
    T = 4 if tower.startswith("video") else 1
    n = 8 if text else tcfg.seq_len
    h = torch.from_numpy(rng.standard_normal(
        (B * T, n, tcfg.hidden_size)).astype(np.float32)).requires_grad_()
    kw = dict(num_heads=tcfg.num_heads, act=get_activation(tcfg.hidden_act),
              eps=tcfg.layer_norm_eps)
    if text:
        kb = torch.zeros(B, 1, n)
        kb[0, 0, 6:] = torch.finfo(torch.float32).min
        kw.update(causal=True, key_bias=kb)
    if T > 1:
        kw.update(time=(T, n),
                  lora_scaling=tcfg.lora_alpha / tcfg.lora_r)
    elif not text and tcfg.lora_r:
        kw.update(lora_scaling=tcfg.lora_alpha / tcfg.lora_r)

    kept = _recording_keeper(monkeypatch)
    calls = {"forward": [], "backward": []}
    phase = ["forward"]
    plain = kernels.attention_plain

    def counted(q, k, v, num_heads, *, causal=False, kbias=None, bias=None):
        kind = ("causal" if causal else
                "short" if q.shape[1] == T and T > 1 else "spatial")
        calls[phase[0]].append(kind)
        return plain(q, k, v, num_heads, causal=causal, kbias=kbias,
                     bias=bias)

    monkeypatch.setattr(kernels, "attention_plain", counted)
    out = ttower._block_forward(block, h, remat=remat, **kw)
    phase[0] = "backward"
    torch.autograd.grad(out.square().sum(),
                        [h] + [t for _, t in _leaves(block)])
    return kept, calls, h


def _recording_keeper(monkeypatch):
    """[(name, op, output)] of every op output a block's keeper keeps in
    the forward."""
    kept = []

    class Recording(basic._Keeper):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n = len(self.kept)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if len(self.kept) > n:
                kept.append((basic._NAME, func, self.kept[-1]))
            return out

    monkeypatch.setattr(basic, "_Keeper", Recording)
    return kept


def _storage_bytes(tensors):
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def _named_bytes(tower, names):
    """The bytes of the values `names` hold in one block of `tower`, f32."""
    _, tcfg, _, _, _ = _case(tower)
    text = tower == "text"
    T = 4 if tower.startswith("video") else 1
    n = 8 if text else tcfg.seq_len
    rows = B * T * n
    d, f, heads = (tcfg.hidden_size, tcfg.intermediate_size, tcfg.num_heads)
    mlps = 2 if tower == "video_tmlp" else 1
    size = {"qkv": 3 * rows * d, "tqkv": 3 * rows * d, "attn_out": rows * d,
            "mlp_wide": mlps * rows * f, "mlp_wide_act": mlps * rows * f,
            "act_sig": mlps * rows * f, "tattn_kernel_out": rows * d,
            # bias-free attention keeps its log-sum-exp [B*T, H, N] too
            "attn_kernel_out": rows * d + (0 if text else B * T * heads * n)}
    return 4 * sum(size[name] for name in names)


@pytest.mark.parametrize("tower", TOWERS)
@pytest.mark.parametrize("policy", POLICIES)
def test_block_keeps_the_named_values(policy, tower, monkeypatch):
    """What a block under `policy` keeps beside its input: the values the
    policy names that the block produces, each once, by their bytes (for
    save_most: the values of every region but mlp_wide and mlp_wide_act);
    and the forward attention ops run again in the backward exactly where
    their output is not kept."""
    kept, calls, h = _block_run(tower, policy, monkeypatch)
    produced = BLOCK_TAGS[tower]
    names = {name for name, _, _ in kept}
    if policy == "save_most":
        assert not names & {"mlp_wide", "mlp_wide_act"}
        assert produced - {"mlp_wide", "mlp_wide_act"} <= names
    else:
        want = set(ttower.REMAT_POLICIES[policy]) & produced
        assert names == want
        got = _storage_bytes([t for _, _, out in kept
                              for t in (out if isinstance(out, tuple)
                                        else (out,))])
        assert got == _named_bytes(tower, want)
    assert all(t.untyped_storage().data_ptr()
               != h.untyped_storage().data_ptr()
               for _, _, out in kept
               for t in (out if isinstance(out, tuple) else (out,)))
    saved = (set(ttower.REMAT_POLICIES[policy]) if policy != "save_most"
             else produced - {"mlp_wide", "mlp_wide_act"})
    spatial = "causal" if tower == "text" else "spatial"
    want_fwd = [spatial] if not tower.startswith("video") else [
        "short", spatial]
    assert calls["forward"] == want_fwd
    replay = ([] if tower.startswith("video") or "attn_kernel_out" in saved
              else [spatial])
    if tower.startswith("video"):
        replay = (([] if "tattn_kernel_out" in saved else ["short"])
                  + ([] if "attn_kernel_out" in saved else [spatial]))
    assert calls["backward"] == replay


@pytest.mark.parametrize("tower", TOWERS)
def test_full_remat_keeps_nothing_and_replays_every_attention(tower,
                                                              monkeypatch):
    kept, calls, _ = _block_run(tower, True, monkeypatch)
    assert kept == []
    assert calls["backward"] == calls["forward"]


def test_fused_ln2_fc1_output_is_mlp_wide(monkeypatch):
    """With FUSE_LN2_FC1 on, `missm::ln_linear` makes mlp_wide: a policy
    that keeps it keeps the op's output, and the gradient is that of the
    unfused block without remat."""
    monkeypatch.setattr(lnl, "FUSE_LN2_FC1", True)
    rng = np.random.default_rng(11)
    d, f = 128, 256
    block = ttower._init_block(torch.Generator().manual_seed(0), d, f, 2)
    leaves = [t.requires_grad_() for _, t in _leaves(block)]
    h = torch.from_numpy(rng.standard_normal((2, 8, d)).astype(
        np.float32)).requires_grad_()
    kw = dict(num_heads=2, act=get_activation("quick_gelu"), eps=1e-5)
    kept = _recording_keeper(monkeypatch)
    out = ttower._block_forward(block, h, remat="save_attn_mlp", **kw)
    got = torch.autograd.grad(out.square().sum(), [h] + leaves)
    assert ("mlp_wide", torch.ops.missm.ln_linear.default) in [
        (name, op) for name, op, _ in kept]
    monkeypatch.setattr(lnl, "FUSE_LN2_FC1", False)
    ref = torch.autograd.grad(
        ttower._block_forward(block, h, **kw).square().sum(), [h] + leaves)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_unknown_policy_raises():
    """An unknown name raises ValueError, as missm_tpu/models/tower.py:396
    does, before any work."""
    _, tcfg, params, x, w = _case("image")
    tp = from_jax(params, device="cpu")
    with pytest.raises(ValueError, match="unknown remat policy"):
        ttower._block_forward(tp["blocks"][0], torch.zeros(2, 5, 32),
                              remat="save_everything", num_heads=2,
                              act=get_activation("quick_gelu"), eps=1e-5)
    with pytest.raises(ValueError, match="save_atn"):
        ttower.vision_features(tp, tcfg, torch.from_numpy(x),
                               remat="save_atn")
    with pytest.raises(ValueError, match="unknown remat policy"):
        jtower.vision_features(jax.tree_util.tree_map(jnp.asarray, params),
                               jax_tiny_tower("image").vision,
                               jnp.asarray(x), remat="save_atn")


def test_policy_names_are_the_cli_and_jax_lists():
    from missm_tpu.compat.args import _REMAT_POLICIES as jax_names
    from missm_tpu_torch.compat.args import _REMAT_POLICIES
    assert set(POLICIES) == set(_REMAT_POLICIES) == set(jax_names)
