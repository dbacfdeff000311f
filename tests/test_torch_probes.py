"""The timing probes' attention (missm_tpu_torch.kernels.probe_attention,
P1-P4) and stacks (missm_tpu_torch.probes.attn_probe and .ablation_probe)
against the scripts' own JAX functions, on the CPU.

scripts/attn_probe.py and scripts/ablation_probe.py are loaded by path as
modules of their own. Their Pallas kernels run in interpret mode:
`jax.experimental.pallas.pallas_call` is wrapped with interpret=True, and
the scripts' shape globals are shrunk (attn_probe.BH = 8; ablation_probe's
cfg, B, N, D and H to a tower of width 128, 2 heads of 64, 17 tokens and
B = 2), both through monkeypatch. The wrapper also keeps each kernel the
stacks build, so that it runs alone on kernel-level inputs as well. The
port's wrappers run their plain versions on CPU tensors. Inputs are made
with numpy from a seed.

Tolerances:
- f32 (P1, P2 and P4 nostage keep the input type throughout): the two
  differ in summation order only, |err| <= 1e-5 + 1e-5 |ref|.
- bf16, one kernel: both round P to bf16 at the same point and the output
  once; an f32 sum taken in another order can round to the neighbouring
  bf16 value, so |err| <= 2^-7 |ref| (one output ulp) + 2^-10 (an output
  near 0, a sum of 257 terms, moved by up to 2.7e-4 over 12 seeds). And
  ||err|| / ||ref|| <= 2^-10, which pins the rounding point: measured
  6e-5 to 7e-5 against 2.7e-3 to 3.0e-3 for P rounded in the other order
  (normalised before rounding for P4, after P.V for P1-P3).
- noexp's denominator sum(s - m) is <= 0 and 0 for a row of equal scores,
  so its inputs have scores that vary along every row and it is compared
  relatively, ||err|| / ||ref|| <= 2^-8.
- bf16 stacks of 2 blocks: the JAX package and the port round the
  projections, LayerNorm and the MLP at their own places (as
  tests/test_torch_model.py's bf16 towers), ||err|| / ||ref|| <= 2e-2.
JAX's production arm make_tower("fused") is not run here: fused_attention
passes its own interpret=; the port's production stack is held against
make_tower("einsum"), the same function.
"""
import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from missm_tpu.models.tower import init_vision_params
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.kernels import probe_attention as pa
from missm_tpu_torch.kernels.launches import LAUNCHES, reset_launches
from missm_tpu_torch.probes import ablation_probe, attn_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2 ** -10, rtol=2 ** -7)
BF16_NORM = 2 ** -10
NOEXP_RTOL = 2 ** -8
STACK_RTOL = 2e-2
B, N, D, H = 2, 17, 128, 2      # the shrunk stacks


@pytest.fixture
def scripts(monkeypatch):
    """(attn_probe, ablation_probe, built): the two scripts as fresh
    modules with pallas_call in interpret mode and their globals shrunk,
    and the list of every pallas_call they build, in order."""
    built = []
    original = jpl.pallas_call

    def interpret(*args, **kwargs):
        call = original(*args, interpret=True, **kwargs)
        built.append(call)
        return call

    monkeypatch.setattr(jpl, "pallas_call", interpret)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the scripts add to it
    mods = []
    for name in ("attn_probe", "ablation_probe"):
        spec = importlib.util.spec_from_file_location(
            f"_script_{name}_under_test", os.path.join(REPO, "scripts",
                                                       f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    attn, abl = mods
    monkeypatch.setattr(attn, "BH", 8)
    monkeypatch.setattr(abl, "cfg", dataclasses.replace(
        abl.cfg, hidden_size=D, intermediate_size=2 * D, num_layers=2,
        num_heads=H, image_size=(16, 16), patch_size=4))
    for name, value in (("B", B), ("N", N), ("D", D), ("H", H)):
        monkeypatch.setattr(abl, name, value)
    return attn, abl, built


def _port_cfg():
    return tiny_tower("image", hidden_size=D, intermediate_size=2 * D,
                      num_heads=H, image_size=(16, 16), patch_size=4).vision


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _rel(got, ref):
    return np.linalg.norm(_np(got) - _np(ref)) / np.linalg.norm(_np(ref))


def _assert_close(got, ref, tag):
    """The module's f32 or bf16 tolerance for one kernel's output."""
    np.testing.assert_allclose(_np(got), _np(ref),
                               **(F32 if tag == "f32" else BF16))
    if tag == "bf16":
        assert _rel(got, ref) <= BF16_NORM, _rel(got, ref)


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("group", [1, 4])
def test_p1_matches_make_fused(scripts, group, tag):
    attn, _, built = scripts
    tdt, jdt = DTYPES[tag]
    rng = np.random.default_rng(group)
    arrays = [rng.standard_normal((attn.BH, attn.N, attn.D)) for _ in range(3)]
    ref = attn.make_fused(group)(*(_jax(a, jdt) for a in arrays))
    assert len(built) == 1
    reset_launches()
    got = pa.attn_probe_fused(*(_torch(a, tdt) for a in arrays))
    assert got.dtype == tdt and got.shape == (attn.BH, attn.N, attn.D)
    _assert_close(got, ref, tag)
    assert sum(LAUNCHES.values()) == 0  # the CPU runs the plain version


@pytest.mark.parametrize("name,tag", [("einsum_attn", "f32"),
                                      ("einsum_attn", "bf16"),
                                      ("einsum_attn_bf16sm", "bf16")])
def test_einsum_baselines_match_the_script(scripts, name, tag):
    """The probe's torch einsum baselines against the script's (the bf16
    logits form asks for bf16 scores whatever its input, so it runs in its
    own type only). It rounds the scores, the softmax and P.V in bf16, at
    other points in each framework: ||err|| / ||ref|| <= 2^-6 there."""
    attn, _, _ = scripts
    tdt, jdt = DTYPES[tag]
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((attn.BH, attn.N, attn.D)) for _ in range(3)]
    ref = getattr(attn, name)(*(_jax(a, jdt) for a in arrays))
    got = getattr(attn_probe, name)(*(_torch(a, tdt) for a in arrays))
    assert got.dtype == tdt
    if name == "einsum_attn_bf16sm":
        assert _rel(got, ref) <= 2 ** -6
    else:
        _assert_close(got, ref, tag)


# The stacks' kernels: (the script's stack maker, its arguments, the port's
# wrapper on kernel-level inputs, whether the JAX kernel keeps f32 input in
# f32)
ROUTES = {
    "P2 group=1": ("make_tower_bhne", (1,), pa.tower_bhne, True),
    "P2 group=2": ("make_tower_bhne", (2,), pa.tower_bhne, True),
    "P3": ("make_tower_scratch", (), lambda q, k, v:
           pa.tower_scratch(q, k, v, H), False),
    **{f"P4 {mode}": ("make_tower_packed_debug", (mode,),
                      lambda q, k, v, mode=mode:
                      pa.tower_packed_debug(q, k, v, H, mode),
                      mode == "nostage")
       for mode in pa.MODES},
}


def _params(abl, seed=0):
    """The shrunk tower's params in bf16 as a numpy tree (the scripts'
    dtype), biases and LayerNorm affines drawn at random so that their
    rounding shows; and x [B, N, D]."""
    tree = jax.tree_util.tree_map(np.asarray, init_vision_params(
        jax.random.PRNGKey(seed), abl.cfg, dtype=jnp.bfloat16))
    rng = np.random.default_rng(seed)
    blocks = tree["blocks"]
    for group in ("attn", "mlp"):
        for p in blocks[group].values():
            p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(
                p["b"].dtype)
    for ln in ("ln1", "ln2"):
        for key, shift in (("scale", 1.0), ("bias", 0.0)):
            a = blocks[ln][key]
            blocks[ln][key] = (shift + rng.standard_normal(a.shape)
                               * 0.1).astype(a.dtype)
    return tree, rng.standard_normal((B, N, D))


def _kernel_inputs(route, seed):
    rng = np.random.default_rng(seed)
    shape = (B, H, N, D // H) if route.startswith("P2") else (B, N, D)
    return [rng.standard_normal(shape) for _ in range(3)]


@pytest.mark.parametrize("route,tag", [
    (route, tag) for route, spec in ROUTES.items() for tag in DTYPES
    if tag == "bf16" or spec[3]])  # P3 and staged P4 stage through bf16
def test_stack_kernel_alone_matches_the_script(scripts, route, tag):
    _, abl, built = scripts
    maker, args, wrapper, _ = ROUTES[route]
    tdt, jdt = DTYPES[tag]
    tree, x = _params(abl)
    # traced in the test's type: the kernel's out_shape takes q's
    jax.eval_shape(getattr(abl, maker)(*args),
                   jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree),
                   _jax(x, jdt))
    assert len(built) == 1  # the scan traces its block once
    arrays = _kernel_inputs(route, seed=3)
    ref = built[0](*(_jax(a, jdt) for a in arrays))
    got = wrapper(*(_torch(a, tdt) for a in arrays))
    assert got.dtype == tdt and got.shape == ref.shape
    if route == "P4 noexp":
        assert _rel(got, ref) <= NOEXP_RTOL
    else:
        _assert_close(got, ref, tag)


STACKS = {
    "identity": (("make_tower", ("identity",)),
                 lambda bl, x, c: ablation_probe.tower(bl, x, c, "identity")),
    "production (einsum)": (("make_tower", ("einsum",)),
                            lambda bl, x, c: ablation_probe.tower(
                                bl, x, c, "production")),
    "P2 bhne": (("make_tower_bhne", (1,)), ablation_probe.tower_bhne),
    "P3 scratch": (("make_tower_scratch", ()), ablation_probe.tower_scratch),
    **{f"P4 {mode}": (("make_tower_packed_debug", (mode,)),
                      lambda bl, x, c, mode=mode:
                      ablation_probe.tower_packed_debug(bl, x, c, mode))
       for mode in pa.MODES},
}


@pytest.mark.parametrize("stack", STACKS)
def test_stack_matches_the_script(scripts, stack):
    _, abl, _ = scripts
    (maker, args), port = STACKS[stack]
    tree, x = _params(abl, seed=1)
    ref = getattr(abl, maker)(*args)(
        jax.tree_util.tree_map(jnp.asarray, tree), _jax(x, jnp.bfloat16))
    blocks = from_jax(tree, device="cpu")["blocks"]
    reset_launches()
    with torch.no_grad():
        got = port(blocks, _torch(x, torch.bfloat16), _port_cfg())
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, D)
    assert np.isfinite(_np(got)).all()
    assert _rel(got, ref) <= STACK_RTOL, _rel(got, ref)
    assert sum(LAUNCHES.values()) == 0


def test_nostage_is_full_and_modes_differ():
    """nostage computes full's function; each knock-out another one."""
    rng = np.random.default_rng(5)
    q, k, v = (_torch(rng.standard_normal((2, 9, 128)), torch.float32)
               for _ in range(3))
    outs = {m: pa.packed_attention_plain(q, k, v, 2, m) for m in pa.MODES}
    assert torch.equal(outs["nostage"], outs["full"])
    for mode in ("noexp", "dotsonly"):
        assert not torch.allclose(outs[mode], outs["full"], atol=1e-3)
    # full is softmax attention, the function P1-P3 compute in f32
    torch.testing.assert_close(
        outs["full"], pa.rows_attention_plain(q, k, v, layout="tokens",
                                              num_heads=2),
        atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        pa.packed_attention_plain(q, k, v, 2, "nodots")
    with pytest.raises(ValueError):
        pa.rows_attention_plain(q, k, v, layout="bnhd")


def _no_events(monkeypatch, module):
    """event_ms without CUDA: each call runs fn 2 + runs times and reads
    1 ms; returns the list of calls made."""
    calls = []

    def fake(fn, runs, warmup=2):
        for _ in range(warmup + runs):
            fn()
        calls.append(runs)
        return [1.0] * runs

    monkeypatch.setattr(module, "event_ms", fake)
    return calls


def test_ablation_probe_runs_every_arm_on_the_cpu(monkeypatch):
    calls = _no_events(monkeypatch, ablation_probe)
    reset_launches()
    res = ablation_probe.run("cpu", runs=2, cfg=_port_cfg(), batch=B)
    assert list(res["ms"]) == list(ablation_probe.ARMS) and len(calls) == 8
    assert all(res["finite"].values())
    assert res["img_per_s"]["identity"] == B / 1.0 * 1e3
    # the arms that compute softmax attention agree after 2 bf16 blocks
    for arm in ("packed full", "packed nostage", "scratch", "bhne"):
        assert res["rel_err"][arm] <= STACK_RTOL, (arm, res["rel_err"])
    assert res["rel_err"]["production"] == 0.0
    assert res["rel_err"]["identity"] > STACK_RTOL
    assert all(d == {} for d in res["launches"].values())  # CPU: no kernels


def test_attn_probe_runs_on_the_cpu(monkeypatch):
    calls = _no_events(monkeypatch, attn_probe)
    q, k, v = attn_probe.make_inputs("cpu", bh=2)
    assert q.dtype == torch.bfloat16 and q.shape == (2, attn_probe.N,
                                                     attn_probe.HD)
    with torch.inference_mode():
        par = attn_probe.parity(q, k, v)
    errs = par["max_abs_err"]
    assert list(errs) == list(pa.ROWS) and max(errs.values()) == 0.0
    assert 0.0 < par["scale"] < 10.0
    ms = attn_probe.run(q, k, v, runs=3)
    assert len(ms) == 3 + len(pa.ROWS) and calls == [3] * len(ms)


# `plan` of the bf16 probe kernels: (kernel, query rows a block) per route
PLAN_ROUTES = {"P1/P2/P4 rows=64": ("rows", 64), "P1 rows=128": ("rows", 128),
               "P3": ("scratch", 64), "P4 nostage": ("nostage", 64)}
# the routes' limits, and 896: where 64 f32 score rows of N keys would
# outgrow a block's shared memory, which the nostage kernel must pass
PLAN_N = (1, 8, 15, 16, 17, 63, 64, 65, 127, 128, 129, 257, 320, 768, 769,
          *sorted(({pa.max_n(k, r) for k, r in PLAN_ROUTES.values()}
                   | {896}) - {None}),
          1025)


@pytest.mark.parametrize("n", PLAN_N)
@pytest.mark.parametrize("route", PLAN_ROUTES)
def test_probe_plan_fits_and_covers_n_once(route, n):
    """Each launch's shared memory is at most SMEM_LIMIT (232,448 bytes)
    exactly where N is at most the route's limit, and the limit is the
    largest N that fits (the whole-row and nostage kernels keep no score
    row: their bytes do not grow with N and they have no limit); the query
    tiles cover the N rows once and the key tiles the N keys once, each
    key tile as narrow as its keys allow (8: wgmma's N step, mma.sync's
    n)."""
    kernel, rows = PLAN_ROUTES[route]
    limit = pa.max_n(kernel, rows)
    p = pa.plan(n, kernel, rows, slices=3)
    if limit is None:
        assert p.smem_bytes == pa.plan(1, kernel, rows).smem_bytes
        assert p.smem_bytes <= pa.SMEM_LIMIT
    else:
        assert (p.smem_bytes <= pa.SMEM_LIMIT) == (n <= limit)
        assert pa.plan(limit, kernel, rows).smem_bytes <= pa.SMEM_LIMIT
        assert pa.plan(limit + 1, kernel, rows).smem_bytes > pa.SMEM_LIMIT
    height = rows if kernel == "rows" else pa.QUERY_ROWS
    assert [first for first, _ in p.rows] == list(range(0, n, height))
    assert sum(live for _, live in p.rows) == n
    assert all(0 < live <= height for _, live in p.rows)
    assert [first for first, _ in p.cols] == list(range(0, n, pa.KEYS))
    widths = [w for _, w in p.cols]
    assert all(w == pa.KEYS for w in widths[:-1])
    assert n <= sum(widths) < n + 8 and widths[-1] % 8 == 0
    assert p.grid == 3 * (1 if kernel == "scratch" else len(p.rows))
    assert p.passes == 2


def test_nostage_plan_holds_no_row():
    """The nostage kernel keeps no score row: its shared memory is the same
    constant (Q, the ring of key tiles, the barriers) at every N up to
    4096, so it has no N limit."""
    bytes_ = {pa.plan(n, "nostage").smem_bytes for n in range(1, 4097)}
    assert bytes_ == {pa.plan(1, "rows").smem_bytes} == {42_024}
    assert pa.max_n("nostage") is None


def test_probe_plan_at_the_probes_shape():
    """The figures csrc/probe_attention.cu's note gives at N = 257 and the
    limits the wrappers hold the kernels to."""
    assert pa.SCRATCH_MAX_N == 832 and pa.max_n("nostage") is None
    assert pa.max_n("rows") is None and pa.max_n("rows", 128) is None
    rows = pa.plan(257, "rows", 64, slices=1024)
    assert (rows.warpgroups, rows.grid, rows.smem_bytes) == (1, 5120, 42_024)
    assert rows.cols[-1] == (256, 8) and rows.rows[-1] == (256, 1)
    assert rows.scores == 2 * 5 * 64 * 264
    assert pa.plan(257, "rows", mode="dotsonly").scores == 5 * 64 * 264
    wide = pa.plan(257, "rows", 128, slices=1024)
    assert (wide.warpgroups, wide.grid, wide.smem_bytes) == (2, 3072, 50_216)
    p3 = pa.plan(257, "scratch", slices=1024)
    assert (p3.warpgroups, p3.grid, p3.smem_bytes) == (2, 1024, 103_464)
    assert pa.plan(768, "scratch").warpgroups == 2
    assert pa.plan(769, "scratch").warpgroups == 1
    ns = pa.plan(257, "nostage", slices=1024)
    assert (ns.warpgroups, ns.grid, ns.smem_bytes) == (1, 5120, 42_024)
    assert ns.cols[-1] == (256, 8) and ns.passes == 2
    with pytest.raises(ValueError):
        pa.plan(257, "rows", 32)
    with pytest.raises(ValueError):
        pa.plan(257, "packed")
    with pytest.raises(ValueError):
        pa.plan(257, mode="nodots")
