"""The arithmetic the metric readers (metrics/<name>.py) share. Each returns
None where the run has nothing for it to read: another kind of traffic, or
an untraced run. Model FLOP and attention calls are counted by the
configuration's model family (counts/<family>.py)."""
from __future__ import annotations

from .counts.flops import BF16_FLOP_PER_S, forward_flop, train_flop
from .harness import family
from .spans import readings


def device_idle(ctx, kind):
    """Per cent of the traced window in which no operation ran on the
    device."""
    if ctx.kind != kind or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx, kind):
    """Model FLOP of the untraced window's completed rows or samples over
    its seconds, in per cent of the dense bf16 peak."""
    if ctx.kind != kind:
        return None
    products = family(ctx.cfg, "counts").products(ctx.cfg)
    per = forward_flop(products) if kind == "sweep" else train_flop(products)
    return 100.0 * ctx.work * per / ctx.seconds / BF16_FLOP_PER_S


def attn_roofline(ctx, kind):
    """Per cent: the attention calls' least time (counts.flops.AttnCall)
    over the device time of the port's attention kernels, in the traced
    window's batches or steps."""
    if ctx.kind != kind or ctx.trace is None or not ctx.trace.attention_s:
        return None
    calls = family(ctx.cfg, "counts").attention_calls(ctx.cfg, ctx.batch,
                                                      kind == "train")
    bound = sum(c.bound_s for c in calls)
    return 100.0 * bound * ctx.units / ctx.trace.attention_s


def launches(ctx, kind):
    """Launch calls on the host a batch or step of the traced window."""
    if ctx.kind != kind or ctx.trace is None or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.units


def span_reading(ctx, kind, name):
    """spans.readings' `name`: a batch's or step's share of a `missm.*` span
    or counter of the port in the traced window."""
    if ctx.kind != kind or ctx.spans is None:
        return None
    return readings(kind, ctx.spans[0], ctx.counters or {}, ctx.units)[name]
