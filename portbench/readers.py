"""The arithmetic the metric readers (metrics/<name>.py) share. Each returns
None where the run has nothing for it to read: another kind of traffic, or
an untraced run."""
from __future__ import annotations

from .counts.flops import (BF16_FLOP_PER_S, attention_calls, forward_flop,
                           train_flop)


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
    per = forward_flop(ctx.cfg) if kind == "sweep" else train_flop(ctx.cfg)
    return 100.0 * ctx.work * per / ctx.seconds / BF16_FLOP_PER_S


def attn_roofline(ctx, kind):
    """Per cent: the attention calls' least time (counts.flops.AttnCall)
    over the device time of the port's attention kernels, in the traced
    window's batches or steps."""
    if ctx.kind != kind or ctx.trace is None or not ctx.trace.attention_s:
        return None
    bound = sum(c.bound_s for c in attention_calls(ctx.cfg, ctx.batch,
                                                   kind == "train"))
    return 100.0 * bound * ctx.units / ctx.trace.attention_s


def launches(ctx, kind):
    """Launch calls on the host a batch or step of the traced window."""
    if ctx.kind != kind or ctx.trace is None or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.units
