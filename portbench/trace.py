"""Reading a torch.profiler trace of the traced window.

From the kineto events of one `torch.profiler.profile` over whole batches or
steps this takes:
- busy_s: the union of the device operations' intervals (kernels, copies,
  sets), so that overlapping operations count once;
- each device operation's time by name;
- the attention kernels' time, found by the port's kernel symbols;
- the launch calls on the host: cudaLaunchKernel*, cuLaunchKernel* and
  cudaGraphLaunch, each counted once;
- the idle gaps between device operations, each named by the host event
  under way at the gap's middle that started last, on any thread (the
  window's own, the autograd engine's).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

ATTENTION_KERNELS = re.compile(
    r"\b(attention_bf16|attention_f32|attention_bwd_\w+|short_attention"
    r"|short_attention_bwd)\b")
LAUNCH_CALLS = re.compile(r"^(cudaLaunchKernel\w*|cuLaunchKernel\w*"
                          r"|cudaGraphLaunch\w*)$")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Summary:
    window_s: float
    busy_s: float = 0.0
    device_ops: dict = field(default_factory=dict)   # name -> seconds
    attention_s: float = 0.0
    attention_kernels: int = 0
    kernels: int = 0
    launches: int = 0
    launch_names: dict = field(default_factory=dict)  # call -> count
    idle_gaps: dict = field(default_factory=dict)    # host activity -> s


def _union(intervals):
    total, end = 0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def _gaps(intervals):
    """The idle gaps between the merged intervals, (start, end) in ns."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def _innermost(events, points):
    """For each time in `points` (sorted), (start, name) of the innermost
    event of `events` (one thread's, which nest) under way then, or None."""
    evs = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events)
    out, stack, j = [], [], 0
    for t in points:
        while j < len(evs) and evs[j][0] <= t:
            while stack and stack[-1][1] <= evs[j][0]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append((stack[-1][0], stack[-1][2]) if stack else None)
    return out


def _host_names(events, gaps):
    """(name, ns) of each gap: of the host events under way at its middle on
    any thread (the window's, the autograd engine's), the one that started
    last, or "no host event"."""
    gaps = sorted(gaps, key=lambda g: g[0] + g[1])
    points = [(gs + ge) // 2 for gs, ge in gaps]
    threads = {}
    for e in events:
        threads.setdefault(e.start_thread_id(), []).append(e)
    found = [_innermost(evs, points) for evs in threads.values()]
    names = []
    for k, (gs, ge) in enumerate(gaps):
        under_way = [f[k] for f in found if f[k] is not None]
        names.append((max(under_way)[1] if under_way else "no host event",
                      ge - gs))
    return names


WINDOW_SPAN = "portbench.window"


def _device_kind(e, host_names):
    """kernel, gpu_memcpy, gpu_memset or gpu_user_annotation: the event's
    activity type where the profiler gives it, else from its name (a
    device-side annotation bears the name of a host-side event)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "gpu_user_annotation" if name in host_names else "kernel"


def summarise(prof, window_s: float) -> Summary:
    """Summary of the profile `prof` of a window `window_s` long."""
    events = prof.profiler.kineto_results.events()
    out = Summary(window_s=window_s)
    device, host = [], []
    annotations = {e.name() for e in events
                   if not str(e.device_type()).endswith("CUDA")}
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            kind = _device_kind(e, annotations)
            if kind not in DEVICE_KINDS:
                continue
            device.append((e.start_ns(), e.end_ns()))
            name = e.name()
            dur = e.duration_ns() * 1e-9
            out.device_ops[name] = out.device_ops.get(name, 0.0) + dur
            if kind == "kernel":
                out.kernels += 1
                if ATTENTION_KERNELS.search(name):
                    out.attention_s += dur
                    out.attention_kernels += 1
        else:
            host.append(e)
            if LAUNCH_CALLS.match(e.name()):
                out.launches += 1
                out.launch_names[e.name()] = \
                    out.launch_names.get(e.name(), 0) + 1
    out.busy_s = _union(device) * 1e-9
    for name, ns in _host_names(host, _gaps(device)):
        out.idle_gaps[name] = out.idle_gaps.get(name, 0.0) + ns * 1e-9
    return out


def top(d: dict, n: int = 10, width: int = 120):
    """The n largest entries of {name: seconds} as [[name, seconds], ...]."""
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
