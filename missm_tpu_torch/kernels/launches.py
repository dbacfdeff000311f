"""One launch count per kernel of the port, under the name of the TPU kernel
(or route) it takes the place of. A wrapper adds one where it launches its
kernel and nowhere else, so a run can show that a path went through it."""
from __future__ import annotations

LAUNCHES = {"attention": 0, "attention_unsplit": 0, "attention_bwd": 0,
            "attention_unsplit_bwd": 0, "causal_attention": 0,
            "short_attention": 0, "short_attention_bwd": 0,
            "ln_linear": 0, "mlp_bwd_dx": 0,
            # the timing probes' kernels (csrc/probe_attention.cu), P1-P4
            "attn_probe_fused": 0, "tower_bhne": 0, "tower_scratch": 0,
            "tower_packed_debug": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
