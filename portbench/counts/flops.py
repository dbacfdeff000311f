"""The yardstick's arithmetic: model FLOP from a configuration's shapes, the
bytes and FLOP of an attention call, and the card's peaks. Nothing here
reads the port: every number follows from a configs/*.json dict. The
products and attention calls of a configuration are its model family's
(counts/<family>.py, `products(cfg)` and `attention_calls(cfg, batch,
train)`), by the rules below.

Model FLOP (the `mfu` metrics):
- every matrix product costs 2 m n k in the forward;
- in training, every product a gradient flows through adds 2 m n k for its
  input gradient, and a product whose weight trains adds 2 m n k for its
  weight gradient; a frozen weight adds none, and the pixels and the token
  ids take none;
- attention costs 2 x 2 N^2 d a layer (the score and the value products),
  counting only the key pairs the data needs: keys at or before the query
  under the causal mask, T x T pairs in the temporal attention; its
  training adds twice that (both inputs of both products);
- recomputation is never counted.

Attention bound (the `attn_roofline` metrics, as chip_smoke.py's `bound`):
the least time of a call is the larger of its bytes over the memory rate
and its FLOP over the bf16 rate, each input byte read once and each output
byte written once.
"""
from __future__ import annotations

from dataclasses import dataclass

# H100 SXM data-sheet peaks at its 700 W limit: dense bf16 tensor-core rate
# and device-memory rate.
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Product:
    """One kind of matrix product: `count` of [m, k] @ [k, n] per row or
    sample. `x_grad`: a gradient flows to its input; `w_grad`: its weight
    trains (an activation-by-activation product has both inputs, counted
    as x_grad twice: `inputs` = 2)."""
    name: str
    m: int
    k: int
    n: int
    count: int
    x_grad: bool
    w_grad: bool
    inputs: int = 1

    @property
    def forward(self) -> int:
        return 2 * self.m * self.k * self.n * self.count

    @property
    def backward(self) -> int:
        return self.forward * (self.inputs * self.x_grad + self.w_grad)


def forward_flop(products) -> int:
    """Model FLOP of one row's forward, of its `products`."""
    return sum(p.forward for p in products)


def train_flop(products) -> int:
    """Model FLOP of one sample's training, forward and backward, of its
    `products`."""
    return sum(p.forward + p.backward for p in products)


# ---------------------------------------------------------------------------
# Attention calls
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnCall:
    """One attention kernel call over `batch` instances of `n` tokens,
    `heads` heads of `head_dim`, bf16 operands. kind: "forward" (out, and
    the log-sum-exp with `lse`), "backward" (dq, dk, dv from q, k, v, out,
    dO and the log-sum-exp), "short" / "short_backward" (the temporal
    kernels, which keep no log-sum-exp)."""
    kind: str
    batch: int
    n: int
    heads: int
    head_dim: int
    causal: bool = False
    kbias: bool = False
    lse: bool = False

    @property
    def pairs(self) -> int:
        return self.n * (self.n + 1) // 2 if self.causal else self.n * self.n

    @property
    def flop(self) -> int:
        per = 4 * self.batch * self.heads * self.pairs * self.head_dim
        return 2 * per if self.kind in ("backward", "short_backward") else per

    @property
    def bytes(self) -> int:
        t = self.batch * self.n * self.heads * self.head_dim * 2   # a tensor
        lse = self.batch * self.heads * self.n * 4
        if self.kind == "forward":
            return (4 * t + (self.batch * self.n * 4 if self.kbias else 0)
                    + (lse if self.lse else 0))
        if self.kind == "backward":
            return 8 * t + lse
        if self.kind == "short":
            return 4 * t
        return 7 * t                                            # short_backward

    @property
    def bound_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.flop / BF16_FLOP_PER_S)

