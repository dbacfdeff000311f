"""The yardstick's arithmetic: model FLOP from a configuration's shapes, the
attention calls a batch or step makes with their bytes and FLOP, and the
card's peaks. Nothing here reads the port: every number follows from a
configs/*.json dict.

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


def _vision_products(mod, v, proj):
    d, f, L = v["hidden_size"], v["intermediate_size"], v["num_layers"]
    ps, c = v["patch_size"], v["num_channels"]
    gh, gw = v["image_size"][0] // ps, v["image_size"][1] // ps
    n = gh * gw + 1
    time = bool(v.get("add_time_attn"))
    T = v.get("num_frames", 1) if time else 1
    r = v["lora_r"]
    rows = T * n                      # tokens a sample
    out = [Product(f"{mod}.patch", T * (n - 1), c * ps * ps, d, 1,
                   False, True),
           Product(f"{mod}.qkvo", rows, d, d, 4 * L, True, False),
           Product(f"{mod}.fc1", rows, d, f, L, True, False),
           Product(f"{mod}.fc2", rows, f, d, L, True, False),
           # scores and values: per frame, N x N pairs of head dims summing
           # to d (2 x 2 N^2 d a layer and frame)
           Product(f"{mod}.attn", T * n, d, n, 2 * L, True, False, inputs=2),
           Product(f"{mod}.proj", 1, d, proj, 1, True, True)]
    if time:
        out += [Product(f"{mod}.tqkvo", rows, d, d, 4 * L, True, False),
                Product(f"{mod}.tattn", n * T, d, T, 2 * L, True, False,
                        inputs=2)]
    if r:
        # peft's branch (x A) B on the LoRA'd projections
        out += [Product(f"{mod}.lora_a", rows, d, r, 4 * L, True, True),
                Product(f"{mod}.lora_b", rows, r, d, 4 * L, True, True)]
    return out


def _text_products(t, proj):
    d, f, L = t["hidden_size"], t["intermediate_size"], t["num_layers"]
    n = t["max_position_embeddings"]
    pairs = n * (n + 1) // 2          # causal: keys at or before the query
    return [Product("text.qkvo", n, d, d, 4 * L, True, True),
            Product("text.fc1", n, d, f, L, True, True),
            Product("text.fc2", n, f, d, L, True, True),
            # 2 x 2 x pairs x d a layer: m k n = pairs d
            Product("text.attn", pairs, d, 1, 2 * L, True, False, inputs=2),
            Product("text.proj", 1, d, proj, 1, True, True)]


def _head_products(fu, modalities):
    fd = fu["fusion_dim"]
    return [Product("head.proj", 1, fu["feature_dims"], fd, len(modalities),
                    True, True),
            Product("head.fc1", 1, fd, fd, 1, True, True),
            Product("head.fc2", 1, fd, fu["output_dims"], 1, True, True)]


def products(cfg):
    """Every matrix product of one row or sample of config `cfg`."""
    proj = cfg["projection_dim"]
    out = []
    for mod, v in cfg["towers"]:
        out += _vision_products(mod, v, proj)
    out += _text_products(cfg["text"], proj)
    out += _head_products(cfg["fusion"], cfg["modality_types"])
    return out


def forward_flop(cfg) -> int:
    """Model FLOP of one row's forward."""
    return sum(p.forward for p in products(cfg))


def train_flop(cfg) -> int:
    """Model FLOP of one sample's training: forward and backward."""
    return sum(p.forward + p.backward for p in products(cfg))


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


def attention_calls(cfg, batch: int, train: bool):
    """The port's attention kernel calls of one batch of `batch` rows: the
    vision towers' spatial attention, the temporal attention and the text
    tower's causal attention forward; in training also the backward
    kernels (the causal attention's backward is plain PyTorch in the port,
    so it has none)."""
    calls = []
    for _, v in cfg["towers"]:
        ps = v["patch_size"]
        n = (v["image_size"][0] // ps) * (v["image_size"][1] // ps) + 1
        h, hd = v["num_heads"], v["hidden_size"] // v["num_heads"]
        L = v["num_layers"]
        T = v.get("num_frames", 1) if v.get("add_time_attn") else 1
        calls += [AttnCall("forward", batch * T, n, h, hd, lse=train)] * L
        if train:
            calls += [AttnCall("backward", batch * T, n, h, hd)] * L
        if v.get("add_time_attn"):
            calls += [AttnCall("short", batch * n, T, h, hd)] * L
            if train:
                calls += [AttnCall("short_backward", batch * n, T, h, hd)] * L
    t = cfg["text"]
    calls += [AttnCall("forward", batch, t["max_position_embeddings"],
                       t["num_heads"], t["hidden_size"] // t["num_heads"],
                       causal=True, kbias=bool(cfg.get("text_attention_mask")))
              ] * t["num_layers"]
    return calls
