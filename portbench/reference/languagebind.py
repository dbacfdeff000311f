"""The LanguageBind family's plain reference: its towers, the `sum` fusion
head, the cross-entropy loss and Adam, in plain PyTorch on the tree of
reference/weights.py, whose `make_params`, `paths_of` and `trainable` it
exports as the family's weights. It imports nothing of the port.

It follows the published description: CLIP's pre-LN ViT-L/14 and text
transformers (quick-GELU, q scaled by head_dim ** -0.5, softmax attention,
the text tower's causal mask and padding mask, EOT pooling at the highest
token id), LanguageBind's video blocks (a per-frame temporal embedding, then
attention over the T frames of each token, pre-LN and residual, with the
LoRA there) and peft's LoRA branch, y = x W + b + s (x A) B with s = alpha / r.
Embeddings are L2-normalised; a non-language one is scaled by
exp(logit_scale). The head sums each present modality's projection, then
LayerNorm, Linear, ReLU, dropout, Linear.

Precision: "f32" computes everything in float32, products with TF32 off (the
reference). "fp8" is the control, a step below the configurations' bfloat16
encoder and float32 head: the encoder in float8 as a float8 step computes
it, the head in float32. Every encoder value the port holds in bfloat16 (a
product's, a LayerNorm's, an activation's, an attention's output, the
residual stream, the embeddings) is rounded to e4m3 and its gradient to
e5m2 (_Round8), and every product takes its operands in e4m3 and the
gradient reaching it in e5m2 (_Fp8MatMul), one scale per tensor, each
product summed in float32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.reference.weights import make_params, paths_of, trainable

CODES = {"language": 1, "video": 2, "audio": 3, "image": 4}
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _quantize(t, dtype, top):
    """t rounded to `dtype` under one scale for the tensor (its largest
    magnitude onto the type's largest), in float32."""
    s = t.abs().amax().clamp(min=1e-30) / top
    return (t / s).to(dtype).float() * s


class _Fp8MatMul(torch.autograd.Function):
    """a @ b as a float8 step computes it: the operands in e4m3, the
    gradient that reaches the product in e5m2, each product summed in
    float32. `b` is a weight [k, n] or has a's batch dimensions."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _quantize(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _quantize(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _quantize(g, torch.float8_e5m2, E5M2_MAX)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        else:
            db = torch.matmul(qa.transpose(-1, -2), qg)
        return da, db


class _Round8(torch.autograd.Function):
    """A value stored in float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _quantize(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, torch.float8_e5m2, E5M2_MAX)


def _same(t):
    return t


def _mm(precision):
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8MatMul.apply
    raise ValueError(f"precision {precision!r}")


class Model:
    """The reference model of config `cfg` (a configs/*.json dict) at
    `precision`."""

    def __init__(self, cfg, precision="f32"):
        self.cfg = cfg
        self.mm = _mm(precision)
        self.low = _Round8.apply if precision == "fp8" else _same
        self.r = _same          # the encoder's storage rounding while it runs

    # -- pieces ------------------------------------------------------------

    def lin(self, p, x, lora=None):
        y = self.mm(x, p["w"])
        if "b" in p:
            y = y + p["b"]
        if lora is not None and "lora_a" in p:
            y = y + self.mm(self.mm(x, p["lora_a"]), p["lora_b"]) * lora
        return self.r(y)

    def ln(self, p, x, eps):
        return self.r(F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps))

    def attention(self, p, x, heads, lora, causal=False, kbias=None):
        B, N, D = x.shape
        hd = D // heads

        def split(t):
            return t.reshape(B, N, heads, hd).transpose(1, 2)

        q = split(self.lin(p["q"], x, lora)) * hd ** -0.5
        k = split(self.lin(p["k"], x, lora))
        v = split(self.lin(p["v"], x, lora))
        s = self.mm(q, k.transpose(-1, -2))
        neg = torch.finfo(torch.float32).min
        if causal:
            s = s + torch.full((N, N), neg, device=x.device).triu(1)
        if kbias is not None:
            s = s + kbias[:, None]
        o = self.r(self.mm(torch.softmax(s, dim=-1), v))
        return self.lin(p["out"], o.transpose(1, 2).reshape(B, N, D), lora)

    def act(self, x):
        return self.r(x * torch.sigmoid(1.702 * x))

    def block(self, p, x, heads, eps, lora=None, causal=False, kbias=None,
              time=None):
        if time is not None:
            T, N = time
            D = x.shape[-1]
            x = self.r((x.reshape(-1, T, N, D)
                        + p["temporal_embedding"][:T][None, :, None])
                       .reshape(-1, N, D))
            h = self.ln(p["tln1"], x, eps)
            h = h.reshape(-1, T, N, D).transpose(1, 2).reshape(-1, T, D)
            h = self.attention(p["tattn"], h, heads, lora)
            x = self.r(x + h.reshape(-1, N, T, D).transpose(1, 2)
                       .reshape(-1, N, D))
            lora = None
        x = self.r(x + self.attention(p["attn"], self.ln(p["ln1"], x, eps),
                                      heads, lora, causal, kbias))
        h = self.ln(p["ln2"], x, eps)
        return self.r(x + self.lin(p["mlp"]["fc2"],
                                   self.act(self.lin(p["mlp"]["fc1"], h))))

    def vision(self, p, v, pixels):
        """pixels [B, C, H, W] or [B, C, T, H, W] -> pooled, projected
        features [B, projection]."""
        if pixels.dim() == 4:
            pixels = pixels[:, :, None]
        B, C, T, H, W = pixels.shape
        ps = v["patch_size"]
        gh, gw = H // ps, W // ps
        frames = pixels.transpose(1, 2).reshape(B * T, C, gh, ps, gw, ps)
        patches = frames.permute(0, 2, 4, 1, 3, 5).reshape(B * T, gh * gw,
                                                          C * ps * ps)
        x = self.r(self.mm(self.r(patches), p["patch_embedding"]["w"]))
        d = x.shape[-1]
        x = torch.cat([p["class_embedding"].expand(B * T, 1, d), x], dim=1)
        x = self.ln(p["pre_ln"], self.r(x + p["position_embedding"][None]),
                    v["layer_norm_eps"])
        lora = v["lora_alpha"] / v["lora_r"] if v["lora_r"] else None
        time = (T, x.shape[1]) if v.get("add_time_attn") else None
        for blk in p["blocks"]:
            x = self.block(blk, x, v["num_heads"], v["layer_norm_eps"], lora,
                           time=time)
        pooled = self.ln(p["post_ln"], x[:, 0], v["layer_norm_eps"])
        return pooled.reshape(B, T, d).mean(dim=1)

    def text(self, p, t, ids, mask):
        B, L = ids.shape
        ids = ids.long()
        x = self.r(p["token_embedding"][ids] + p["position_embedding"][:L][None])
        kbias = None
        if mask is not None:
            kbias = torch.where(mask[:, None, :] == 0,
                                torch.finfo(torch.float32).min, 0.0)
        for blk in p["blocks"]:
            x = self.block(blk, x, t["num_heads"], t["layer_norm_eps"],
                           causal=True, kbias=kbias)
        x = self.ln(p["final_ln"], x, t["layer_norm_eps"])
        return x[torch.arange(B, device=x.device), ids.argmax(dim=-1)]

    @staticmethod
    def l2(x):
        return x / x.square().sum(-1, keepdim=True).sqrt()

    # -- the model ---------------------------------------------------------

    def embeds(self, params, data):
        """The encoder's embeddings, at the model's precision (the head that
        reads them is float32 at every precision)."""
        enc, cfg = params["encoder"], self.cfg
        lang = data["language"]
        ids, mask = ((lang["input_ids"], lang.get("attention_mask"))
                     if isinstance(lang, dict) else (lang, None))
        self.r = self.low
        try:
            out = {"language": self.r(self.l2(self.r(self.mm(
                self.text(enc["language"]["text"], cfg["text"], ids, mask),
                enc["language"]["proj"]["w"]))))}
            for mod, v in cfg["towers"]:
                pooled = self.r(self.mm(self.vision(enc[mod]["vision"], v,
                                                    data[mod]),
                                        enc[mod]["proj"]["w"]))
                out[mod] = self.r(self.l2(pooled)
                                  * torch.exp(enc[mod]["logit_scale"]))
        finally:
            self.r = _same
        return out

    def logits(self, params, data, codes, drop_mask=None):
        """Class logits [B, classes]; `drop_mask` [B, fusion_dim] bool (the
        head's dropout, kept where True) in training, None in eval."""
        fu, cfg = params["fusion"], self.cfg["fusion"]
        e = self.embeds(params, data)
        total = 0.0
        for m in self.cfg["modality_types"]:
            y = self.lin(fu["proj"][m], e[m])
            total = total + torch.where((codes == CODES[m])[:, None], 0.0, y)
        h = torch.relu(self.lin(fu["head"]["fc1"],
                                self.ln(fu["norm"], total, 1e-5)))
        if drop_mask is not None:
            keep = 1.0 - cfg["dropout_prob"]
            h = torch.where(drop_mask, h / keep, 0.0)
        return self.lin(fu["head"]["fc2"], h)


def rows(data, sl):
    """The rows `sl` of a batch (a dict of tensors and dicts of tensors)."""
    return {k: rows(v, sl) if isinstance(v, dict) else v[sl]
            for k, v in data.items()}


def to_device(data, device):
    return {k: to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(v).to(device) for k, v in data.items()}


@torch.no_grad()
def eval_logits(model, params, data, codes, block):
    """Logits of every row of `data` (on the device of `params`), `block`
    rows at a time, in float32."""
    n = len(codes)
    with exact_f32():
        return torch.cat([model.logits(params, rows(data, slice(i, i + block)),
                                       codes[i:i + block])
                          for i in range(0, n, block)])


def train_steps(model, params, batches, lr, block, b1=0.9, b2=0.999,
                eps=1e-8):
    """Adam steps from `params` (updated in place), one per entry of
    `batches` ((data, labels, codes, drop_mask), on the device), the mean
    cross-entropy of each batch's rows summed over blocks of `block` rows.
    Returns (the loss of each step, each trainable leaf's first gradient,
    {path: trainable leaf}); frozen leaves take no gradient."""
    named = [(path, leaf) for path, leaf in paths_of(params) if trainable(path)]
    leaves = [leaf for _, leaf in named]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, first = [], None
    with exact_f32():
        for t, (data, labels, codes, drop) in enumerate(batches, start=1):
            B = len(labels)
            grads = [torch.zeros_like(p) for p in leaves]
            total = 0.0
            for i in range(0, B, block):
                sl = slice(i, i + block)
                for p in leaves:
                    p.requires_grad_(True)
                logits = model.logits(params, rows(data, sl), codes[sl],
                                      drop[sl])
                loss = F.cross_entropy(logits, labels[sl].long(),
                                       reduction="sum") / B
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
                for acc, g in zip(grads, gs):
                    if g is not None:
                        acc += g
                total += float(loss.detach())
                del logits, loss, gs
            losses.append(total)
            if first is None:
                first = [g.clone() for g in grads]
            with torch.no_grad():
                c1, c2 = 1 - b1 ** t, 1 - b2 ** t
                for p, g, mi, vi in zip(leaves, grads, m, v):
                    p.requires_grad_(False)
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.sub_(lr / c1 * mi / ((vi / c2).sqrt() + eps))
    return losses, first, dict(named)


def seeded_dropout(generator_seed, shape, keep, device):
    """The head's dropout masks of successive train steps: one
    torch.rand(shape) a step from a generator seeded `generator_seed` on
    `device`, kept where below `keep`."""
    gen = torch.Generator(device=device).manual_seed(generator_seed)
    while True:
        yield torch.rand(shape, generator=gen, device=device) < keep

