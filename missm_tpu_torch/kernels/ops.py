"""The torch custom ops of the model path, namespace `missm`.

Importing this module registers them all: an exported program
(eval/artifact.py) names them and needs them registered to load. Each op's
CPU kernel is its plain PyTorch version and its CUDA kernel the hand kernel,
which raises on what it does not take and adds one to its count in
`LAUNCHES` at each launch, from an exported program too:

- `missm::attention` (K1, and K2 mode b by its route), with an optional
  log-sum-exp output, and its backward `missm::attention_bwd` (K3, K4
  unmasked): kernels/attention.py;
- `missm::causal_attention` (K2 mode a), its backward plain PyTorch;
- `missm::short_attention` (K2 mode c) and `missm::short_attention_bwd`
  (K4 block-diagonal);
- `missm::ln_linear` (K5), its backward plain PyTorch: kernels/ln_linear.py.

K6 (kernels/mlp_bwd.py) and the probes' kernels (kernels/probe_attention.py)
stay plain wrappers: only the probes call them, and nothing exports or
checkpoints them.
"""
from __future__ import annotations

from . import attention as _attention  # noqa: F401 (registers its ops)
from . import ln_linear as _ln_linear  # noqa: F401 (registers its op)

NAMESPACE = "missm"
OPS = ("attention", "attention_bwd", "causal_attention", "short_attention",
       "short_attention_bwd", "ln_linear")
