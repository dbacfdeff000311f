"""Separable image resampling matrices, after missm_tpu/ops/resize.py.

Each 1-D resample is a dense (out, in) weight matrix built on the host in
numpy (`resize_matrix`, the JAX package's code bit for bit, so both
packages resample with the same matrices); `ops.image_transforms` applies
a 2-D resize as two f32 products with them. Semantics match `torch.nn.functional.interpolate(...,
align_corners=False)`:
- 'bicubic' antialias matches torch's PIL-compatible AA kernel (a=-0.5);
  non-antialias bicubic uses torch's a=-0.75.
- antialias=True stretches the kernel by the scale factor when downsampling
  and renormalizes over in-range taps (the torch/PIL antialias algorithm).
- antialias=False clamps source indices at the border (torch's behavior).
"""
from __future__ import annotations

import numpy as np


def _cubic_kernel(x, a):
    ax = np.abs(x)
    w = np.where(
        ax <= 1, ((a + 2) * ax - (a + 3)) * ax * ax + 1,
        np.where(ax < 2, (((ax - 5) * ax + 8) * ax - 4) * a, 0.0))
    return w


def _linear_kernel(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_matrix(in_size: int, out_size: int, method: str = "bicubic",
                  antialias: bool = True, a: float | None = None) -> np.ndarray:
    """Dense (out_size, in_size) resampling matrix, float32.

    `a` (the Keys cubic constant) defaults to torch's convention: the
    antialias path is PIL-compatible (a=-0.5); the non-antialias path uses
    a=-0.75."""
    if a is None:
        a = -0.5 if antialias else -0.75
    if method == "bicubic":
        kernel, support = (lambda x: _cubic_kernel(x, a)), 2.0
    elif method == "bilinear":
        kernel, support = _linear_kernel, 1.0
    else:
        raise ValueError(method)

    scale = in_size / out_size
    # antialias only matters when downsampling
    kscale = scale if (antialias and scale > 1.0) else 1.0

    out = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        if antialias:
            # torch upsample-AA span: taps j in [center-S+0.5, center+S+0.5)
            # with center = scale*(i+0.5); weights normalized over the
            # in-range taps (aten _compute_weights_span). Also used for
            # upsampling (kscale == 1), as torch does with antialias=True.
            center = (i + 0.5) * scale
            lo = max(int(center - support * kscale + 0.5), 0)
            hi = min(int(center + support * kscale + 0.5), in_size)
            idx = np.arange(lo, hi)
            w = kernel((idx + 0.5 - center) / kscale)
            w = w / w.sum()
            np.add.at(out[i], idx, w)
        else:
            center = (i + 0.5) * scale - 0.5
            # torch non-antialias: fixed tap count, border-clamped indices
            base = int(np.floor(center))
            taps = np.arange(base - int(support) + 1, base + int(support) + 1)
            w = kernel(taps - center)
            s = w.sum()
            if s != 0:
                w = w / s
            taps = np.clip(taps, 0, in_size - 1)
            np.add.at(out[i], taps, w)
    return out


def short_side_resize_shape(h: int, w: int, size: int):
    """Target (H', W') scaling the short side to `size`, aspect preserved.

    The long side TRUNCATES: torchvision Resize(int) computes
    `int(size * long / short)` and pytorchvideo ShortSideScale floors —
    e.g. 240x320 -> (224, 298), not round()'s 299 (which would also
    shift the center-crop offset by one)."""
    if h <= w:
        return size, max(1, int(w * size / h))
    return max(1, int(h * size / w)), size

