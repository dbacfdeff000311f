"""Image / video / depth / thermal preprocessing, after
missm_tpu/ops/image_transforms.py.

The short-side resize + center crop (+ optional hflip) compose into one
pair of dense resampling matrices built on the host ([size, H] and
[size, W], `crop_resize_weights`), so each transform is two f32 products
on `device` followed by the normalise step. The JAX package pads the
source and the weight columns to a bucket shape to bound its XLA compiles;
the padded columns carry zero weight, so the port's eager transforms run
on the unpadded source and matrices with the same result.

The matrices stay in a bounded host cache and go to the device with each
call, next to the source (at 375x500 they are 0.8 MB of f32 against the
source's 0.56 MB of uint8), so the transforms hold no device memory
between calls however many source sizes a dataset has.

The products run in f32 at PyTorch's default matmul precision ('highest':
no TF32 on the card). The decode pool's threads may call the transforms at
the same time; each call's work goes to the current stream of its thread.

Reference semantics:
- image/thermal: ToTensor (/255) -> Resize(short side 224, bicubic,
  antialias) -> CenterCrop(224) -> Normalize(CLIP mean/std).
- video: /255 -> NormalizeVideo -> ShortSideScale(224, bilinear, no
  antialias) -> CenterCrop(224) -> RandomHorizontalFlip. Resize weights
  sum to 1 per output row, so normalize commutes with the resample; the
  flip is folded into the width matrix (reversed rows) and is an explicit
  argument so that eval can be pinned deterministic.
- depth: /1000 m -> clip(min 0.01[, max]) -> /max (or /img.max()) -> 3-chan
  -> Resize(224, bicubic) -> CenterCrop -> Normalize.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import resolve_device
from .resize import resize_matrix, short_side_resize_shape

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def _normalize(img_chw: torch.Tensor, mean=OPENAI_MEAN, std=OPENAI_STD):
    """(x - mean) / std over the leading (channel) axis."""
    shape = (-1,) + (1,) * (img_chw.dim() - 1)
    mean = torch.tensor(mean, dtype=img_chw.dtype,
                        device=img_chw.device).view(shape)
    std = torch.tensor(std, dtype=img_chw.dtype,
                       device=img_chw.device).view(shape)
    return (img_chw - mean) / std


@functools.lru_cache(maxsize=256)
def crop_resize_weights(h: int, w: int, size: int, method: str,
                        antialias: bool, flip: bool = False):
    """Host-built combined short-side-resize + center-crop (+hflip)
    matrices: (mh [size, h], mw^T [w, size]) float32 numpy, C-contiguous.
    The JAX package's are mh and mw zero-padded to bucket_up(h) and
    bucket_up(w) columns. 256 entries hold at most 0.46 GB of host memory
    at 720x1280 sources."""
    th, tw = short_side_resize_shape(h, w, size)
    mh = resize_matrix(h, th, method, antialias)
    mw = resize_matrix(w, tw, method, antialias)
    top = int(round((th - size) / 2.0))
    left = int(round((tw - size) / 2.0))
    mh = mh[top:top + size]
    mw = mw[left:left + size]
    if flip:
        mw = mw[::-1]
    return np.ascontiguousarray(mh), np.ascontiguousarray(mw.T)


def _weights_on(device: torch.device, h: int, w: int, size: int,
                method: str, antialias: bool, flip: bool = False):
    """crop_resize_weights as f32 tensors on `device`."""
    return tuple(torch.as_tensor(m, device=device)
                 for m in crop_resize_weights(h, w, size, method, antialias,
                                              flip))


def _on(x, device: torch.device, float32: bool = False) -> torch.Tensor:
    """`x` (numpy or a tensor) on `device`; cast to f32 first with
    `float32` (on the host for numpy input)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32 if float32 else None)
    x = np.asarray(x, np.float32 if float32 else None)
    if not x.flags.writeable:  # a decoder's read-only buffer (PIL)
        x = x.copy()
    return torch.as_tensor(x, device=device)


def image_transform(img_hwc_uint8, size: int = 224, *,
                    device="cuda") -> torch.Tensor:
    """[H, W, C] uint8 -> [C, size, size] float32 on `device` (image &
    thermal path). The uint8 source goes to the device as it is."""
    dev = resolve_device(device)
    img = _on(img_hwc_uint8, dev)
    h, w = img.shape[:2]
    mh, mwt = _weights_on(dev, h, w, size, "bicubic", True)
    x = (img.float() / 255.0).permute(2, 0, 1)      # C H W
    y = torch.matmul(torch.matmul(mh, x), mwt)
    return _normalize(y)


def video_transform(frames_thwc_uint8, size: int = 224, flip: bool = False,
                    *, device="cuda") -> torch.Tensor:
    """[T, H, W, C] uint8 -> [C, T, size, size] float32 on `device`.

    decord-backend transform order (normalize before the bilinear
    short-side scale; exact commute since weight rows sum to 1)."""
    dev = resolve_device(device)
    frames = _on(frames_thwc_uint8, dev)
    h, w = frames.shape[1:3]
    mh, mwt = _weights_on(dev, h, w, size, "bilinear", False, flip)
    x = (frames.float() / 255.0).permute(3, 0, 1, 2)  # C T H W
    x = _normalize(x)
    return torch.matmul(torch.matmul(mh, x), mwt)


def depth_transform(depth_hw, size: int = 224, max_depth: float = 10.0,
                    min_depth: float = 0.01, *,
                    device="cuda") -> torch.Tensor:
    """[H, W] float32 (raw sensor units, mm) -> [3, size, size] float32 on
    `device`. max_depth 0 divides by the image's own max (the reference's
    DepthNorm max_depth=0 branch); unpadded, the whole image is the valid
    region the JAX kernel takes that max over."""
    del min_depth  # fixed 0.01 (reference DepthNorm)
    dev = resolve_device(device)
    d = _on(depth_hw, dev, float32=True) / 1000.0
    h, w = d.shape
    mh, mwt = _weights_on(dev, h, w, size, "bicubic", True)
    d = torch.clamp(d, min=0.01)
    if max_depth > 0:
        d = torch.clamp(d, max=max_depth) / max_depth
    else:
        d = d / d.max()
    # the three channels are one plane until the normalise step
    plane = torch.matmul(torch.matmul(mh, d), mwt)
    return _normalize(plane.expand(3, size, size))


def uniform_frame_indices(duration: int, num_frames: int):
    """linspace frame sampling over the full clip — decord/opencv backends
    (reference video/processing_video.py:92,100)."""
    return np.linspace(0, duration - 1, num_frames, dtype=int)


def uniform_temporal_subsample_indices(t: int, num_frames: int):
    """pytorchvideo `UniformTemporalSubsample` sampling — the
    pytorchvideo-backend path. Bit-faithful to
    `torch.linspace(0, t-1, n).clamp(0, t-1).long()` on the CPU: torch's
    CPU linspace computes from BOTH ends in float32 (start + i*step for
    i < n//2, end - (n-1-i)*step otherwise), which truncates differently
    from np.linspace near integer boundaries."""
    if num_frames == 1:
        return np.zeros(1, np.int64)
    step = np.float32((t - 1) / (num_frames - 1))
    i = np.arange(num_frames)
    lo = (np.float32(0) + step * i.astype(np.float32)).astype(np.float32)
    hi = (np.float32(t - 1)
          - step * (num_frames - 1 - i).astype(np.float32)).astype(np.float32)
    vals = np.where(i < num_frames // 2, lo, hi)
    return np.clip(vals, 0, t - 1).astype(np.int64)
