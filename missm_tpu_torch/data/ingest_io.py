"""Decode front-end, after missm_tpu/data/ingest_io.py: the native C++
ingest library (`missm_tpu_torch.ingest.native`) when it is built, else
the pure-Python fallbacks (PIL for images and depth, stdlib `wave` for PCM
WAV). Video has no Python fallback: without the library it raises.
"""
from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def _native():
    from ..ingest import native
    return native if native.available() else None


def decode_image(path: str) -> np.ndarray:
    """-> [H, W, 3] uint8 RGB. PIL tolerates truncated files like the
    reference (processing_image.py:7-8)."""
    n = _native()
    if n is not None:
        arr = n.decode_image(path)
        if arr is not None:
            return arr
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def decode_depth(path: str) -> np.ndarray:
    """-> [H, W] raw depth units (16-bit PNG typical), matching
    cv2.imread(IMREAD_UNCHANGED) (depth/processing_depth.py:17-18)."""
    n = _native()
    if n is not None:
        arr = n.decode_depth(path)
        if arr is not None:
            return arr
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """-> (waveform float32 in [-1, 1] (first channel), sample_rate) —
    torchaudio soundfile-backend semantics (processing_audio.py:17-20)."""
    n = _native()
    if n is not None:
        out = n.read_audio(path)
        if out is not None:
            return out
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(frames, dtype="<i4").astype(np.float32) / (2 ** 31)
    elif width == 1:
        data = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if nch > 1:
        data = data.reshape(-1, nch)[:, 0]
    return data, sr


_NO_NATIVE = (
    "video decode requires the native ingest library; build it with "
    "`make -C cpp` (FFmpeg/libav). For tests, inject a synthetic "
    "video loader.")


def decode_video(path: str, num_frames: int) -> np.ndarray:
    """-> [T, H, W, 3] uint8, frames sampled by linspace over the clip
    (reference video/processing_video.py:88-110). Requires the C++ ingest
    (FFmpeg); no Python fallback for real containers."""
    n = _native()
    if n is not None:
        arr = n.decode_video(path, num_frames)
        if arr is not None:
            return arr
    raise RuntimeError(_NO_NATIVE)


def video_frame_count(path: str) -> Tuple[int, float]:
    """-> (total frames, average fps) — the pytorchvideo-backend sampling
    metadata (EncodedVideo.duration equivalent)."""
    n = _native()
    if n is not None:
        out = n.video_frame_count(path)
        if out is not None:
            return out
    raise RuntimeError(_NO_NATIVE)


def decode_video_indices(path: str, indices) -> np.ndarray:
    """-> [len(indices), H, W, 3] uint8 at the given sorted decode-order
    frame indices (duplicates allowed)."""
    n = _native()
    if n is not None:
        arr = n.decode_video_indices(path, indices)
        if arr is not None:
            return arr
    raise RuntimeError(_NO_NATIVE)
