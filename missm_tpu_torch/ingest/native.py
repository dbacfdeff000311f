"""ctypes binding to the shared C++ ingest library (cpp/ ->
libmissm_ingest.so), the port's own copy of missm_tpu/ingest/native.py.

The native library decodes JPEG/PNG (libjpeg/libpng), parses WAV/PCM and
decodes video with FFmpeg (libavformat/avcodec/swscale) with linspace
frame sampling. The port binds its decoders only: its resize runs as torch
ops on the device (`ops.image_transforms`). It is host code,
built with `make -C cpp`, and never by the port itself. Every function
returns None when the library is missing or the call fails, so callers fall
back to the Python decoders. This file sits at the same depth under the
repo as the JAX package's, so `_find_lib` resolves the same repo root.

C ABI (see cpp/ingest.cc):
  int mi_decode_image(path, uint8** data, int* h, int* w)        // RGB8
  int mi_decode_depth(path, uint16** data, int* h, int* w)       // raw u16
  int mi_read_audio(path, float** data, long* n, int* sr)        // ch0
  int mi_decode_video(path, int num_frames, uint8** data,
                      int* t, int* h, int* w)                    // RGB8
  void mi_free(void*)
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False
# first-call init must be race-free: BatchLoader fans decode over a
# thread pool (--num_workers), so several threads can hit _load()
# concurrently on the first batch — without the lock one thread could
# observe _TRIED=True while _LIB is still mid-setup and silently take
# the Python fallback for its samples (mixed-path batches).
_LOAD_LOCK = threading.Lock()


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [
        os.path.join(here, "cpp", "libmissm_ingest.so"),
        os.path.join(here, "libmissm_ingest.so"),
        os.environ.get("MISSM_INGEST_LIB", ""),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def _load():
    global _LIB, _TRIED
    if _TRIED:  # lock-free fast path: _LIB is published BEFORE _TRIED
        return _LIB
    with _LOAD_LOCK:
        if _TRIED:
            return _LIB
        _LIB = _load_locked()
        _TRIED = True
        return _LIB


def _load_locked():
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.mi_decode_image.restype = ctypes.c_int
        lib.mi_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mi_decode_depth.restype = ctypes.c_int
        lib.mi_decode_depth.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mi_read_audio.restype = ctypes.c_int
        lib.mi_read_audio.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
        lib.mi_decode_video.restype = ctypes.c_int
        lib.mi_decode_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.mi_decode_video_indices.restype = ctypes.c_int
        lib.mi_decode_video_indices.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.mi_video_frame_count.restype = ctypes.c_int
        lib.mi_video_frame_count.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double)]
        lib.mi_decode_media_audio.restype = ctypes.c_int
        lib.mi_decode_media_audio.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
        lib.mi_free.restype = None
        lib.mi_free.argtypes = [ctypes.c_void_p]
        return lib
    except (OSError, AttributeError):
        # OSError: no .so / unloadable. AttributeError: a stale prebuilt
        # .so missing a newer symbol (the .so is gitignored — users who
        # pull without `make -C cpp` must fall back, not crash).
        return None


def available() -> bool:
    return _load() is not None


def decode_image(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_uint8)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.mi_decode_image(path.encode(), ctypes.byref(data),
                           ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(data, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.mi_free(data)
    return arr


def decode_depth(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_uint16)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.mi_decode_depth(path.encode(), ctypes.byref(data),
                           ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(data, shape=(h.value, w.value)).copy()
    finally:
        lib.mi_free(data)
    return arr


def read_audio(path: str) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    sr = ctypes.c_int()
    if lib.mi_read_audio(path.encode(), ctypes.byref(data), ctypes.byref(n),
                         ctypes.byref(sr)) != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(data, shape=(n.value,)).copy()
    finally:
        lib.mi_free(data)
    return arr, sr.value


def decode_media_audio(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode the audio stream of any container to mono float32 at the
    stream's native sample rate."""
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    sr = ctypes.c_int()
    if lib.mi_decode_media_audio(path.encode(), ctypes.byref(data),
                                 ctypes.byref(n), ctypes.byref(sr)) != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(data, shape=(n.value,)).copy()
    finally:
        lib.mi_free(data)
    return arr, sr.value


def video_frame_count(path: str) -> Optional[Tuple[int, float]]:
    """-> (total decode-order frames, average fps)."""
    lib = _load()
    if lib is None:
        return None
    total = ctypes.c_int64()
    fps = ctypes.c_double()
    if lib.mi_video_frame_count(path.encode(), ctypes.byref(total),
                                ctypes.byref(fps)) != 0:
        return None
    return total.value, fps.value


def decode_video_indices(path: str, indices) -> Optional[np.ndarray]:
    """Decode the frames at the given sorted decode-order indices
    (duplicates allowed) -> [len(indices), H, W, 3] uint8."""
    lib = _load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    data = ctypes.POINTER(ctypes.c_uint8)()
    t = ctypes.c_int()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.mi_decode_video_indices(
            path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), ctypes.byref(data), ctypes.byref(t), ctypes.byref(h),
            ctypes.byref(w)) != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(
            data, shape=(t.value, h.value, w.value, 3)).copy()
    finally:
        lib.mi_free(data)
    return arr


def decode_video(path: str, num_frames: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_uint8)()
    t = ctypes.c_int()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.mi_decode_video(path.encode(), num_frames, ctypes.byref(data),
                           ctypes.byref(t), ctypes.byref(h),
                           ctypes.byref(w)) != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(
            data, shape=(t.value, h.value, w.value, 3)).copy()
    finally:
        lib.mi_free(data)
    return arr

