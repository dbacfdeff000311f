"""Windowed-sinc audio resampling on the host, a copy of
missm_tpu/ops/resample.py.

Matches torchaudio.functional.resample's defaults (sinc_interp_hann,
lowpass_filter_width=6, rolloff=0.99), as a polyphase kernel bank applied
with a strided matmul in numpy.
"""
from __future__ import annotations

import math

import numpy as np


def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int,
            rolloff: float):
    base_freq = min(orig_freq, new_freq) * rolloff / 2.0
    width = math.ceil(lowpass_filter_width * orig_freq / (2.0 * base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = (np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq
         + idx[None, :])
    t = t * (2.0 * base_freq)
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    tpi = t * np.pi
    kernel = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0,
                                                            tpi))
    kernel = kernel * window * (2.0 * base_freq / orig_freq)
    return kernel.astype(np.float32), width


def resample_sinc(waveform: np.ndarray, orig_freq: int, new_freq: int,
                  lowpass_filter_width: int = 6,
                  rolloff: float = 0.99) -> np.ndarray:
    """waveform: [N] float32 -> resampled [ceil(N * new / orig)]."""
    if orig_freq == new_freq:
        return waveform
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = orig_freq // g, new_freq // g
    kernel, width = _kernel(orig_g, new_g, lowpass_filter_width, rolloff)

    n = len(waveform)
    target_len = math.ceil(new_g * n / orig_g)
    pad = np.concatenate([np.zeros(width, np.float32),
                          waveform.astype(np.float32),
                          np.zeros(width + orig_g, np.float32)])
    n_blocks = (len(pad) - kernel.shape[1]) // orig_g + 1
    # frames [n_blocks, K] stride orig_g
    idx = (np.arange(n_blocks)[:, None] * orig_g
           + np.arange(kernel.shape[1])[None, :])
    frames = pad[idx]
    out = frames @ kernel.T                      # [n_blocks, new_g]
    return out.reshape(-1)[:target_len]
