"""Kaldi-semantics log-mel filterbank, after missm_tpu/ops/melfbank.py.

The reference's `torchaudio.compliance.kaldi.fbank` call (htk_compat=True,
hanning window, dither=0, 25 ms frames, 10 ms shift, use_energy=False) as
torch ops on `device`: framing (unfold) -> DC removal -> preemphasis ->
Hann window -> zero-pad to pow2 -> rFFT power spectrum (`torch.fft.rfft`,
cuFFT on the card) -> mel filterbank product -> log. The filterbank, the
window and the frame count are numpy, built on the host as in the JAX
package; so are the numpy twins `kaldi_fbank_host` and
`audio_model_input_host`, which the card's results are held against.

Kaldi/torchaudio semantic details reproduced:
- snip_edges=True framing: n_frames = 1 + (n - window) // shift
- remove_dc_offset=True: per-frame mean subtraction
- preemphasis 0.97 with the first sample preemphasized against itself
- 'hanning' window = 0.5 - 0.5 cos(2 pi n / (N-1)) (periodic=False)
- padded_window_size = next power of two (512 @ 16 kHz / 25 ms)
- power spectrum |rfft|^2
- mel banks: HTK mel scale 1127 ln(1+f/700), low=20 Hz, high=nyquist,
  triangular weights over fft bins 0..N/2-1 (nyquist bin weight 0)
- log with float32-epsilon floor
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 112
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: offset from nyquist

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def padded_window_size(self) -> int:
        return 1 << (self.window_size - 1).bit_length()


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=16)
def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """(num_mel_bins, padded//2 + 1) triangular filterbank, float32.
    The nyquist column is zero (Kaldi computes bins over 0..N/2-1 and
    torchaudio pads one zero column)."""
    n_fft_bins = cfg.padded_window_size // 2
    nyquist = 0.5 * cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_lo, mel_hi = _mel(cfg.low_freq), _mel(high)
    delta = (mel_hi - mel_lo) / (cfg.num_mel_bins + 1)

    fft_freqs = (cfg.sample_rate / cfg.padded_window_size) * np.arange(
        n_fft_bins)
    mel_f = _mel(fft_freqs)[None, :]                       # (1, F)
    left = mel_lo + np.arange(cfg.num_mel_bins)[:, None] * delta
    center = left + delta
    right = center + delta
    up = (mel_f - left) / (center - left)
    down = (right - mel_f) / (right - center)
    w = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return np.pad(w, ((0, 0), (0, 1)))                     # zero nyquist col


@functools.lru_cache(maxsize=16)
def _hann(window_size: int) -> np.ndarray:
    n = np.arange(window_size)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (window_size - 1))).astype(
        np.float32)


@functools.lru_cache(maxsize=16)
def _tables_on(device: torch.device, cfg: FbankConfig):
    """(Hann window [ws], mel banks transposed [N/2+1, bins]) on `device`."""
    return (torch.as_tensor(_hann(cfg.window_size), device=device),
            torch.as_tensor(np.ascontiguousarray(mel_banks(cfg).T),
                            device=device))


def num_frames(n_samples: int, cfg: FbankConfig) -> int:
    return max(0, 1 + (n_samples - cfg.window_size) // cfg.window_shift)


def kaldi_fbank(waveform: torch.Tensor,
                cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """waveform: [n_samples] float32 tensor -> log-mel [n_frames,
    num_mel_bins] on the waveform's device (snip_edges framing)."""
    m = num_frames(waveform.shape[0], cfg)
    ws, shift = cfg.window_size, cfg.window_shift
    window, banks_t = _tables_on(waveform.device, cfg)
    frames = (waveform.unfold(0, ws, shift) if m
              else waveform.new_zeros((0, ws)))             # [m, ws]

    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=1, keepdim=True)

    if cfg.preemphasis:
        prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = frames - cfg.preemphasis * prev

    frames = frames * window
    frames = torch.nn.functional.pad(frames,
                                     (0, cfg.padded_window_size - ws))

    spectrum = torch.fft.rfft(frames, dim=1).abs() ** 2    # [m, N/2+1]
    energies = torch.matmul(spectrum, banks_t)
    eps = torch.finfo(torch.float32).eps
    return torch.log(torch.clamp(energies, min=eps))


def waveform_to_model_input(mel: torch.Tensor, target_length: int,
                            chunk_indices, audio_mean: float,
                            audio_std: float) -> torch.Tensor:
    """Kaldi mel [T, bins] -> model input [3, bins, target_length].

    Mirrors `AudioTransform.waveform2melspec` (reference
    audio/processing_audio.py:54-95): three chunks (front/middle/back) when
    long, tile-repeat when short, x3 stack when exact; then transpose and
    normalize (x - mean) / (2 std). chunk_indices: the host-chosen (front,
    middle, back) frame offsets."""
    T = mel.shape[0]
    if T > target_length:
        fusion = torch.stack([mel[i:i + target_length]
                              for i in chunk_indices], dim=0)
    elif T < target_length:
        n_repeat = int(target_length / T) + 1
        rep = mel.repeat(n_repeat, 1)[:target_length]
        fusion = torch.stack([rep, rep, rep], dim=0)
    else:
        fusion = torch.stack([mel, mel, mel], dim=0)
    fusion = fusion.transpose(1, 2)          # [3, bins, target]
    return (fusion - audio_mean) / (audio_std * 2.0)


def audio_model_input(waveform: "np.ndarray", cfg: FbankConfig,
                      target_length: int, chunk_indices,
                      audio_mean: float, audio_std: float, *,
                      device="cuda") -> torch.Tensor:
    """[n] float32 waveform -> [3, bins, target] f32 on `device`: fbank,
    then the chunk / tile / stack gather and the normalise step.

    The JAX package pads the waveform to a length bucket and gathers only
    the first n_frames(n) mel rows; here the fbank runs on the unpadded
    waveform, whose frames are those rows. A waveform shorter than one
    window is zero-padded to one, which gives the JAX kernel's single
    frame."""
    dev = resolve_device(device)
    wav = torch.as_tensor(np.asarray(waveform, np.float32), device=dev)
    if wav.shape[0] < cfg.window_size:
        wav = torch.nn.functional.pad(wav, (0, cfg.window_size
                                            - wav.shape[0]))
    return waveform_to_model_input(kaldi_fbank(wav, cfg), target_length,
                                   chunk_indices, audio_mean, audio_std)


def kaldi_fbank_host(waveform: np.ndarray,
                     cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """numpy twin of `kaldi_fbank`, the host reference for the card's."""
    wav = np.asarray(waveform, np.float32)
    m = num_frames(wav.shape[0], cfg)
    ws, shift = cfg.window_size, cfg.window_shift
    idx = (np.arange(m) * shift)[:, None] + np.arange(ws)[None, :]
    frames = wav[idx]                                       # [m, ws]
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - cfg.preemphasis * prev
    frames = frames * _hann(ws)
    pad = cfg.padded_window_size - ws
    frames = np.pad(frames, ((0, 0), (0, pad)))
    spectrum = np.abs(np.fft.rfft(frames, axis=1)).astype(np.float32) ** 2
    energies = spectrum @ mel_banks(cfg).T                  # [m, bins]
    eps = np.finfo(np.float32).eps
    return np.log(np.maximum(energies, eps)).astype(np.float32)


def audio_model_input_host(waveform: np.ndarray, cfg: FbankConfig,
                           target_length: int, chunk_indices,
                           audio_mean: float, audio_std: float):
    """numpy twin of `audio_model_input` (same chunk/tile/normalize
    semantics as `waveform_to_model_input`)."""
    mel = kaldi_fbank_host(waveform, cfg)                   # [T, bins]
    T = mel.shape[0]
    if T > target_length:
        chunks = [mel[i:i + target_length] for i in chunk_indices]
        fusion = np.stack(chunks, axis=0)
    elif T < target_length:
        n_repeat = int(target_length / T) + 1
        rep = np.tile(mel, (n_repeat, 1))[:target_length]
        fusion = np.stack([rep, rep, rep], axis=0)
    else:
        fusion = np.stack([mel, mel, mel], axis=0)
    fusion = fusion.transpose(0, 2, 1)                      # [3, bins, tgt]
    return ((fusion - audio_mean) / (audio_std * 2.0)).astype(np.float32)


def chunk_ranges(total_frames: int, target_length: int):
    """The three np.array_split ranges the reference samples chunk starts
    from (audio/processing_audio.py:60-68)."""
    ranges = np.array_split(list(range(0, total_frames - target_length + 1)),
                            3)
    r0 = ranges[0]
    r1 = ranges[1] if len(ranges[1]) else [0]
    r2 = ranges[2] if len(ranges[2]) else [0]
    return r0, r1, r2
