"""Preprocessing on the tensor's device (counterpart of
``one_peace_tpu/ops/preprocess.py``).

- ``resize_normalize``: bicubic resize + CLIP normalisation of one uint8
  image.  ``F.interpolate(mode="bicubic", antialias=True)`` uses the Keys
  cubic kernel with a = -0.5 and widens it when downsampling, as
  ``jax.image.resize(..., "bicubic")`` does; without ``antialias`` PyTorch
  uses a = -0.75 and no widening.
- ``mel_filterbank`` and ``LogMelFbank``: the optional 16 kHz log-mel
  frontend (25 ms frames at a 10 ms hop, a symmetric Hann window, power
  spectrum, HTK mel matrix, log).  The reference itself LayerNorms the raw
  waveform; this is the optional frontend of the JAX package.
  ``mel_filterbank`` is a copy of the JAX package's numpy function (its
  module imports JAX), held equal to it by a test.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def resize_normalize(image_u8: torch.Tensor, size: int, mean: Sequence[float],
                     std: Sequence[float]) -> torch.Tensor:
    """(H, W, 3) uint8 -> (3, size, size) float32 on the same device,
    bicubic + CLIP normalisation."""
    x = image_u8.float().div(255.0).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(size, size), mode="bicubic", antialias=True,
                      align_corners=False)[0]
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)[:, None, None]
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)[:, None, None]
    return (x - mean_t) / std_t


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: float = None) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular HTK-style mel matrix (host-side)."""
    fmax = fmax or sample_rate / 2
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


class LogMelFbank:
    """wav (B, T) float32 at ``sample_rate`` -> (B, frames, n_mels) log-mel,
    on wav's device."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 400,
                 hop: int = 160, n_mels: int = 80, fmin: float = 0.0,
                 fmax: float = None, eps: float = 1e-6):
        self.n_fft = n_fft
        self.hop = hop
        self.n_mels = n_mels
        self.eps = eps
        self.window = torch.from_numpy(np.hanning(n_fft).astype(np.float32))  # symmetric
        self.mel = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate, fmin, fmax))

    def num_frames(self, length: int) -> int:
        return max(0, 1 + (length - self.n_fft) // self.hop)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        b, t = wav.shape
        if self.num_frames(t) == 0:
            return wav.new_zeros(b, 0, self.n_mels, dtype=torch.float32)
        frames = wav.float().unfold(1, self.n_fft, self.hop) * self.window.to(wav.device)
        power = torch.fft.rfft(frames, dim=-1).abs() ** 2
        mel = torch.einsum("bnf,fm->bnm", power, self.mel.to(wav.device))
        return torch.log(mel + self.eps)
