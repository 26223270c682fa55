"""Spectral losses (counterpart of knnsvc_tpu/train/spectral_losses.py; ref
ddsp_matcher.py:100-145 — SSSLoss / RSSLoss).

Orphaned on the reference's live path but part of its surface: the
single-scale and random-scale spectral losses for DDSP-style vocoder
experiments, on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from knnsvc_torch.dsp.stft import stft_magnitude


def sss_loss(x_true: torch.Tensor, x_pred: torch.Tensor, n_fft: int = 1024, alpha: float = 1.0,
             overlap: float = 0.0, eps: float = 1e-7) -> torch.Tensor:
    """Single-scale spectral loss: normalized convergence term + log-L1
    (ref :113-122). x_* (B, T) -> 0-d tensor."""
    hop = int(n_fft * (1 - overlap))
    # torchaudio Spectrogram(power=1, normalized=True, center=False): the
    # window's energy is that of numpy's (symmetric) Hann, as in the JAX package
    norm = float(np.sqrt(np.sum(np.hanning(n_fft).astype(np.float32) ** 2)))

    def spec(x):
        s = stft_magnitude(x, n_fft=n_fft, hop_length=hop, center=False, power=1.0)
        return s / norm + eps

    s_true, s_pred = spec(x_true), spec(x_pred)
    diff_norm = torch.sqrt(torch.sum((s_true - s_pred) ** 2, dim=(1, 2)))
    sum_norm = torch.sqrt(torch.sum((s_true + s_pred) ** 2, dim=(1, 2)))
    converge = torch.mean(diff_norm / sum_norm)
    log_term = torch.mean(torch.abs(torch.log(s_true) - torch.log(s_pred)))
    return converge + alpha * log_term


def rss_loss(generator: torch.Generator, x_pred: torch.Tensor, x_true: torch.Tensor,
             fft_min: int = 256, fft_max: int = 2048, n_scale: int = 4,
             alpha: float = 1.0) -> torch.Tensor:
    """Random-scale spectral loss (ref :125-145): sss_loss averaged over
    n_scale FFT sizes in [fft_min, fft_max) drawn by torch.randint from
    `generator` (a CPU torch.Generator, in the place of the JAX package's
    PRNG key and the reference's global RNG)."""
    sizes = torch.randint(fft_min, fft_max, (n_scale,), generator=generator).tolist()
    total = sum(sss_loss(x_true, x_pred, n_fft=n, alpha=alpha) for n in sizes)
    return total / n_scale
