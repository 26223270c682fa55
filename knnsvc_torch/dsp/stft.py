"""Linear spectrogram for the harmonic-amplitude pool (counterpart of
knnsvc_tpu/dsp/stft.py::linear_spectrogram).

torchaudio.transforms.Spectrogram(n_fft=400, hop_length=320, center=True,
power=1) — ref ddsp_prematch_dataset.py:326,361-366: periodic Hann window,
reflect padding, magnitude, Nyquist bin dropped.
"""

from __future__ import annotations

import torch


def linear_spectrogram(x: torch.Tensor, n_fft: int = 400, hop_length: int = 320) -> torch.Tensor:
    """(T,) waveform -> (n_frames, n_fft//2) magnitude frames, Nyquist bin
    dropped — the pool layout of the reference (`STFT_OP(x).T[:, :-1]`,
    ref ddsp_prematch_dataset.py:361)."""
    window = torch.hann_window(n_fft, periodic=True, dtype=x.dtype, device=x.device)
    spec = torch.stft(x, n_fft=n_fft, hop_length=hop_length, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    return spec.abs().T[:, :-1]
