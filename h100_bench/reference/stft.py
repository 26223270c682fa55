"""A frozen copy of knnsvc_torch/dsp/stft.py, plain PyTorch; nothing of the port is
imported. The original's description:

Spectrograms (counterpart of knnsvc_tpu/dsp/stft.py).

`stft_magnitude` is |STFT| with torch.stft's conventions (reflect padding
when centred, a window shorter than n_fft centred in it), for the spectral
losses of train/spectral_losses.py. Two consumers in the pipeline:
- the linear spectrogram of the harmonic-amplitude pool:
  torchaudio.transforms.Spectrogram(n_fft=400, hop_length=320, center=True,
  power=1) — ref ddsp_prematch_dataset.py:326,361-366: periodic Hann window,
  reflect padding, magnitude, Nyquist bin dropped;
- the log-mel of vocoder training and validation: MelSpectrogram(power=1,
  slaney norm and slaney scale, center=False) on input reflect-padded by
  (n_fft - hop) / 2 on both sides, then log(clamp(1e-5)) — ref
  ddsp_matcher.py:274-298, hifigan/ddsp_meldataset.py. The filterbank is
  built in numpy, as the JAX package builds it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def linear_spectrogram(x: torch.Tensor, n_fft: int = 400, hop_length: int = 320) -> torch.Tensor:
    """(T,) waveform -> (n_frames, n_fft//2) magnitude frames, Nyquist bin
    dropped — the pool layout of the reference (`STFT_OP(x).T[:, :-1]`,
    ref ddsp_prematch_dataset.py:361)."""
    window = torch.hann_window(n_fft, periodic=True, dtype=x.dtype, device=x.device)
    spec = torch.stft(x, n_fft=n_fft, hop_length=hop_length, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    return spec.abs().T[:, :-1]


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = 16000, n_fft: int = 1024, n_mels: int = 80, fmin: float = 0.0,
                   fmax: float = 8000.0) -> np.ndarray:
    """Slaney-scale, slaney-normalized mel filterbank (n_mels, n_fft//2+1),
    matching torchaudio MelSpectrogram(norm='slaney', mel_scale='slaney').
    The cached array is shared: do not write to it."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _filterbank_on(device: torch.device, *args) -> torch.Tensor:
    """mel_filterbank(*args) on `device`, uploaded once: a copy from pageable
    host memory per call would stall the host until the card drains."""
    return torch.from_numpy(mel_filterbank(*args)).to(device)


def log_mel_spectrogram(wav: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                        sampling_rate: int = 16000, hop_size: int = 320, win_size: int = 1024,
                        fmin: float = 0.0, fmax: float = 8000.0) -> torch.Tensor:
    """(..., T) -> (..., num_mels, n_frames), the reference's
    LogMelSpectrogram (ref ddsp_matcher.py:294-298): a manual reflect pad of
    (n_fft - hop) / 2 on both sides, the mel of |STFT| (power 1, periodic
    Hann window of win_size centred in n_fft, center=False), then
    log(clamp(1e-5))."""
    lead = wav.shape[:-1]
    x = wav.reshape(-1, wav.shape[-1])
    pad = (n_fft - hop_size) // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(win_size, periodic=True, dtype=x.dtype, device=x.device)
    spec = torch.stft(x, n_fft=n_fft, hop_length=hop_size, win_length=win_size, window=window,
                      center=False, return_complex=True).abs()          # (N, n_freqs, frames)
    fb = _filterbank_on(x.device, sampling_rate, n_fft, num_mels, fmin, fmax)
    mel = torch.matmul(fb.to(spec.dtype), spec)
    return torch.log(torch.clamp(mel, min=1e-5)).reshape(*lead, num_mels, -1)
