"""The frontend of w2v-BERT 2.0 on the waveform's device: an 80-bin Kaldi
fbank, normalised per bin and stacked two frames at a time, as HF's
SeamlessM4TFeatureExtractor computes it on the host in numpy
(transformers/models/seamless_m4t/feature_extraction_seamless_m4t.py over
audio_utils.spectrogram and mel_filter_bank).

Per frame of 400 samples (25 ms) every 160 (10 ms), on the waveform in
16-bit units (x * 2^15): the frame's mean removed, preemphasis 0.97 (the
first sample scaled by 0.03), the povey window (a symmetric Hann window to
the power 0.85), a 512-point FFT, power, the Kaldi mel filters from 20 Hz
to Nyquist (triangles in mel space), floored at 1.192092955078125e-07 and
logged. Like the extractor, the fbank runs in float64 and stores the FFT as
complex64; the result is float32. Each mel bin is then normalised in
float32 by its mean and its variance (ddof 1) over the input, an odd frame count is
padded with one zero frame, and pairs of frames are stacked: N samples
give (1 + (N - 400) // 160) fbank frames and half as many stacked ones,
rounded up. A chunk of 320 * m samples gives m - 1 rows, as WavLM's
frontend does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

FRAME = 400
HOP = 160
N_FFT = 512
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07
LOW_HZ = 20.0
INT16_SCALE = 32768.0


def kaldi_mel_filters(n_mels: int, sr: int = 16000) -> np.ndarray:
    """(N_FFT // 2 + 1, n_mels) float64 triangles on the Kaldi mel scale
    (1127 ln(1 + f / 700)) from LOW_HZ to sr / 2, triangular in mel space,
    unnormalised (audio_utils.mel_filter_bank(mel_scale="kaldi",
    triangularize_in_mel_space=True))."""
    n_bins = N_FFT // 2 + 1

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    centres = np.linspace(mel(LOW_HZ), mel(sr // 2), n_mels + 2)
    bins = mel(sr / ((n_bins - 1) * 2) * np.arange(n_bins))
    width = np.diff(centres)
    slopes = centres[None, :] - bins[:, None]
    down = -slopes[:, :-2] / width[:-1]
    up = slopes[:, 2:] / width[1:]
    return np.maximum(0.0, np.minimum(down, up))


def povey_window() -> np.ndarray:
    """(FRAME,) float64: a symmetric Hann window to the power 0.85."""
    return np.power(np.hanning(FRAME), 0.85)


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device, n_mels: int, sr: int) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(povey_window()).to(device),
            torch.from_numpy(kaldi_mel_filters(n_mels, sr)).to(device))


def kaldi_log_mel(wave16: torch.Tensor, n_mels: int = 80, sr: int = 16000) -> torch.Tensor:
    """(N,) waveform in 16-bit units -> (1 + (N - FRAME) // HOP, n_mels)
    float32 log mel energies, computed in float64 on wave16's device."""
    if wave16.dim() != 1 or wave16.shape[0] < FRAME:
        raise ValueError(f"the fbank takes one waveform of at least {FRAME} samples, "
                         f"got shape {tuple(wave16.shape)}")
    window, filters = _constants(wave16.device, n_mels, sr)
    frames = wave16.to(torch.float64).unfold(0, FRAME, HOP)
    frames = frames - frames.mean(dim=1, keepdim=True)
    frames = torch.cat([frames[:, :1] * (1.0 - PREEMPHASIS),
                        frames[:, 1:] - PREEMPHASIS * frames[:, :-1]], dim=1)
    spec = torch.fft.rfft(frames * window, n=N_FFT).to(torch.complex64)
    power = torch.view_as_real(spec).to(torch.float64).square().sum(-1)
    return torch.log(torch.clamp(power @ filters, min=MEL_FLOOR)).to(torch.float32)


def w2vbert_input_features(wav: torch.Tensor, n_mels: int = 80, stride: int = 2,
                           sr: int = 16000) -> torch.Tensor:
    """(N,) float waveform in [-1, 1) -> (ceil(F / stride), n_mels * stride)
    float32: the fbank of wav * 2^15 (int16 codes / 32768 give the codes
    back exactly), each bin normalised over the F frames, zero-padded to a
    multiple of `stride` frames and stacked (the extractor's defaults). One
    knnsvc.fbank span."""
    with record_function("knnsvc.fbank"):
        feats = kaldi_log_mel(wav * INT16_SCALE, n_mels, sr)
        feats = (feats - feats.mean(0)) / torch.sqrt(feats.var(0, correction=1) + 1e-7)
        pad = -feats.shape[0] % stride
        if pad:
            feats = torch.cat([feats, feats.new_zeros(pad, n_mels)])
        return feats.reshape(-1, n_mels * stride)
