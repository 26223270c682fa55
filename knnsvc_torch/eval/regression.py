"""Golden-file regression utilities (counterpart of
knnsvc_tpu/eval/regression.py; SURVEY.md §4.5: sample_content ships a golden
converted output usable as a regression oracle)."""

from __future__ import annotations

import numpy as np
import torch

from knnsvc_torch.io.audio import load_audio


def max_waveform_deviation(path_a: str, path_b: str) -> float:
    """Max absolute sample deviation between two audio files (the BASELINE
    parity metric: <= 1e-3 vs the PyTorch reference at topk=4)."""
    a, sr_a = load_audio(path_a)
    b, sr_b = load_audio(path_b)
    assert sr_a == sr_b, (sr_a, sr_b)
    n = min(a.shape[-1], b.shape[-1])
    assert abs(a.shape[-1] - b.shape[-1]) <= 320, "length mismatch beyond one hop"
    return float(np.max(np.abs(a[..., :n] - b[..., :n])))


def spectral_distance(path_a: str, path_b: str, device: str | torch.device = "cuda") -> float:
    """Mean log-mel L1 between two audio files (robust quality proxy when
    bit-level comparison is meaningless, e.g. across vocoder weights), the
    log-mels computed on `device` (a CUDA request without a card raises)."""
    from knnsvc_torch.dsp.stft import log_mel_spectrogram
    from knnsvc_torch.hub import resolve_device
    from knnsvc_torch.io.audio import to_mono

    dev = resolve_device(device)
    a, _ = load_audio(path_a)
    b, _ = load_audio(path_b)
    n = min(a.shape[-1], b.shape[-1])
    with torch.no_grad():
        ma, mb = (log_mel_spectrogram(torch.from_numpy(np.ascontiguousarray(to_mono(x[..., :n])))
                                      .to(dev)) for x in (a, b))
        return float(torch.mean(torch.abs(ma - mb)))
