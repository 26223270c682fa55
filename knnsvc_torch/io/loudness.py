"""ITU-R BS.1770-4 loudness measurement and gain — the port's own copy of
knnsvc_tpu/io/loudness.py (numpy and scipy).

Equivalent of torchaudio.functional.loudness + gain, which the reference's
`tgt_loudness_db` flag feeds — note the reference has the normalization
commented out on its live path (ref ddsp_matcher.py:997-1003), so the default
pipeline here also skips it; this utility exists for users who enable it."""

from __future__ import annotations

import numpy as np
from scipy import signal


def _k_weighting(sr: int):
    """Pre-filter (shelf) + RLB high-pass biquads per BS.1770."""
    # stage 1: spherical-head shelf
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = np.tan(np.pi * f0 / sr)
    Vh = 10 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b = [(Vh + Vb * K / Q + K * K) / a0, 2.0 * (K * K - Vh) / a0, (Vh - Vb * K / Q + K * K) / a0]
    a = [1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0]
    # stage 2: RLB high-pass
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / sr)
    b2 = [1.0, -2.0, 1.0]
    a2 = [1.0, 2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K), (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K)]
    return (np.array(b), np.array(a)), (np.array(b2), np.array(a2))


def loudness(x: np.ndarray, sr: int) -> float:
    """Integrated loudness (LKFS) of (channels, T) or (T,)."""
    if x.ndim == 1:
        x = x[None]
    (b1, a1), (b2, a2) = _k_weighting(sr)
    y = signal.lfilter(b2, a2, signal.lfilter(b1, a1, x, axis=-1), axis=-1)

    gate = int(0.4 * sr)          # 400 ms blocks
    step = int(0.1 * sr)          # 75% overlap
    T = y.shape[-1]
    if T < gate:
        ms = np.mean(y ** 2, axis=-1)
        return float(-0.691 + 10 * np.log10(np.sum(ms) + 1e-12))
    n_blocks = (T - gate) // step + 1
    idx = np.arange(n_blocks)[:, None] * step + np.arange(gate)[None, :]
    blocks = y[..., idx]                              # (C, N, gate)
    ms = np.mean(blocks ** 2, axis=-1)                # (C, N)
    lk = -0.691 + 10 * np.log10(np.sum(ms, axis=0) + 1e-12)  # (N,)

    # absolute gate at -70 LKFS, then relative gate at -10 LU
    keep = lk > -70.0
    if not keep.any():
        return -70.0
    z = np.sum(ms[:, keep], axis=0)
    rel_thresh = -0.691 + 10 * np.log10(np.mean(z) + 1e-12) - 10.0
    keep2 = keep & (lk > rel_thresh)
    if not keep2.any():
        keep2 = keep
    z2 = np.mean(np.sum(ms, axis=0)[keep2])
    return float(-0.691 + 10 * np.log10(z2 + 1e-12))


def normalize_loudness(x: np.ndarray, sr: int, target_db: float) -> np.ndarray:
    """Apply gain so integrated loudness == target_db (no limiting)."""
    current = loudness(x, sr)
    gain = 10 ** ((target_db - current) / 20.0)
    return (x * gain).astype(np.float32)
