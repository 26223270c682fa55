"""Voice-activity trimming — the port's own copy of knnsvc_tpu/io/vad.py
(numpy only).

The reference trims leading/trailing silence with torchaudio's sox-port
T.Vad(trigger_level=7) in `KNeighborsVC.get_features`, rounding each trim to
a hop multiple (ref ddsp_matcher.py:462-491). Only the legacy knn-vc surface
(`KnnSvc.get_features` / `get_matching_set`) applies it; the pool builders
never do (ref ddsp_prematch_dataset.py:301-414).

Implementation: short-time RMS power in dB over 10 ms frames, the noise
floor taken as the 10th percentile, activity where a frame exceeds floor +
trigger_level dB (an energy detector in place of sox's cepstral one, as in
the JAX package)."""

from __future__ import annotations

import numpy as np

from knnsvc_torch import HOP_LENGTH


def _first_active(x: np.ndarray, sr: int, trigger_level: float) -> int:
    frame = max(1, sr // 100)  # 10 ms
    n = len(x) // frame
    if n == 0:
        return 0
    p = (x[: n * frame].reshape(n, frame) ** 2).mean(axis=1)
    db = 10 * np.log10(p + 1e-12)
    floor = np.percentile(db, 10)
    active = db > floor + trigger_level
    idx = np.argmax(active) if active.any() else 0
    return int(idx * frame)


def vad_trim(x: np.ndarray, sr: int, trigger_level: float = 7.0,
             hop_length: int = HOP_LENGTH) -> tuple[np.ndarray, int, int]:
    """Trim silence from both ends, each cut rounded UP to a hop multiple
    (ref ddsp_matcher.py:466-482's extra_cut logic).
    Returns (trimmed, lstrip_len, rstrip_len)."""
    if trigger_level <= 1e-3:
        return x, 0, 0
    lstrip = _first_active(x, sr, trigger_level)
    if lstrip % hop_length != 0:
        lstrip += hop_length - lstrip % hop_length
    rev = x[::-1]
    rstrip = _first_active(rev, sr, trigger_level)
    if rstrip % hop_length != 0:
        rstrip += hop_length - rstrip % hop_length
    end = len(x) - rstrip
    if end <= lstrip:  # degenerate: keep everything
        return x, 0, 0
    return x[lstrip:end], lstrip, rstrip
