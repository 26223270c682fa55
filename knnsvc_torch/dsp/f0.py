"""f0 extraction — the port's own copy of knnsvc_tpu/dsp/f0.py (numpy and
ctypes only; 'device' runs dsp/f0_device.py with torch). Sidecar order,
cache names and the YIN fallback are kept exactly.

The reference uses pyworld's Harvest (C++) with floor 65 Hz, ceil 1047 Hz,
frame period = hop/sr*1000 = 20 ms, then zeroes voiced estimates below 80 Hz
(ref ddsp_prematch_dataset.py:121-128, ddsp_matcher.py:410-426). pyworld is
not available here, so this module provides:

- sidecar loading: the reference caches f0 next to the audio as
  `<stem>_f0.npy` (ref ddsp_prematch_dataset.py:372-386) and ships sidecars
  for the sample pair — when present these are bit-identical to Harvest.
- a batched YIN estimator (de Cheveigne & Kawahara 2002) implemented with
  numpy FFT autocorrelation — all frames at once, no Python-per-frame loop.
  Used when no sidecar exists. A C++ Harvest port (native/harvest) replaces
  this for parity-grade extraction when built.

Frame count matches pyworld: n_frames = T//hop + 1, frame i centered at
sample i*hop.
"""

from __future__ import annotations

import os

import numpy as np

F0_FLOOR = 65.0
F0_CEIL = 1047.0
F0_ZERO_BELOW = 80.0
DEFAULT_HOP = 320


def _sidecar_path(audio_path: str, method: str = "harvest") -> str:
    """Parity-grade extractors share the reference's `<stem>_f0.npy` name;
    approximate extractors (fast DIO, YIN) cache under a method-suffixed
    name so they can never silently downgrade a later Harvest-quality read
    (`<stem>_f0.npy` is trusted by the parity path)."""
    stem = os.path.splitext(str(audio_path))[0]
    suffix = "_f0.npy" if method == "harvest" else f"_f0_{method}.npy"
    return stem + suffix


def load_f0_sidecar(audio_path: str) -> np.ndarray | None:
    sidecar = os.path.splitext(str(audio_path))[0] + "_f0.npy"
    if os.path.isfile(sidecar):
        return np.load(sidecar, allow_pickle=True).astype(np.float32)
    return None


def save_f0_sidecar(audio_path: str, f0: np.ndarray) -> str:
    sidecar = os.path.splitext(str(audio_path))[0] + "_f0.npy"
    np.save(sidecar, np.asarray(f0, dtype=np.float32))
    return sidecar


def yin_f0(
    x: np.ndarray,
    sr: int,
    hop: int = DEFAULT_HOP,
    f0_floor: float = F0_FLOOR,
    f0_ceil: float = F0_CEIL,
    frame_length: int = 2048,
    threshold: float = 0.15,
) -> np.ndarray:
    """Batched YIN pitch tracking. x (T,) -> f0 (T//hop + 1,) Hz, 0 = unvoiced.

    Difference function via FFT autocorrelation per frame, cumulative-mean
    normalization, absolute-threshold pick with parabolic refinement.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n_frames = len(x) // hop + 1
    half = frame_length // 2
    xp = np.pad(x, (half, half + frame_length))

    starts = np.arange(n_frames) * hop
    idx = starts[:, None] + np.arange(frame_length)[None, :]
    frames = xp[idx]                                   # (N, W) centered at i*hop

    # difference function d(tau) via autocorrelation:
    # d(tau) = r(0) + r_tau(0) - 2*corr(tau)
    W = frame_length
    tau_max = min(int(sr / f0_floor) + 2, half)
    nfft = 1 << int(np.ceil(np.log2(W + tau_max)))
    F = np.fft.rfft(frames, nfft, axis=1)
    acf = np.fft.irfft(F * np.conj(F), nfft, axis=1)[:, : tau_max + 1]  # corr(tau) over full frame

    # energy terms: e(tau) = sum_{j=tau}^{W-1} x_j^2 ; e0 = sum_{j=0}^{W-1-tau}
    sq = frames ** 2
    csum = np.cumsum(sq, axis=1)
    total = csum[:, -1:]
    # sum of x[j]^2 for j in [tau, W): total - csum[tau-1]
    tau_idx = np.arange(tau_max + 1)
    e_tail = total - np.concatenate([np.zeros((n_frames, 1)), csum[:, : tau_max]], axis=1)
    # head energy: sum_{j=0}^{W-1-tau} x_j^2 = csum[W-1-tau]
    head_idx = np.clip(W - 1 - tau_idx, 0, W - 1)
    e_head = csum[:, head_idx]
    d = e_head + e_tail - 2.0 * acf
    d = np.maximum(d, 0.0)

    # cumulative mean normalized difference
    with np.errstate(divide="ignore", invalid="ignore"):
        cmndf = np.empty_like(d)
        cmndf[:, 0] = 1.0
        run = np.cumsum(d[:, 1:], axis=1)
        cmndf[:, 1:] = d[:, 1:] * tau_idx[1:] / np.maximum(run, 1e-12)

    tau_min = max(2, int(sr / f0_ceil))
    search = cmndf[:, tau_min : tau_max + 1]           # (N, S)

    below = search < threshold
    first = np.where(below.any(axis=1), below.argmax(axis=1), search.argmin(axis=1))
    # extend to the local minimum after the threshold crossing
    S = search.shape[1]
    nxt = np.clip(first + 1, 0, S - 1)
    # walk downhill (vectorized few steps; YIN minima are narrow)
    for _ in range(64):
        go = (search[np.arange(n_frames), nxt] < search[np.arange(n_frames), first]) & (first < S - 1)
        first = np.where(go, nxt, first)
        nxt = np.clip(first + 1, 0, S - 1)
        if not go.any():
            break

    tau = first + tau_min
    # parabolic interpolation around tau
    t0 = np.clip(tau - 1, 0, tau_max)
    t2 = np.clip(tau + 1, 0, tau_max)
    ar = np.arange(n_frames)
    y0, y1, y2 = cmndf[ar, t0], cmndf[ar, tau], cmndf[ar, t2]
    denom = y0 - 2 * y1 + y2
    delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / np.where(np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    tau_refined = tau + np.clip(delta, -1.0, 1.0)

    f0 = sr / np.maximum(tau_refined, 1e-6)
    voiced = (cmndf[ar, tau] < max(threshold * 2, 0.35)) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    f0 = np.where(voiced, f0, 0.0).astype(np.float32)
    f0[f0 < F0_ZERO_BELOW] = 0.0
    return f0


def _native_available() -> bool:
    """Whether the native (C++) extractor can actually run here."""
    try:
        from knnsvc_torch.dsp import harvest as native

        native._load_library()  # probes (builds/loads) the shared object
        return True
    except (ImportError, OSError, AttributeError):
        return False


# method -> (native fn name, sidecar cache name). The cache name is part of
# the on-disk contract: when a method's underlying extractor changes, its
# cache name MUST change too, or stale caches from the old extractor would
# silently serve the new method's reads ('fast' was DIO through round 3 and
# cached as _f0_fast.npy; the 6 kHz budget Harvest of round 4 cached as
# _f0_hfast.npy; the 4 kHz 12-channel grid as _f0_hfast4k.npy; the current
# 4 kHz 8-channel fast_grid caches as _f0_hfast8c.npy — caches from
# superseded extractors are simply orphaned: recomputed, never mixed).
_NATIVE_METHODS = {
    "harvest": ("harvest_f0", "harvest"),     # parity; caches <stem>_f0.npy
    "fast": ("harvest_fast_f0", "hfast8c"),   # budget Harvest (serving default)
    "dio": ("dio_f0", "dio"),                 # fastest; lowest recall
}


def get_f0(x: np.ndarray, sr: int, audio_path: str | None = None,
           hop: int = DEFAULT_HOP, use_sidecar: bool = True,
           write_sidecar: bool = True, method: str = "harvest",
           device: str = "cuda") -> np.ndarray:
    """Reference-compatible entry: sidecar if present, else extractor,
    caching the result as a sidecar (ref ddsp_prematch_dataset.py:372-386).

    method: 'harvest' (native parity-grade Harvest, the live-path default —
    same extractor family as the reference's pyworld call), 'fast' (the
    budget Harvest: same pipeline on a coarser grid, >100x realtime, for
    latency-sensitive serving), 'dio' (DIO+StoneMask, fastest), 'yin'
    (pure-numpy fallback) or 'device' (dsp/f0_device.py on `device`, which
    defaults to the card and raises without one; no YIN fallback; the fast
    pool build calls it per chunk instead of through this entry). Native
    methods fall back to YIN when the native toolchain is unavailable."""
    if method not in ("yin", "device") and method not in _NATIVE_METHODS:
        raise ValueError(f"unknown f0 method {method!r}")
    cache_name = _NATIVE_METHODS.get(method, (None, method))[1]
    if method == "device":
        cache_name = "dev1"  # the JAX package's name: bump when the extractor changes
    if use_sidecar and audio_path is not None:
        # the parity sidecar (harvest-grade, the reference's convention) is
        # preferred by every method; approximate methods fall back to their
        # own method-suffixed cache
        cached = load_f0_sidecar(audio_path)
        if cached is None and method != "harvest":
            p = _sidecar_path(audio_path, cache_name)
            if os.path.exists(p):
                cached = np.load(p).astype(np.float32)
        if (cached is None and method not in ("yin", "device")
                and not _native_available()):
            # a previous call with this method fell back to YIN and cached
            # under the fallback's name — reuse it instead of recomputing
            p = _sidecar_path(audio_path, "yin")
            if os.path.exists(p):
                cached = np.load(p).astype(np.float32)
        if cached is not None:
            return cached
    cache_used = cache_name
    if method == "yin":
        f0 = yin_f0(x, sr, hop=hop)
    elif method == "device":
        from knnsvc_torch.dsp.f0_device import device_f0

        f0 = device_f0(x, sr, hop=hop, device=device)
    else:
        try:
            from knnsvc_torch.dsp import harvest as native

            fn = getattr(native, _NATIVE_METHODS[method][0])
            f0 = fn(x, sr, hop=hop)
        except (ImportError, OSError):
            f0 = yin_f0(x, sr, hop=hop)
            cache_used = "yin"  # the fallback must not write Harvest's sidecar
    if write_sidecar and audio_path is not None:
        try:
            # cache under the EXECUTED extractor's name: approximate output
            # must never poison the parity (<stem>_f0.npy) sidecar
            np.save(_sidecar_path(audio_path, cache_used),
                    np.asarray(f0, dtype=np.float32))
        except OSError:
            pass  # read-only source tree
    return f0
