"""ctypes bindings to the native worldline f0 extractors (native/), the
port's own shim (counterpart of knnsvc_tpu/dsp/harvest.py).

All three share libworldline.so:

- `harvest_f0` — parity-grade Harvest (native/harvest/harvest.cc), the
  algorithm the reference reaches through pyworld (ref
  ddsp_prematch_dataset.py:121-128): floor 65 Hz, ceil 1047 Hz, frame period
  hop/sr*1000 ms;
- `harvest_fast_f0` — the budget Harvest (same binary, coarser grid), the
  serving fast path's extractor (get_f0 method='fast');
- `dio_f0` — DIO+StoneMask (native/worldline/dio.cc), fastest, lowest recall.

All return pyworld's frame layout (n_frames = T//hop + 1) with estimates
below 80 Hz zeroed (ref ddsp_matcher.py:425-426).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from knnsvc_torch.dsp.f0 import F0_CEIL, F0_FLOOR, F0_ZERO_BELOW

_lib = None
_LOAD_LOCK = threading.Lock()
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def _load_library() -> ctypes.CDLL:
    global _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        from knnsvc_torch.native_util import load_native_library

        lib = load_native_library("libworldline.so", "worldline")
        lib.worldline_n_frames.restype = ctypes.c_int
        lib.worldline_n_frames.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        lib.worldline_dio.restype = ctypes.c_int
        lib.worldline_dio.argtypes = [
            _DOUBLE_P, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, _DOUBLE_P,
        ]
        lib.worldline_harvest.restype = ctypes.c_int
        lib.worldline_harvest.argtypes = [
            _DOUBLE_P, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, _DOUBLE_P,
        ]
        lib.worldline_harvest_fast.restype = ctypes.c_int
        lib.worldline_harvest_fast.argtypes = lib.worldline_harvest.argtypes
        _lib = lib
        return lib


def _prep(x: np.ndarray, sr: int, hop: int):
    lib = _load_library()
    xd = np.ascontiguousarray(np.asarray(x, dtype=np.float64).reshape(-1))
    frame_period_ms = hop / sr * 1000.0
    n_frames = lib.worldline_n_frames(len(xd), sr, frame_period_ms)
    out = np.zeros(n_frames, dtype=np.float64)
    return lib, xd, frame_period_ms, out


def _finish(out: np.ndarray) -> np.ndarray:
    f0 = out.astype(np.float32)
    f0[f0 < F0_ZERO_BELOW] = 0.0
    return f0


def _run_harvest(fn_name: str, x, sr, hop, f0_floor, f0_ceil) -> np.ndarray:
    lib, xd, frame_period_ms, out = _prep(x, sr, hop)
    rc = getattr(lib, fn_name)(xd.ctypes.data_as(_DOUBLE_P), len(xd), sr,
                               frame_period_ms, f0_floor, f0_ceil,
                               out.ctypes.data_as(_DOUBLE_P))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed with code {rc}")
    return _finish(out)


def harvest_f0(x: np.ndarray, sr: int, hop: int = 320,
               f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL) -> np.ndarray:
    """Parity-grade Harvest. x (T,) -> f0 (T//hop + 1,) Hz, 0 = unvoiced."""
    return _run_harvest("worldline_harvest", x, sr, hop, f0_floor, f0_ceil)


def harvest_fast_f0(x: np.ndarray, sr: int, hop: int = 320,
                    f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL) -> np.ndarray:
    """Budget Harvest (worldline_harvest_fast): the serving fast path's
    extractor."""
    return _run_harvest("worldline_harvest_fast", x, sr, hop, f0_floor, f0_ceil)


def dio_f0(x: np.ndarray, sr: int, hop: int = 320,
           f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL,
           channels_in_octave: int = 0, dev_threshold: float = 0.0) -> np.ndarray:
    """Fast DIO+StoneMask. Zero/negative tuning params pick the library
    defaults (4 channels/octave, 0.1 voicing threshold)."""
    lib, xd, frame_period_ms, out = _prep(x, sr, hop)
    rc = lib.worldline_dio(xd.ctypes.data_as(_DOUBLE_P), len(xd), sr,
                           frame_period_ms, f0_floor, f0_ceil,
                           channels_in_octave, dev_threshold,
                           out.ctypes.data_as(_DOUBLE_P))
    if rc != 0:
        raise RuntimeError(f"worldline_dio failed with code {rc}")
    return _finish(out)
