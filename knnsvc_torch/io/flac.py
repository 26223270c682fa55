"""ctypes binding to the native FLAC decoder and encoder (native/flacdec) —
the port's own copy of knnsvc_tpu/io/flac.py, built through
knnsvc_torch/native_util.py.

Enables .flac datasets (LibriSpeech layout) without libsndfile/ffmpeg.
Returns float32 in [-1, 1] like the WAV path (torchaudio normalize=True
semantics). Builds the native tree on first use.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np


_lib = None


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from knnsvc_torch.native_util import load_native_library

    lib = load_native_library("libflacdec.so", "flacdec")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.flacdec_probe.restype = ctypes.c_int
    lib.flacdec_probe.argtypes = [u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_long)]
    lib.flacdec_decode.restype = ctypes.c_int
    lib.flacdec_decode.argtypes = [u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int32),
                                   ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    _lib = lib
    return lib


def decode_flac(path: str, normalize: bool = True) -> tuple[np.ndarray, int]:
    """-> (waveform (channels, T) float32, sample_rate)."""
    lib = _load_library()
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    buf = raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    bits = ctypes.c_int()
    n = ctypes.c_long()
    rc = lib.flacdec_probe(buf, len(raw), ctypes.byref(sr), ctypes.byref(ch),
                           ctypes.byref(bits), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"flac decode failed (probe rc={rc}) for {path}")
    # STREAMINFO declares the length; streams without it get a size headroom
    capacity = n.value if n.value > 0 else max(len(raw) * 4, 1 << 20)
    out = np.zeros(capacity, dtype=np.int32)
    n_out = ctypes.c_long()
    rc = lib.flacdec_decode(buf, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            capacity, ctypes.byref(n_out))
    if rc == 3:  # declared length was short: retry once with the real count
        out = np.zeros(n_out.value, dtype=np.int32)
        rc = lib.flacdec_decode(buf, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                n_out.value, ctypes.byref(n_out))
    if rc != 0:
        raise ValueError(f"flac decode failed (decode rc={rc}) for {path}")
    x = out[: n_out.value].reshape(-1, ch.value).T.astype(np.float32)
    if normalize:
        x = x / float(2 ** (bits.value - 1))
    return np.ascontiguousarray(x), sr.value


def encode_flac(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write (channels, T) or (T,) float [-1,1] / int16 audio as a 16-bit
    FLAC (fixed predictors + Rice residuals; see native/flacdec/flacenc.cc).
    The write-side of the reference's pydub flac export
    (ref lib_ongaku_test.py:118-143; 16-bit here vs pydub's int32 payload —
    documented divergence, FLAC tops out at 24-bit anyway)."""
    lib = _load_library()
    if not hasattr(lib, "_enc_ready"):
        lib.flacenc_encode16.restype = ctypes.c_uint64
        lib.flacenc_encode16.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                         ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.flacenc_copy.restype = None
        lib.flacenc_copy.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib._enc_ready = True

    x = np.asarray(waveform)
    if x.ndim == 1:
        x = x[None]
    if x.dtype != np.int16:
        xf = x.astype(np.float64)
        peak = np.abs(xf).max() if xf.size else 0.0
        if peak > 1:
            xf = xf / peak
        # scale by 32768 (clip the top code) so decode's /32768 round-trips
        # without the 32767/32768 scale skew
        x = np.clip(np.round(xf * 32768.0), -32768, 32767).astype(np.int16)
    interleaved = np.ascontiguousarray(x.T).reshape(-1)
    n_frames = x.shape[1]
    size = lib.flacenc_encode16(
        interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        n_frames, x.shape[0], sample_rate)
    if size == 0:
        raise ValueError("flac encode failed (invalid input)")
    out = np.zeros(int(size), dtype=np.uint8)
    lib.flacenc_copy(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size)
    with open(path, "wb") as f:
        f.write(out.tobytes())
