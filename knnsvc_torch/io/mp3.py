"""mp3 ingestion and export — the port's own copy of knnsvc_tpu/io/mp3.py
(ref accepts `.mp3` pool audio, ddsp_prematch_dataset.py:313).

Decoding goes through the port's clean-room MPEG-1/2/2.5 Layer III decoder,
knnsvc_torch/csrc/mp3dec.cc, built with the host compiler at first use and
bound with ctypes. It gives the JAX package's decode (pygame's SDL_mixer over
libmpg123) to within one int16 step, most samples exactly:

- PCM is int16, rounded to nearest from the synthesis output at 32768 per
  unit, at the file's own rate: nothing is resampled.
- A Xing/Info tag frame is not audio. With a LAME tag, its encoder delay plus
  the decoder's 529 samples are cut from the start and its padding less 529
  from the end (gapless decoding).
- A frame whose bit reservoir is not there yet (a file cut from a stream)
  decodes from an empty spectrum; after bytes that are no frame the
  reservoir is dropped and the synthesis filter restarts.
- A mono file comes out as SDL's mixer gives it: its int16 samples go
  through float32 and back, v / 32768 * 32767 rounded to nearest.

Output matches load_audio's contract: (channels, T) float32 in [-1, 1].
Encoding reaches libmp3lame through ctypes, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

# MPEG audio frame header tables (ISO 11172-3 / 13818-3)
_SAMPLE_RATES = {
    3: (44100, 48000, 32000),  # MPEG-1
    2: (22050, 24000, 16000),  # MPEG-2
    0: (11025, 12000, 8000),   # MPEG-2.5
}
# Layer III bitrates (kbit/s); MPEG-2/2.5 share the LSF column
_BITRATES_L3 = {
    3: (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),
    2: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
    0: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
}


def _parse_header(data: bytes, i: int):
    """-> (sample_rate, channels, frame_length) or None."""
    if i + 4 > len(data) or data[i] != 0xFF or (data[i + 1] & 0xE0) != 0xE0:
        return None
    version = (data[i + 1] >> 3) & 0x3     # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    layer = (data[i + 1] >> 1) & 0x3       # 1 = Layer III
    sr_idx = (data[i + 2] >> 2) & 0x3
    bitrate_idx = (data[i + 2] >> 4) & 0xF
    padding = (data[i + 2] >> 1) & 0x1
    mode = (data[i + 3] >> 6) & 0x3        # 3 = mono
    if version not in _SAMPLE_RATES or layer != 1 or sr_idx == 3 \
            or bitrate_idx in (0, 15):
        return None
    sr = _SAMPLE_RATES[version][sr_idx]
    bitrate = _BITRATES_L3[version][bitrate_idx] * 1000
    coeff = 144 if version == 3 else 72    # samples-per-frame / 8
    frame_len = coeff * bitrate // sr + padding
    return sr, (1 if mode == 3 else 2), frame_len


def mp3_stream_info(path: str | os.PathLike) -> tuple[int, int]:
    """(sample_rate, channels) from the first frame header that is CONFIRMED
    by a second valid header exactly one frame length later — a lone 11-bit
    sync match inside tag/junk bytes is common."""
    with open(path, "rb") as f:
        head = f.read(10)
        skip = 0
        # skip ID3v2 by its declared size (tags with embedded cover art can
        # exceed any fixed read budget)
        if head[:3] == b"ID3" and len(head) >= 10:
            skip = 10 + (((head[6] & 0x7F) << 21) | ((head[7] & 0x7F) << 14)
                         | ((head[8] & 0x7F) << 7) | (head[9] & 0x7F))
        f.seek(0, os.SEEK_END)
        file_end = f.tell()
        f.seek(skip)
        data = f.read(256 * 1024)
    i = 0
    n = len(data)
    while i + 4 <= n:
        hdr = _parse_header(data, i)
        if hdr is not None:
            sr, channels, frame_len = hdr
            j = i + frame_len
            nxt = _parse_header(data, j)
            if nxt is not None and nxt[0] == sr and nxt[1] == channels:
                return sr, channels
            # a lone header is only trusted when the confirming position is
            # past the END OF FILE (a genuine final frame), not merely past
            # the read buffer — junk syncs near the buffer edge must not win
            if skip + j + 4 > file_end and skip + i + frame_len <= file_end:
                return sr, channels
        i += 1
    raise ValueError(f"no valid MPEG audio frame found in {path}")


_decoder = None


def _load_decoder() -> ctypes.CDLL:
    global _decoder
    if _decoder is None:
        from knnsvc_torch.ops.build import build_host_library

        lib = ctypes.CDLL(str(build_host_library("mp3dec")))
        lib.knnsvc_mp3_decode.restype = ctypes.c_int
        lib.knnsvc_mp3_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.knnsvc_mp3_free.restype = None
        lib.knnsvc_mp3_free.argtypes = [ctypes.c_void_p]
        _decoder = lib
    return _decoder


def _decode_pcm(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """The decoder's own output: ((channels, T) int16, sample_rate)."""
    lib = _load_decoder()
    with open(path, "rb") as f:
        data = f.read()
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    channels = ctypes.c_int()
    rc = lib.knnsvc_mp3_decode(data, len(data), ctypes.byref(out), ctypes.byref(n),
                               ctypes.byref(sr), ctypes.byref(channels))
    if rc != 0:
        raise ValueError(f"no valid MPEG audio frame found in {path}")
    try:
        count = n.value * channels.value
        pcm = np.ctypeslib.as_array(out, shape=(count,)).copy() if count else np.zeros(0, np.int16)
    finally:
        lib.knnsvc_mp3_free(out)
    return np.ascontiguousarray(pcm.reshape(-1, channels.value).T), int(sr.value)


def decode_mp3(path: str | os.PathLike, normalize: bool = True) -> tuple[np.ndarray, int]:
    """Decode an mp3 to ((channels, T) float32 in [-1,1], sample_rate)."""
    pcm, sr = _decode_pcm(path)
    if pcm.shape[0] == 1:
        # SDL's mixer widens a mono stream to its stereo output through
        # float32: s16 -> v / 32768 -> * 32767 -> rounded to nearest even
        f = pcm.astype(np.float32) * np.float32(1.0 / 32768.0)
        pcm = np.rint(f * np.float32(32767.0)).astype(np.int16)
    out = pcm.astype(np.float32)
    if normalize:
        out /= 32768.0
    return out, sr


# ---------------------------------------------------------------------------
# Encoding (ref writes mp3 at 320k through pydub/ffmpeg/libmp3lame,
# lib_ongaku_test.py:118-143). libmp3lame is reached directly via ctypes —
# the same codec the reference's export path bottoms out in.

_LAME_PATHS = (
    "libmp3lame.so.0",
    "libmp3lame.so",
    "/usr/lib/x86_64-linux-gnu/libmp3lame.so.0",
)

# max kbps by MPEG version (ISO 11172-3 / 13818-3 bitrate tables); LAME
# rejects out-of-table rates instead of clamping, and ffmpeg's own mp3 mux
# clamps a 320k request on 16 kHz audio the same way
_MAX_KBPS_MPEG1 = 320    # 32 / 44.1 / 48 kHz
_MAX_KBPS_LSF = 160      # 16 / 22.05 / 24 kHz (MPEG-2) and MPEG-2.5

_lame = None


def _load_lame():
    global _lame
    if _lame is not None:
        return _lame
    lib = None
    for name in _LAME_PATHS:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if lib is None:
        raise NotImplementedError(
            "mp3 encoding needs libmp3lame, which is not present"
        )
    c = ctypes
    lib.lame_init.restype = c.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_out_samplerate",
               "lame_set_num_channels", "lame_set_brate", "lame_set_quality",
               "lame_set_mode", "lame_set_bWriteVbrTag"):
        getattr(lib, fn).restype = c.c_int
        getattr(lib, fn).argtypes = [c.c_void_p, c.c_int]
    lib.lame_init_params.restype = c.c_int
    lib.lame_init_params.argtypes = [c.c_void_p]
    lib.lame_encode_buffer_ieee_float.restype = c.c_int
    lib.lame_encode_buffer_ieee_float.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int,
        c.POINTER(c.c_ubyte), c.c_int,
    ]
    lib.lame_encode_flush.restype = c.c_int
    lib.lame_encode_flush.argtypes = [
        c.c_void_p, c.POINTER(c.c_ubyte), c.c_int]
    lib.lame_close.restype = c.c_int
    lib.lame_close.argtypes = [c.c_void_p]
    _lame = lib
    return lib


def encode_mp3(path: str | os.PathLike, waveform: np.ndarray, sample_rate: int,
               bitrate_kbps: int = 320) -> None:
    """Encode float waveform ((channels, T) or (T,), [-1, 1]) to CBR mp3.

    The requested bitrate is clamped to the MPEG bitrate table for the
    sample rate (320k for >=32 kHz, 160k for the low-sample-frequency
    versions) — the reference's `bitrate="320k"` request goes through the
    identical clamp inside ffmpeg for its 16 kHz outputs.
    """
    lib = _load_lame()
    x = np.asarray(waveform, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[0] > 2:
        raise ValueError(f"mp3 supports mono/stereo, got {x.shape[0]} channels")
    n_ch, n = int(x.shape[0]), int(x.shape[1])

    max_kbps = _MAX_KBPS_MPEG1 if sample_rate >= 32000 else _MAX_KBPS_LSF
    kbps = min(int(bitrate_kbps), max_kbps)

    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        # pin the output rate so LAME never resamples behind our back
        lib.lame_set_out_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, n_ch)
        if n_ch == 1:
            lib.lame_set_mode(gfp, 3)  # MONO
        lib.lame_set_brate(gfp, kbps)
        lib.lame_set_quality(gfp, 2)
        # CBR needs no Xing/Info tag; left on, LAME reserves a first frame
        # meant to be patched via lame_get_lametag_frame after flush — we
        # never patch it, and an unfilled tag frame makes players misreport
        # duration / decode a spurious silence frame
        lib.lame_set_bWriteVbrTag(gfp, 0)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params rejected sr={sample_rate} ch={n_ch} "
                f"brate={kbps}"
            )
        left = np.ascontiguousarray(x[0])
        right = np.ascontiguousarray(x[1] if n_ch == 2 else x[0])
        fptr = ctypes.POINTER(ctypes.c_float)
        buf = (ctypes.c_ubyte * (n + n // 4 + 7200))()
        written = lib.lame_encode_buffer_ieee_float(
            gfp, left.ctypes.data_as(fptr), right.ctypes.data_as(fptr),
            n, buf, len(buf))
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({written})")
        tail = (ctypes.c_ubyte * 7200)()
        flushed = lib.lame_encode_flush(gfp, tail, len(tail))
        if flushed < 0:
            raise RuntimeError(f"lame_encode_flush failed ({flushed})")
        with open(path, "wb") as f:
            f.write(bytes(buf[:written]))
            f.write(bytes(tail[:flushed]))
    finally:
        lib.lame_close(gfp)
