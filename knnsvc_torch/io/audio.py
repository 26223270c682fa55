"""Audio I/O without native library dependencies — the port's own numpy
copy of knnsvc_tpu/io/audio.py.

The reference reads audio with torchaudio/librosa (libsndfile/ffmpeg) and
writes PCM_32 WAV via soundfile (ref lib_ongaku_test.py:89-143). Here WAV I/O
is implemented directly on the RIFF container (numpy), supporting PCM
8/16/24/32-bit and IEEE float. FLAC reads and writes go through the
clean-room native codec (native/flacdec, io/flac.py). mp3 reads go through
the port's clean-room Layer III decoder (csrc/mp3dec.cc, io/mp3.py) and mp3
writes through libmp3lame via ctypes (the codec the reference's
pydub/ffmpeg export bottoms out in).

Output convention matches the reference exactly: float waveforms are peak-
normalized only if |x|>1, scaled by 2^31-1 and written as PCM_32
(ref lib_ongaku_test.py:102-120).
"""

from __future__ import annotations

import os
import struct
from typing import Union

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

_SUPPORTED_WRITE_EXT = {".wav"}


def load_audio(path: Union[str, os.PathLike], normalize: bool = True) -> tuple[np.ndarray, int]:
    """Read an audio file -> (waveform (channels, T) float32 in [-1,1], sr).

    Matches torchaudio.load(path, normalize=True) semantics for WAV.
    """
    path = str(path)
    ext = os.path.splitext(path)[-1].lower()
    if ext == ".flac":
        from knnsvc_torch.io.flac import decode_flac  # native decoder

        return decode_flac(path, normalize=normalize)
    if ext == ".mp3":
        from knnsvc_torch.io.mp3 import decode_mp3  # clean-room Layer III decoder

        return decode_mp3(path, normalize=normalize)
    if ext != ".wav":
        raise NotImplementedError(
            f"Only WAV/FLAC/mp3 decoding is available in this environment (got {ext}); "
            "decode to wav first."
        )
    with open(path, "rb") as f:
        data = f.read()
    return _decode_wav(data, normalize=normalize)


def _decode_wav(data: bytes, normalize: bool = True) -> tuple[np.ndarray, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                (sub_format,) = struct.unpack("<H", body[24:26])
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned
        if fmt is not None and raw is not None:
            break
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, block_align, bits = fmt

    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif audio_format == WAVE_FORMAT_PCM:
        if bits == 16:
            xi = np.frombuffer(raw, dtype="<i2").astype(np.float32)
            scale = 2.0 ** 15
        elif bits == 32:
            xi = np.frombuffer(raw, dtype="<i4").astype(np.float64)
            scale = 2.0 ** 31
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            xi = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            xi = (xi << 8) >> 8  # sign-extend
            xi = xi.astype(np.float64)
            scale = 2.0 ** 23
        elif bits == 8:
            xi = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
            scale = 2.0 ** 7
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
        x = (xi / scale).astype(np.float32) if normalize else xi.astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_format}")

    n_frames = x.size // n_channels
    x = x[: n_frames * n_channels].reshape(n_frames, n_channels).T
    return np.ascontiguousarray(x), int(sample_rate)


def save_audio(filename: Union[str, os.PathLike], waveform, sample_rate: int) -> None:
    """Write waveform to PCM_32 WAV (ref lib_ongaku_test.py:89-143 semantics).

    Accepts float ([-1,1], peak-normalized only when above 1) or int32 arrays,
    shape (T,) or (channels, T).
    """
    filename = str(filename)
    waveform = np.asarray(waveform)
    if waveform.dtype in (np.float32, np.float64):
        abs_max = np.max(np.abs(waveform)) if waveform.size else 0.0
        if abs_max > 1:
            waveform = waveform / abs_max
        # scale in fp64 and clip: fp32 1.0*(2^31-1) rounds to 2^31 and would
        # wrap to INT32_MIN on cast (latent overflow in the reference's
        # float path, lib_ongaku_test.py:111-112 — deliberately not replicated)
        scaled = np.clip(waveform.astype(np.float64) * (2 ** 31 - 1), -(2 ** 31), 2 ** 31 - 1)
        waveform = scaled.astype(np.int32)
    else:
        assert waveform.dtype == np.int32, waveform.dtype

    ext = os.path.splitext(filename)[-1].lower()
    if ext == ".flac":
        from knnsvc_torch.io.flac import encode_flac

        # int32 PCM (the WAV convention) re-enters as float for the 16-bit
        # FLAC quantizer
        encode_flac(filename, waveform.astype(np.float64) / (2 ** 31 - 1), sample_rate)
        return
    if ext == ".mp3":
        from knnsvc_torch.io.mp3 import encode_mp3  # libmp3lame via ctypes

        # int32 PCM re-enters as [-1,1] float for the codec, at the
        # reference's 320k request (clamped by the MPEG bitrate table for
        # 16 kHz audio exactly as ffmpeg clamps it — lib_ongaku_test.py:118)
        encode_mp3(filename, waveform.astype(np.float64) / (2 ** 31 - 1),
                   sample_rate, bitrate_kbps=320)
        return
    if ext not in _SUPPORTED_WRITE_EXT:
        raise NotImplementedError(
            f"Only WAV/FLAC/mp3 encoding is available in this environment (got {ext})."
        )

    if waveform.ndim == 1:
        frames = waveform[:, None]
    else:
        # documented contract: (channels, T) -> interleaved frames, like
        # soundfile's waveform.T (no shape guessing: a (4, 2) input is four
        # channels of two samples, not the other way round)
        frames = waveform.T
    n_channels = frames.shape[1]
    body = frames.astype("<i4").tobytes()

    bits = 32
    byte_rate = sample_rate * n_channels * bits // 8
    block_align = n_channels * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, WAVE_FORMAT_PCM, n_channels, sample_rate, byte_rate, block_align, bits
    )
    header += b"data" + struct.pack("<I", len(body))
    with open(filename, "wb") as f:
        f.write(header + body)


def to_mono(x: np.ndarray) -> np.ndarray:
    """Downmix (channels, T) to (1, T) by mean (ref ddsp_prematch_dataset.py:332-335)."""
    if x.ndim == 2 and x.shape[0] > 1:
        return np.mean(x, axis=0, keepdims=True)
    return x if x.ndim == 2 else x[None, :]


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis.

    Matches torchaudio.functional.resample's algorithm (windowed-sinc kernel,
    lowpass_filter_width=6, rolloff=0.99, Hann window) so resampled pools stay
    numerically close to the reference (ref ddsp_prematch_dataset.py:338-341).
    """
    if orig_sr == new_sr:
        return x
    import math

    gcd = math.gcd(int(orig_sr), int(new_sr))
    up, down = new_sr // gcd, orig_sr // gcd

    lowpass_filter_width = 6
    rolloff = 0.99
    base_freq = min(orig_sr, new_sr) / gcd * rolloff
    width = int(np.ceil(lowpass_filter_width * (orig_sr // gcd) / base_freq))

    idx = np.arange(-width, width + (orig_sr // gcd), dtype=np.float64)[None, :] / (orig_sr // gcd)
    t = np.arange(0, -up, -1, dtype=np.float64)[:, None] / up + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / (orig_sr // gcd)
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window * scale

    x = np.asarray(x, dtype=np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    length = x.shape[-1]
    num_wavs = x.shape[0]
    target_length = int(np.ceil(up * length / down))
    xp = np.pad(x, ((0, 0), (width, width + (orig_sr // gcd))))

    # conv with stride `down`: frame xp and contract against the polyphase bank
    kernel_len = kernels.shape[1]
    n_out_frames = (xp.shape[-1] - kernel_len) // down + 1
    strides = (xp.strides[0], down * xp.strides[1], xp.strides[1])
    frames = np.lib.stride_tricks.as_strided(
        xp, shape=(num_wavs, n_out_frames, kernel_len), strides=strides
    )
    out = np.einsum("bfk,pk->bpf", frames, kernels)  # (B, up, frames)
    out = out.transpose(0, 2, 1).reshape(num_wavs, -1)[:, :target_length]
    out = out.astype(np.float32)
    return out[0] if squeeze else out
