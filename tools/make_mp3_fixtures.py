#!/usr/bin/env python3
"""Writes the mp3 inputs of chip_smoke.py's [mp3] phase to tests/torch_data/
and records, beside them, what the port's decoder gives for each.

    python tools/make_mp3_fixtures.py

The card's machine has no libmp3lame, so the files are made on a host that
has it and committed:
- mp3_src_16k_mono_64k.mp3: chip_smoke.py's source voice (phase 4's seeded
  sung audio) at 16 kHz, mono, 64 kbit/s CBR, through
  knnsvc_torch.io.mp3.encode_mp3 (no tag frame, so nothing is trimmed:
  29.9 s of voice decode to 29.99 s, one 30-s chunk of the encoder);
- mp3_ref_44k_stereo_128k.mp3: its 30-s target voice resampled to 44.1 kHz,
  in stereo (the right channel a delayed, quieter copy), 128 kbit/s CBR joint
  stereo with a Xing/Info tag and LAME's encoder delay and padding in it;
- mp3_fixtures.json: for each file its rate, channels, samples and the
  SHA-256 of the int16 PCM that knnsvc_torch.io.mp3.decode_mp3 gives
  (normalize=False; (channels, T), C order, little-endian).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "tests", "torch_data")
RECORD = "mp3_fixtures.json"
SRC_SECONDS = 29.9   # + LAME's delay and padding, under 30 s decoded
REF_SECONDS = 30.0   # the tag's gapless trim gives back exactly 30 s


def encode_tagged(path, waveform: np.ndarray, sample_rate: int, kbps: int = 128,
                  vbr: bool = False) -> None:
    """libmp3lame at encode_mp3's settings, but with the Xing/Info tag frame
    that lame_get_lametag_frame fills in after the flush; CBR at kbps, or
    LAME's default VBR (vbr_mtrh, quality 4). waveform: (channels, T)
    float in [-1, 1]."""
    from knnsvc_torch.io.mp3 import _load_lame

    c = ctypes
    lib = _load_lame()
    lib.lame_set_VBR.argtypes = [c.c_void_p, c.c_int]
    lib.lame_set_VBR_quality.argtypes = [c.c_void_p, c.c_float]
    lib.lame_get_lametag_frame.restype = c.c_size_t
    lib.lame_get_lametag_frame.argtypes = [c.c_void_p, c.POINTER(c.c_ubyte), c.c_size_t]
    x = np.asarray(waveform, dtype=np.float32)
    n = x.shape[1]
    gfp = lib.lame_init()
    try:
        lib.lame_set_in_samplerate(gfp, sample_rate)
        lib.lame_set_out_samplerate(gfp, sample_rate)
        lib.lame_set_num_channels(gfp, x.shape[0])
        if x.shape[0] == 1:
            lib.lame_set_mode(gfp, 3)  # MONO
        if vbr:
            lib.lame_set_VBR(gfp, 4)
            lib.lame_set_VBR_quality(gfp, 4.0)
        else:
            lib.lame_set_brate(gfp, kbps)
        lib.lame_set_quality(gfp, 2)
        lib.lame_set_bWriteVbrTag(gfp, 1)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError(f"lame_init_params rejected sr={sample_rate} kbps={kbps}")
        fp = c.POINTER(c.c_float)
        left, right = np.ascontiguousarray(x[0]), np.ascontiguousarray(x[-1])
        buf = (c.c_ubyte * (n + n // 4 + 7200))()
        written = lib.lame_encode_buffer_ieee_float(gfp, left.ctypes.data_as(fp),
                                                    right.ctypes.data_as(fp), n, buf, len(buf))
        tail = (c.c_ubyte * 7200)()
        flushed = lib.lame_encode_flush(gfp, tail, len(tail))
        if written < 0 or flushed < 0:
            raise RuntimeError(f"lame_encode failed ({written}, {flushed})")
        data = bytearray(bytes(buf[:written]) + bytes(tail[:flushed]))
        tag = (c.c_ubyte * 4096)()
        size = lib.lame_get_lametag_frame(gfp, tag, len(tag))
        if size == 0:
            raise RuntimeError("lame_get_lametag_frame wrote no tag")
        data[:size] = bytes(tag[:size])  # the tag replaces the frame LAME reserved
    finally:
        lib.lame_close(gfp)
    with open(path, "wb") as f:
        f.write(bytes(data))


def pcm_record(path: str) -> dict:
    from knnsvc_torch.io.mp3 import decode_mp3

    x, sr = decode_mp3(path, normalize=False)
    pcm = x.astype(np.int16)
    return {"file": os.path.relpath(path, REPO), "sample_rate": sr, "channels": pcm.shape[0],
            "samples": pcm.shape[1], "pcm_sha256": hashlib.sha256(pcm.tobytes()).hexdigest()}


def main() -> int:
    sys.path.insert(0, REPO)
    from chip_smoke import VOICES, sung_wav
    from knnsvc_torch.io.audio import resample
    from knnsvc_torch.io.mp3 import encode_mp3

    (_, src_hz, src_seed), (_, ref_hz, ref_seed) = VOICES
    src, _ = sung_wav(SRC_SECONDS, src_hz, src_seed)
    ref16, _ = sung_wav(REF_SECONDS, ref_hz, ref_seed)
    ref = resample(ref16, 16000, 44100)
    ref = np.stack([ref, 0.8 * np.roll(ref, 37)])
    os.makedirs(OUT_DIR, exist_ok=True)
    src_path = os.path.join(OUT_DIR, "mp3_src_16k_mono_64k.mp3")
    ref_path = os.path.join(OUT_DIR, "mp3_ref_44k_stereo_128k.mp3")
    encode_mp3(src_path, src, 16000, bitrate_kbps=64)
    encode_tagged(ref_path, ref, 44100, kbps=128)
    record = {"src": pcm_record(src_path), "ref": pcm_record(ref_path)}
    with open(os.path.join(OUT_DIR, RECORD), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    for key, r in record.items():
        print(f"{key}: {r['file']} ({os.path.getsize(os.path.join(REPO, r['file']))} bytes), "
              f"{r['sample_rate']} Hz x {r['channels']}, {r['samples']} samples, "
              f"PCM sha256 {r['pcm_sha256']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
