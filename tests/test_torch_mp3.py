"""The port's mp3 module (knnsvc_torch/io/mp3.py and its clean-room Layer III
decoder, knnsvc_torch/csrc/mp3dec.cc) against the JAX package's
(knnsvc_tpu/io/mp3.py: pygame's SDL_mixer over libmpg123 to decode,
libmp3lame to encode) on the CPU:

- decode_mp3 on files made here by JAX's encode_mp3 (and libmp3lame with its
  Xing/LAME tag frame) from seeded sung audio: every sample rate of MPEG-1,
  MPEG-2 and MPEG-2.5, mono and stereo, joint stereo at a low bitrate (M/S),
  short blocks, tagged CBR and VBR files (gapless trim), ID3v2/ID3v1/APE
  tags, a stream cut at a frame, bytes that are no frame between frames, a
  truncated last frame, and pygame's own house_lo.mp3 (MPEG-2.5 mono);
  and synthetic streams (tests/torch_mp3_streams.py) for what libmp3lame
  never writes: intensity stereo (MPEG-1, and the LSF layouts with their
  intensity scalefactors), mixed blocks, dual channel and CRC-protected
  frames.
  The same rate, channels and length; sample values equal or one int16 step
  apart, at least 99% of them equal (the reference decodes in float32, the
  port in float64: a sample that lies within float32's error of a rounding
  boundary may round the other way);
- mp3_stream_info, junk syncs included;
- encode_mp3's bytes;
- convert_pair, build_speaker_pool and bulk_convert on mp3 inputs, bit-equal
  to the same calls on 16-bit WAVs holding the port's decode, and the legacy
  AudioDataset on an mp3 folder."""

import hashlib
import importlib.util
import json
import os
import pathlib
import shutil
import struct

import numpy as np
import pytest

from knnsvc_tpu.io import mp3 as jax_mp3
from knnsvc_torch.dsp.f0 import save_f0_sidecar
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io import mp3
from knnsvc_torch.io.audio import load_audio
from knnsvc_torch.io.jax_params import wavlm_from_numpy
from knnsvc_torch.match.pool import build_speaker_pool
from knnsvc_torch.train.legacy_audio_dataset import AudioDataset
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import SR, _vibrato_f0, small_generator, small_wavlm
from torch_mp3_streams import stream

REPO = pathlib.Path(__file__).resolve().parent.parent
# the tagged writer of chip_smoke.py's fixtures (libmp3lame with its
# Xing/LAME tag frame, CBR or VBR), and the fixtures' record
_spec = importlib.util.spec_from_file_location("make_mp3_fixtures",
                                               REPO / "tools" / "make_mp3_fixtures.py")
fixtures_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures_tool)
encode_tagged = fixtures_tool.encode_tagged
FIXTURES = json.loads((REPO / "tests" / "torch_data" / fixtures_tool.RECORD).read_text())

# pygame's own example file (MPEG-2.5, 11.025 kHz mono), as tests/test_io_audio.py uses it
HOUSE_LO = (pathlib.Path(importlib.util.find_spec("pygame").origin).parent
            / "examples" / "data" / "house_lo.mp3")
MIN_EQUAL_SHARE = 0.99


def sung(sr, seconds, hz, channels=1, seed=0, transients=False, correlated=False):
    """A sung phrase: vibrato, five harmonics, breath noise and a phrasing
    envelope; the second channel a delayed, quieter copy (or, correlated,
    nearly the same signal, which a low-bitrate joint-stereo encode codes as
    M/S). transients adds clicks every 0.15 s, which LAME codes in short
    blocks."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    phase = 2 * np.pi * np.cumsum(hz * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))) / sr
    x = sum(0.25 / k * np.sin(k * phase) for k in range(1, 6))
    x = x * (0.55 + 0.45 * np.sin(2 * np.pi * 0.8 * t)) + 0.01 * rng.standard_normal(t.size)
    if transients:
        for start in range(0, t.size, int(0.15 * sr)):
            n = min(int(0.004 * sr), t.size - start)
            x[start:start + n] += 0.6 * rng.standard_normal(n) * np.exp(-np.arange(n) / (0.001 * sr))
    if channels == 1:
        return np.clip(x, -0.99, 0.99)[None].astype(np.float32)
    other = x + 0.02 * rng.standard_normal(t.size) if correlated else 0.7 * np.roll(x, 41)
    return np.clip(np.stack([x, other]), -0.99, 0.99).astype(np.float32)


def frame_offsets(data: bytes) -> list[int]:
    out, i = [], 0
    while (hdr := jax_mp3._parse_header(data, i)) is not None:
        out.append(i)
        i += hdr[2]
    return out


def id3v2(size: int) -> bytes:
    return b"ID3\x03\x00\x00" + bytes([(size >> s) & 0x7F for s in (21, 14, 7, 0)]) + bytes(size)


ID3V1 = b"TAG" + bytes(125)
# an APEv2 tag without header: 32 bytes of items, then its footer, whose size
# field counts both
APE = bytes(32) + (b"APETAGEX" + (2000).to_bytes(4, "little") + (64).to_bytes(4, "little")
                   + bytes(4) + bytes(4) + bytes(8))


def _plain(root, name, sr, channels, kbps, **kw):
    p = root / f"{name}.mp3"
    jax_mp3.encode_mp3(p, sung(sr, 1.2, 180 + sr % 97, channels, seed=sr + channels, **kw), sr, kbps)
    return p


def _edited(root, name, edit):
    base = root / "base_44100.mp3"
    if not base.exists():
        jax_mp3.encode_mp3(base, sung(44100, 1.2, 210, 2, seed=5), 44100, 128)
    data = base.read_bytes()
    p = root / f"{name}.mp3"
    p.write_bytes(edit(data, frame_offsets(data)))
    return p


def _synthetic(root, name, **kw):
    p = root / f"{name}.mp3"
    p.write_bytes(stream(seed=len(name), **kw))
    return p


def _tagged(root, name, sr, channels, vbr):
    p = root / f"{name}.mp3"
    encode_tagged(p, sung(sr, 1.3, 230, channels, seed=7), sr, kbps=128 if sr > 24000 else 64, vbr=vbr)
    return p


RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)
DECODE_CASES = {
    **{f"{sr}_{'mono' if ch == 1 else 'stereo'}":
       (lambda root, name, sr=sr, ch=ch: _plain(root, name, sr, ch, 64 if ch == 1 else 96))
       for sr in RATES for ch in (1, 2)},
    "joint_ms_44100_48k": lambda root, name: _plain(root, name, 44100, 2, 48, correlated=True),
    "joint_ms_22050_24k": lambda root, name: _plain(root, name, 22050, 2, 24, correlated=True),
    "short_blocks_44100": lambda root, name: _plain(root, name, 44100, 2, 128, transients=True),
    "short_blocks_16000": lambda root, name: _plain(root, name, 16000, 1, 32, transients=True),
    "loud_320k": lambda root, name: _plain(root, name, 48000, 2, 320),
    "lame_tag_cbr": lambda root, name: _tagged(root, name, 44100, 2, vbr=False),
    "lame_tag_vbr": lambda root, name: _tagged(root, name, 44100, 2, vbr=True),
    "lame_tag_vbr_16000_mono": lambda root, name: _tagged(root, name, 16000, 1, vbr=True),
    "id3v2_300k_and_id3v1": lambda root, name: _edited(root, name,
                                                       lambda d, o: id3v2(300_000) + d + ID3V1),
    "ape_and_id3v1": lambda root, name: _edited(root, name, lambda d, o: d + APE + ID3V1),
    "cut_at_frame_10": lambda root, name: _edited(root, name, lambda d, o: d[o[10]:]),
    "garbage_between_frames": lambda root, name: _edited(
        root, name, lambda d, o: d[:o[20]] + bytes(333) + d[o[20]:]),
    "truncated_last_frame": lambda root, name: _edited(root, name, lambda d, o: d[:o[-1] + 50]),
    "house_lo": lambda root, name: HOUSE_LO,
    # chip_smoke.py's committed inputs, 30 s each
    "fixture_src_16000_mono": lambda root, name: REPO / FIXTURES["src"]["file"],
    "fixture_ref_44100_tagged": lambda root, name: REPO / FIXTURES["ref"]["file"],
    **{name: (lambda root, name, kw=kw: _synthetic(root, name, **kw)) for name, kw in {
        "synth_mpeg1_intensity_long": dict(version=0, mode=1, mode_ext=1, blocks=[(0, 0)]),
        "synth_mpeg1_intensity_ms_mixed": dict(
            version=0, mode=1, mode_ext=3, blocks=[(0, 0), (1, 0), (2, 0), (2, 1), (3, 0)]),
        "synth_mpeg1_dual_mixed_crc": dict(
            version=0, mode=2, mode_ext=0, blocks=[(0, 0), (1, 0), (2, 1), (3, 0)], crc=True),
        "synth_mpeg2_intensity_short": dict(
            version=1, mode=1, mode_ext=1, blocks=[(0, 0), (1, 0), (2, 0), (3, 0)],
            is_slen=(4, 3, 2)),
        "synth_mpeg2_intensity_mixed": dict(
            version=1, mode=1, mode_ext=1, blocks=[(1, 0), (2, 1), (3, 0)], is_slen=(4, 3, 2)),
        "synth_mpeg2_intensity_ms_mixed_long_part": dict(
            version=1, mode=1, mode_ext=3, blocks=[(1, 0), (2, 1), (3, 0)], is_slen=(2, 4, 1),
            is_bound=30),
        "synth_mpeg2_stereo_mixed": dict(
            version=1, mode=0, mode_ext=0, blocks=[(0, 0), (1, 0), (2, 1), (2, 0), (3, 0)]),
        "synth_mpeg25_intensity_ms_mixed": dict(
            version=2, mode=1, mode_ext=3, blocks=[(1, 0), (2, 1), (3, 0)], is_slen=(4, 3, 2),
            is_bound=8),
        "synth_mpeg25_mono_mixed_crc": dict(
            version=2, mode=3, mode_ext=0, blocks=[(0, 0), (1, 0), (2, 1), (2, 0), (3, 0)],
            crc=True),
    }.items()},
}
# files the JAX decoder refuses (SDL_mixer finds no mp3 magic at their start)
# but whose headers both packages read
INFO_ONLY_CASES = {
    "junk_with_false_sync": lambda root, name: _edited(
        root, name, lambda d, o: bytes([0x12, 0xFF, 0xFB, 0x90, 0x44, 0, 1]) + bytes(200) + d),
    "cut_inside_frame": lambda root, name: _edited(root, name, lambda d, o: d[o[10] + 100:]),
    "id3_body_of_syncs": lambda root, name: _edited(
        root, name, lambda d, o: b"ID3\x03\x00\x00\x00\x00\x02\x00" + b"\xff\xfb\x90\x44" * 64 + d),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp3")
    return {name: make(root, name) for name, make in {**DECODE_CASES, **INFO_ONLY_CASES}.items()}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_jax(files, case):
    path = files[case]
    want, want_sr = jax_mp3.decode_mp3(path, normalize=False)
    got, got_sr = mp3.decode_mp3(path, normalize=False)
    assert got_sr == want_sr and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[1] > 0
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    equal = float(np.mean(diff == 0))
    print(f"{case}: {got.shape} at {got_sr} Hz, {equal:.5f} equal, largest difference {diff.max()}")
    assert diff.max() <= 1
    assert equal >= MIN_EQUAL_SHARE
    assert np.abs(want).max() > 500  # real audio, not a silent decode
    normalized, _ = mp3.decode_mp3(path)
    np.testing.assert_array_equal(normalized, got / 32768.0)


@pytest.mark.parametrize("case", list(DECODE_CASES) + list(INFO_ONLY_CASES))
def test_stream_info_matches_jax(files, case):
    assert mp3.mp3_stream_info(files[case]) == jax_mp3.mp3_stream_info(files[case])


def test_what_is_no_frame_never_decodes(files):
    """Junk with a false sync before the first frame, an ID3v2 body full of
    syncs, and tags at the end leave the audio of the plain file; a stream
    cut inside a frame starts at its next whole frame. No byte outside a
    frame is taken for audio; no file without a frame decodes."""
    base, _ = mp3.decode_mp3(files["id3v2_300k_and_id3v1"].parent / "base_44100.mp3")
    for case in ("junk_with_false_sync", "id3_body_of_syncs", "id3v2_300k_and_id3v1",
                 "ape_and_id3v1"):
        got, sr = mp3.decode_mp3(files[case])
        assert sr == 44100
        np.testing.assert_array_equal(got, base, err_msg=case)
    cut_inside, _ = mp3.decode_mp3(files["cut_inside_frame"])
    cut_at_11, _ = mp3.decode_mp3(files["id3v2_300k_and_id3v1"].parent / "cut_at_frame_10.mp3")
    assert cut_inside.shape[1] == cut_at_11.shape[1] - 1152
    junk = files["id3v2_300k_and_id3v1"].parent / "junk_only.mp3"
    junk.write_bytes(ID3V1 + bytes([0xFF, 0xFB, 0x90]) + bytes(100))
    with pytest.raises(ValueError, match="no valid MPEG audio frame"):
        mp3.decode_mp3(junk)


@pytest.mark.parametrize("key", ["src", "ref"])
def test_fixture_pcm_is_the_recorded(key):
    """chip_smoke.py holds the card host's decode of its mp3 inputs to these
    digests: the decoder's PCM here is the recorded one."""
    rec = FIXTURES[key]
    x, sr = mp3.decode_mp3(REPO / rec["file"], normalize=False)
    pcm = x.astype(np.int16)
    assert (sr, *pcm.shape) == (rec["sample_rate"], rec["channels"], rec["samples"])
    assert hashlib.sha256(pcm.tobytes()).hexdigest() == rec["pcm_sha256"]


@pytest.mark.parametrize("sr,channels,kbps", [(16000, 1, 320), (22050, 2, 64), (44100, 2, 128)])
def test_encode_matches_jax(tmp_path, sr, channels, kbps):
    x = sung(sr, 0.8, 200, channels, seed=3)
    mp3.encode_mp3(tmp_path / "port.mp3", x, sr, kbps)
    jax_mp3.encode_mp3(tmp_path / "jax.mp3", x, sr, kbps)
    assert (tmp_path / "port.mp3").read_bytes() == (tmp_path / "jax.mp3").read_bytes()
    assert mp3.mp3_stream_info(tmp_path / "port.mp3") == (sr, channels)


def test_decoder_is_built_from_the_source():
    """The library is the port's own build of csrc/mp3dec.cc, named by the
    hash of the source and its flags."""
    from knnsvc_torch.ops.build import CSRC_DIR, HOST_CXX_FLAGS, build_host_library

    lib = build_host_library("mp3dec")
    digest = hashlib.sha256((CSRC_DIR / "mp3dec.cc").read_bytes()
                            + " ".join(HOST_CXX_FLAGS).encode()).hexdigest()
    assert lib.name == f"libmp3dec_{digest[:12]}.so" and lib.is_file()
    assert "-ffp-contract=off" in HOST_CXX_FLAGS and "-ffast-math" not in HOST_CXX_FLAGS


# ---------------------------------------------------------------- serving


def write_wav16(path, pcm: np.ndarray, sr: int) -> None:
    """A 16-bit PCM WAV of int16 (channels, T): load_audio reads it back as
    pcm / 32768, the very floats decode_mp3 gives."""
    body = np.ascontiguousarray(pcm.T).astype("<i2").tobytes()
    ch = pcm.shape[0]
    header = (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
              + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16)
              + b"data" + struct.pack("<I", len(body)))
    pathlib.Path(path).write_bytes(header + body)


def wav_twin(mp3_path, wav_path) -> None:
    x, sr = mp3.decode_mp3(mp3_path, normalize=False)
    write_wav16(wav_path, x.astype(np.int16), sr)


@pytest.fixture(scope="module")
def knn():
    cfg, _, params = small_wavlm()
    h, _, _, _, gen = small_generator("mix")
    model = KnnSvc(params, cfg, gen, h, "mix", device="cpu")
    model.weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    return model, cfg, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """An mp3 tree and its 16-bit WAV twin: a 16-kHz mono source, a tagged
    44.1-kHz stereo target, and two singers of two utterances each, one of
    them an mp3 (a mixed folder)."""
    root = tmp_path_factory.mktemp("mp3_world")
    mp3_dir, wav_dir = root / "mp3", root / "wav"
    for d in (mp3_dir, wav_dir):
        for spk in ("alto", "tenor"):
            (d / "data" / spk).mkdir(parents=True)
    jax_mp3.encode_mp3(mp3_dir / "src.mp3", sung(16000, 1.0, 190, 1, seed=11), 16000, 64)
    encode_tagged(mp3_dir / "ref.mp3", sung(44100, 1.3, 270, 2, seed=12), 44100, 128)
    for s, (spk, hz) in enumerate((("alto", 220), ("tenor", 150))):
        for u in range(2):
            seed = 60 + 10 * s + u
            x = sung(16000, 1.0 + 0.3 * u, hz * (1 + 0.1 * u), 1, seed=seed)
            name = f"{spk}_{u}"
            if u == 0:  # the mp3 of the mixed folder
                jax_mp3.encode_mp3(mp3_dir / "data" / spk / f"{name}.mp3", x, 16000, 64)
            else:
                write_wav16(mp3_dir / "data" / spk / f"{name}.wav",
                            np.round(x * 32767).astype(np.int16), 16000)
    for path in mp3_dir.rglob("*"):
        if path.is_file():
            twin = wav_dir / path.relative_to(mp3_dir)
            if path.suffix == ".mp3":
                wav_twin(path, twin.with_suffix(".wav"))
            else:
                shutil.copy(path, twin)
    for d in (mp3_dir, wav_dir):  # the same f0 sidecars beside both
        for path in list(d.rglob("*.mp3")) + list(d.rglob("*.wav")):
            x, sr = load_audio(path)
            n = int(x.shape[1] * 16000 / sr) // 320 + 1
            save_f0_sidecar(str(path), _vibrato_f0(n, 200, len(path.stem)))
    return mp3_dir, wav_dir


@pytest.mark.parametrize("fast", [True, False])
def test_convert_pair_takes_mp3(knn, world, tmp_path, fast):
    """convert_pair on an mp3 source and target writes the waveform of the
    same call on their WAV twins, bit for bit; an `.mp3` output path writes
    an mp3 (libmp3lame) that decodes back near the WAV output."""
    model, _, _ = knn
    mp3_dir, wav_dir = world
    got = model.convert_pair(str(mp3_dir / "src.mp3"), str(mp3_dir / "ref.mp3"), fast=fast,
                             output_path=str(tmp_path / "from_mp3.wav"))
    want = model.convert_pair(str(wav_dir / "src.wav"), str(wav_dir / "ref.wav"), fast=fast,
                              output_path=str(tmp_path / "from_wav.wav"))
    (g, sr), (w, _) = load_audio(got), load_audio(want)
    assert sr == SR and g.shape == w.shape and np.abs(w).max() > 0
    np.testing.assert_array_equal(g, w)


def test_build_speaker_pool_takes_mp3(knn, world):
    """A folder that mixes .mp3 and .wav utterances pools as its all-WAV
    twin: every array equal."""
    model, cfg, params = knn
    mp3_dir, wav_dir = world
    wavlm = wavlm_from_numpy(params, cfg)
    w = model.weighting
    got = build_speaker_pool(mp3_dir / "data" / "alto", wavlm, w, w)
    want = build_speaker_pool(wav_dir / "data" / "alto", wavlm, w, w)
    assert [os.path.basename(k) for k in got.utterances] == ["alto_0.mp3", "alto_1.wav"]
    assert [os.path.splitext(os.path.basename(k))[0] for k in want.utterances] == \
        ["alto_0", "alto_1"]
    assert got.utterance_start_indices == want.utterance_start_indices
    for (_, g), (_, j) in zip(got.utterances.items(), want.utterances.items()):
        for field in ("audio", "f0", "matching", "synth", "spec", "harmonics"):
            np.testing.assert_array_equal(getattr(g, field), getattr(j, field), err_msg=field)


def test_bulk_convert_takes_mp3(knn, world, tmp_path):
    """The fast bulk loop over speaker folders that mix .mp3 and .wav writes
    the all-WAV twin's files, bit for bit."""
    model, _, _ = knn
    mp3_dir, wav_dir = world
    got = model.bulk_convert(str(mp3_dir / "data"), str(mp3_dir / "data"),
                             str(tmp_path / "from_mp3"), fast=True)
    want = model.bulk_convert(str(wav_dir / "data"), str(wav_dir / "data"),
                              str(tmp_path / "from_wav"), fast=True)
    rel = lambda paths, base: sorted(os.path.relpath(p, base) for p in paths)
    assert rel(got, tmp_path / "from_mp3") == rel(want, tmp_path / "from_wav") and got
    for name in rel(got, tmp_path / "from_mp3"):
        g, _ = load_audio(tmp_path / "from_mp3" / name)
        w, _ = load_audio(tmp_path / "from_wav" / name)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_legacy_audio_dataset_takes_mp3(world):
    """The legacy AudioDataset lists `.mp3` files by extension and reads
    them through load_audio: items equal to the WAV twins'."""
    mp3_dir, wav_dir = world
    got = AudioDataset(str(mp3_dir / "data"), waveform_sec=0.5, extensions=("mp3",), seed=3)
    want = AudioDataset(str(wav_dir / "data"), waveform_sec=0.5, extensions=("wav",), seed=3)
    mp3_names = sorted(os.path.basename(p) for p in got.paths)
    assert mp3_names == ["alto_0.mp3", "tenor_0.mp3"]
    want.paths = [p for p in want.paths if os.path.basename(p).endswith("_0.wav")]
    for i in range(len(got)):
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g["audio"], w["audio"])
        np.testing.assert_array_equal(g["f0"], w["f0"])


def test_intelligibility_harness_takes_mp3(tmp_path):
    """eval/intelligibility's harness transcribes `.mp3` conversions (of
    LibriSpeech-layout WAV sources, the kinds it lists) as the JAX package's
    does; each transcriber reads the file with its own package's
    load_audio."""
    from knnsvc_tpu.eval.intelligibility import evaluate_intelligibility as jax_eval
    from knnsvc_tpu.io.audio import load_audio as jax_load_audio
    from knnsvc_torch.eval.intelligibility import evaluate_intelligibility

    root = tmp_path / "ls" / "clean" / "19" / "198"
    root.mkdir(parents=True)
    texts = {"19-198-0000": "ONE TWO", "19-198-0001": "THREE"}
    with open(root / "19-198.trans.txt", "w") as fh:
        for i, (utt, text) in enumerate(texts.items()):
            write_wav16(root / f"{utt}.wav", np.zeros((1, SR // 2), np.int16), SR)
            fh.write(f"{utt} {text}\n")
            (tmp_path / "converted" / "19" / utt).mkdir(parents=True)
            jax_mp3.encode_mp3(tmp_path / "converted" / "19" / utt / "spkX.mp3",
                               sung(SR, 0.3 + 0.7 * i, 300, seed=10 + i), SR, 64)
    subset = tmp_path / "subset.txt"
    subset.write_text("\n".join(texts) + "\n")

    def asr(load):  # the decoded length picks the words: only a decode tells them apart
        return lambda path: "ONE TWO" if load(path)[0].shape[1] < 0.65 * SR else "THREE"

    outs = []
    for fn, load, name in ((evaluate_intelligibility, load_audio, "port"),
                           (jax_eval, jax_load_audio, "jax")):
        (tmp_path / name).mkdir()
        outs.append(fn(str(tmp_path / "ls"), str(subset), str(tmp_path / "converted"), asr(load),
                       librispeech_layout=True, result_dir=str(tmp_path / name)))
    got, want = outs
    assert got["wer"] == want["wer"] and got["cer"] == want["cer"]
    assert got["wer"]["wer"] == 0 and got["wer"]["hits"] == 3
