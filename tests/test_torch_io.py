"""knnsvc_torch.io.loudness and io/flac.py against the JAX package's on the
CPU: the same numpy and native code, so loudness values and FLAC bytes and
samples are identical; and the hub's loudness normalization and FLAC paths.
"""

import numpy as np
import pytest

from knnsvc_tpu.io import audio as jax_audio
from knnsvc_tpu.io import loudness as jax_loudness
from knnsvc_tpu.io.flac import decode_flac as jax_decode_flac
from knnsvc_tpu.io.flac import encode_flac as jax_encode_flac
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io import audio, loudness
from knnsvc_torch.io.flac import decode_flac, encode_flac
from knnsvc_torch.match.pool import load_utterance
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import _sing, small_generator, small_wavlm, write_pair

LOUDNESS_TOL_DB = 0.1


def _wave(seed=0, seconds=2.0, sr=16000):
    rng = np.random.default_rng(seed)
    x = _sing(sr, seconds, 210, seed) + 0.05 * rng.standard_normal(int(sr * seconds))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("sr,seconds", [(16000, 2.0), (22050, 0.3)])  # gated, and one block
def test_loudness_identical_to_jax(sr, seconds):
    x = _wave(1, seconds, sr)
    stereo = np.stack([x, 0.5 * x[::-1]])
    for wave in (x, stereo):
        assert loudness.loudness(wave, sr) == jax_loudness.loudness(wave, sr)
    got = loudness.normalize_loudness(x, sr, -16.0)
    np.testing.assert_array_equal(got, jax_loudness.normalize_loudness(x, sr, -16.0))
    assert abs(loudness.loudness(got, sr) + 16.0) < 1e-3


def test_flac_round_trips_between_packages(tmp_path):
    """FLAC written by either package decodes bit-identically in the
    other, bytes included; int16 input is kept exactly."""
    x = _wave(2)
    codes = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    stereo = np.stack([codes, codes[::-1]])
    for name, wave in (("mono", x), ("stereo", stereo)):
        ours, theirs = tmp_path / f"port_{name}.flac", tmp_path / f"jax_{name}.flac"
        encode_flac(str(ours), wave, 16000)
        jax_encode_flac(str(theirs), wave, 16000)
        assert ours.read_bytes() == theirs.read_bytes()
        (a, sr_a), (b, sr_b) = decode_flac(str(theirs)), jax_decode_flac(str(ours))
        assert sr_a == sr_b == 16000
        np.testing.assert_array_equal(a, b)
    got, _ = decode_flac(str(tmp_path / "port_stereo.flac"), normalize=False)
    np.testing.assert_array_equal(got, stereo.astype(np.float32))


def test_load_and_save_audio_flac(tmp_path):
    """audio.load_audio / save_audio and load_utterance take .flac as the
    JAX package's do (22.05 kHz stereo in, 16 kHz mono out)."""
    stereo = np.stack([_wave(3, 0.6, 22050), _wave(4, 0.6, 22050)])
    path = tmp_path / "utt.flac"
    audio.save_audio(path, stereo, 22050)
    jax_path = tmp_path / "jax_utt.flac"
    jax_audio.save_audio(jax_path, stereo, 22050)
    assert path.read_bytes() == jax_path.read_bytes()
    (got, sr), (want, want_sr) = audio.load_audio(path), jax_audio.load_audio(path)
    assert sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - stereo).max() <= 1.0 / 32768
    from knnsvc_tpu.match.pool import load_utterance as jax_load_utterance

    utt = load_utterance(path)
    assert utt.dtype == np.float32 and utt.shape == (int(np.ceil(0.6 * 16000)),)
    np.testing.assert_array_equal(utt, jax_load_utterance(path))


def test_convert_pair_loudness_and_flac_output(tmp_path):
    """tgt_loudness_db normalizes the downloaded waveform, as the JAX
    package does: the written FLAC measures within LOUDNESS_TOL_DB of the
    target, and equals the JAX package's output within its 2 int16 codes
    before the gain (test_torch_slice.py) times the gain, plus one code of
    each side's 16-bit FLAC rounding."""
    from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc

    src, ref = write_pair(tmp_path)
    cfg, jcfg, wavlm_params = small_wavlm()
    h, jh, _, _, gen_params = small_generator("mix")
    weighting = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    knn = KnnSvc(wavlm_params, cfg, gen_params, h, "mix", device="cpu")
    knn.weighting = weighting
    out = knn.convert_pair(src, ref, fast=True, tgt_loudness_db=-16.0,
                           output_path=str(tmp_path / "out.flac"))
    y, sr = audio.load_audio(out)
    assert sr == 16000 and y.shape == (1, 50 * 320) and np.abs(y).max() <= 1.0
    assert abs(loudness.loudness(y, sr) + 16.0) < LOUDNESS_TOL_DB

    jknn = JaxKnnSvc(wavlm_params, jcfg, gen_params, jh, "mix")
    jknn.weighting = weighting
    want, _ = audio.load_audio(jknn.convert_pair(src, ref, fast=True, tgt_loudness_db=-16.0,
                                                 output_path=str(tmp_path / "jax.flac")))
    plain, _ = audio.load_audio(knn.convert_pair(src, ref, fast=True,
                                                 output_path=str(tmp_path / "plain.wav")))
    gain = float(np.abs(y).max() / np.abs(plain).max())
    assert gain > 1
    assert np.abs(y - want).max() * 32768 <= 2 * gain + 1
