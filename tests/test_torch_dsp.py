"""knnsvc_torch DSP and vocoder against the JAX package on the CPU: linear
spectrogram, harmonic amplitudes, the excitations, and `vocode` for the MIX
and F0_ONLY families (waveforms within 2e-4, COMPONENTS.md §2.3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.dsp.stft import linear_spectrogram as jax_linear_spectrogram
from knnsvc_tpu.dsp.synth import harmonic_synth as jax_harmonic_synth
from knnsvc_tpu.dsp.synth import sine_excitation as jax_sine_excitation
from knnsvc_tpu.match.pool import harmonic_amplitudes_jax
from knnsvc_tpu.models.hifigan.generator import vocode
from knnsvc_torch.dsp.stft import linear_spectrogram
from knnsvc_torch.dsp.synth import harmonic_synth, sine_excitation
from knnsvc_torch.io.jax_params import generator_from_numpy
from knnsvc_torch.match.pool import harmonic_amplitudes

from test_torch_common import _sing, small_generator


def _f0_track(T, seed):
    """Voiced 90-900 Hz with unvoiced runs, as the extractors emit."""
    rng = np.random.default_rng(seed)
    f0 = (90 + 810 * rng.random(T)).astype(np.float32)
    f0[rng.random(T) < 0.25] = 0.0
    f0[:3] = 0.0
    return f0


def test_audio_io_matches_jax(tmp_path):
    """The port's numpy copy of io/audio.py: a stereo 22.05 kHz WAV written
    by the JAX package reads, downmixes and resamples to 16 kHz identically;
    FLAC is refused."""
    from knnsvc_tpu.io import audio as jax_audio
    from knnsvc_torch.io import audio

    stereo = np.stack([_sing(22050, 0.5, 200, seed=2), _sing(22050, 0.5, 330, seed=3)])
    path = tmp_path / "stereo.wav"
    jax_audio.save_audio(path, stereo, 22050)
    (want, want_sr), (got, got_sr) = jax_audio.load_audio(path), audio.load_audio(path)
    assert got_sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        audio.resample(audio.to_mono(got), 22050, 16000),
        jax_audio.resample(jax_audio.to_mono(want), 22050, 16000))
    with pytest.raises(NotImplementedError):
        audio.load_audio(tmp_path / "x.flac")


def test_get_f0_yin_and_sidecars_match_jax(tmp_path):
    """YIN is the same numpy code in both; the sidecar contract is kept:
    a computed track is cached under the method's name, and the parity
    sidecar `<stem>_f0.npy` wins over every method's own cache."""
    from knnsvc_tpu.dsp import f0 as jax_f0
    from knnsvc_torch.dsp import f0 as port_f0

    wav = _sing(16000, 0.8, 220, seed=4)
    np.testing.assert_array_equal(port_f0.yin_f0(wav, 16000), jax_f0.yin_f0(wav, 16000))
    for mod, name in ((jax_f0, "jax"), (port_f0, "port")):
        audio_path = str(tmp_path / f"{name}.wav")
        first = mod.get_f0(wav, 16000, audio_path=audio_path, method="yin")
        assert (tmp_path / f"{name}_f0_yin.npy").is_file()
        mod.save_f0_sidecar(audio_path, np.full_like(first, 123.0))
        assert (mod.get_f0(wav, 16000, audio_path=audio_path, method="yin") == 123.0).all()
    with pytest.raises(NotImplementedError):
        port_f0.get_f0(wav, 16000, method="device")


def test_linear_spectrogram_matches_jax():
    wav = _sing(16000, 1.3, 230, seed=1)
    want = np.asarray(jax_linear_spectrogram(jnp.asarray(wav)))
    got = linear_spectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (len(wav) // 320 + 1, 200)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_harmonic_amplitudes_matches_jax():
    """Same spectrogram and f0 (with unvoiced frames) in: the gathered bins
    must agree exactly, so the values agree to float32 rounding."""
    rng = np.random.default_rng(4)
    T = 120
    spec = (rng.random((T, 200)) * 2).astype(np.float32)
    f0 = _f0_track(T, seed=5)
    want = np.asarray(harmonic_amplitudes_jax(jnp.asarray(spec), jnp.asarray(f0)))
    got = harmonic_amplitudes(torch.from_numpy(spec), torch.from_numpy(f0)).numpy()
    assert got.shape == (T, 49) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[f0 == 0, 1:], 0.0)


def test_excitations_match_jax():
    """fp64 cumsum-and-round phase (the port) vs the JAX package's fp32
    wrap-scan over the same fp32 steps: the wrapped phases agree to ~1e-7
    cycles over 2 s, so the excitations agree within 2e-4."""
    rng = np.random.default_rng(6)
    T = 100
    f0 = _f0_track(T, seed=7)[None, :, None]
    amp = (0.1 * rng.random((1, T, 49))).astype(np.float32)
    want = np.asarray(jax_harmonic_synth(jnp.asarray(f0), jnp.asarray(amp)))
    got = harmonic_synth(torch.from_numpy(f0), torch.from_numpy(amp)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    want = np.asarray(jax_sine_excitation(jnp.asarray(f0)))
    got = sine_excitation(torch.from_numpy(f0)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("ckpt_type", ["mix", "wavlm_only"])
def test_vocode_matches_jax(ckpt_type):
    h, jh, fam, jfam, params = small_generator(ckpt_type)
    model = generator_from_numpy(params, h, fam)
    rng = np.random.default_rng(8)
    T = 60
    feats = rng.standard_normal((1, T, h.hubert_dim)).astype(np.float32)
    f0 = _f0_track(T, seed=9)[None, :, None]
    harm = (0.05 * rng.random((1, T, 49))).astype(np.float32) if ckpt_type == "mix" else None
    want = np.asarray(vocode(params, jh, jfam, jnp.asarray(feats), jnp.asarray(f0),
                             None if harm is None else jnp.asarray(harm)))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(f0),
                    None if harm is None else torch.from_numpy(harm)).numpy()
    assert got.shape == want.shape == (1, T * 320)
    assert np.abs(want).max() > 1e-2, "rescaled weights must give a real waveform"
    np.testing.assert_allclose(got, want, atol=2e-4)
