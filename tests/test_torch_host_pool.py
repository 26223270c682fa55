"""The port's host pools, host-pool pair path and legacy knn-vc surface
against the JAX package on the CPU: vad_trim, build_speaker_pool on a
folder of 3 utterances (one longer than a 30-s chunk), its .npz round trip
and on-disk cache, convert_pair(fast=False) for mix and wavlm_only without
and with post_opt_0.2 (the float waveform), and KnnSvc.get_matching_set /
match / self_match / vocode_batch.

Tolerances: audio frames, f0 and the harmonic bins exactly (the numpy
harmonic_amplitudes is copied); the spectrogram as test_torch_pool.py
(rtol 1e-4, atol 2e-5: FFT summation order); features at the WavLM
tolerance 2e-4 (test_torch_wavlm.py); waveforms at 2e-4 (COMPONENTS.md
§2.3)."""

import jax
import numpy as np
import pytest
import torch

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_tpu.io.vad import vad_trim as jax_vad_trim
from knnsvc_tpu.match.pipeline import ConversionFeatures as JaxConversionFeatures
from knnsvc_tpu.match.pool import build_speaker_pool as jax_build_speaker_pool
from knnsvc_tpu.match.pool import harmonic_amplitudes as jax_harmonic_amplitudes
from knnsvc_torch.dsp.f0 import save_f0_sidecar
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.io.audio import load_audio, save_audio
from knnsvc_torch.io.jax_params import wavlm_from_numpy
from knnsvc_torch.io.vad import vad_trim
from knnsvc_torch.match import pool as pool_mod
from knnsvc_torch.match.pipeline import ConversionFeatures
from knnsvc_torch.match.pool import (build_speaker_pool, build_speaker_pool_cached,
                                     host_harmonic_amplitudes, load_speaker_pool,
                                     save_speaker_pool)
from knnsvc_torch.ops.attention import gated_bias_attention_diag
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import (SR, _vibrato_f0, small_generator, small_wavlm, vibrato_wav,
                               write_pair)

WAV_ATOL = 2e-4
FEAT_ATOL = 2e-4


@pytest.fixture(scope="module")
def speaker(tmp_path_factory):
    """A speaker folder of three sung utterances with f0 sidecars, the last
    31 s long (two 30-s chunks)."""
    root = tmp_path_factory.mktemp("host_pool") / "spk"
    root.mkdir()
    for name, seconds, hz, seed in (("a", 0.8, 210, 31), ("b", 1.3, 260, 32), ("c", 31.0, 230, 33)):
        wav = vibrato_wav(seconds, hz, seed)
        save_audio(root / f"{name}.wav", wav, SR)
        save_f0_sidecar(str(root / f"{name}.wav"), _vibrato_f0(len(wav) // 320 + 1, hz, seed))
    return root


@pytest.fixture(scope="module")
def models():
    cfg, jcfg, params = small_wavlm()
    return cfg, jcfg, params, generate_matrix_from_index(2, size=cfg.encoder_layers + 1)


def test_vad_trim_matches_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([0.001 * rng.standard_normal(5000), vibrato_wav(1.0, 220, 3),
                        0.001 * rng.standard_normal(7777)]).astype(np.float32)
    for level in (0.0, 3.0, 7.0):
        got, want = vad_trim(x, SR, level), jax_vad_trim(x, SR, level)
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])
    assert vad_trim(x, SR, 7.0)[1] > 0 and vad_trim(x, SR, 7.0)[1] % 320 == 0


def test_host_harmonic_amplitudes_is_the_jax_numpy_copy():
    rng = np.random.default_rng(4)
    spec = np.abs(rng.standard_normal((400, 200))).astype(np.float32)
    f0 = (60 + 1140 * rng.random(400)).astype(np.float32)
    f0[::7] = 0.0
    np.testing.assert_array_equal(host_harmonic_amplitudes(spec, f0),
                                  jax_harmonic_amplitudes(spec, f0))


def test_build_speaker_pool_matches_jax(speaker, models):
    cfg, jcfg, params, w = models
    want = jax_build_speaker_pool(speaker, params, jcfg, w, w)
    got = build_speaker_pool(speaker, wavlm_from_numpy(params, cfg), w, w)
    assert list(got.utterances) == list(want.utterances)
    assert got.utterance_start_indices == want.utterance_start_indices
    assert got.utterance_start_indices[-1] > 1550          # the 31-s utterance: two chunks
    for key, g in got.utterances.items():
        j = want.utterances[key]
        np.testing.assert_array_equal(g.audio, j.audio)
        np.testing.assert_array_equal(g.f0, j.f0)
        np.testing.assert_allclose(g.matching, j.matching, atol=FEAT_ATOL)
        assert g.synth.shape == j.synth.shape
        np.testing.assert_allclose(g.spec, j.spec, rtol=1e-4, atol=2e-5)
        # harmonic bins depend on f0 alone: equal amplitudes on the JAX spectrogram
        np.testing.assert_array_equal(host_harmonic_amplitudes(j.spec, g.f0), j.harmonics)
        np.testing.assert_allclose(g.harmonics, j.harmonics, rtol=1e-4, atol=1e-6)


def test_build_speaker_pool_duration_limit_and_f0_guard(speaker, models, tmp_path):
    cfg, _, params, w = models
    wavlm = wavlm_from_numpy(params, cfg)
    pool = build_speaker_pool(speaker, wavlm, w, w, duration_limit=1.0)
    assert len(pool.utterances) == 2                        # stops after crossing 1 s
    pool = build_speaker_pool(speaker / "a.wav", wavlm, w, w,
                              f0_fn=lambda wav, sr, path: np.zeros(len(wav) // 320 + 1))
    assert (pool.f0 == 0).all()
    with pytest.raises(ValueError, match="f0 has"):
        build_speaker_pool(speaker / "a.wav", wavlm, w, w, f0_fn=lambda wav, sr, path: np.zeros(5))


def test_speaker_pool_npz_round_trip_and_cache(speaker, models, tmp_path, monkeypatch):
    cfg, _, params, w = models
    wavlm = wavlm_from_numpy(params, cfg)
    pool = build_speaker_pool_cached(speaker, wavlm, w, w, cache_dir=tmp_path,
                                     duration_limit=1.0)
    (cache_file,) = tmp_path.glob("spk_*.pool.npz")
    save_speaker_pool(pool, tmp_path / "copy.npz")
    for loaded in (load_speaker_pool(cache_file), load_speaker_pool(tmp_path / "copy.npz")):
        assert list(loaded.utterances) == list(pool.utterances)
        for field in ("matching", "synth", "audio", "spec", "f0", "harmonics"):
            np.testing.assert_array_equal(getattr(loaded, field), getattr(pool, field))

    def no_build(*args, **kwargs):
        raise AssertionError("a cached pool must not be rebuilt")

    monkeypatch.setattr(pool_mod, "build_speaker_pool", no_build)
    again = build_speaker_pool_cached(speaker, wavlm, w, w, cache_dir=tmp_path, duration_limit=1.0)
    np.testing.assert_array_equal(again.matching, pool.matching)
    # another encoder is another key
    with torch.no_grad():
        wavlm.encoder.rel_attn_bias.add_(0.5)
    with pytest.raises(AssertionError, match="rebuilt"):
        build_speaker_pool_cached(speaker, wavlm, w, w, cache_dir=tmp_path, duration_limit=1.0)


def _pair_of_models(ckpt_type, models):
    cfg, jcfg, params, w = models
    h, jh, _, _, gen = small_generator(ckpt_type)
    jknn = JaxKnnSvc(jax.tree.map(np.asarray, params), jcfg, gen, jh, ckpt_type)
    knn = KnnSvc(params, cfg, gen, h, ckpt_type, device="cpu")
    jknn.weighting = knn.weighting = w
    return knn, jknn


@pytest.mark.parametrize("ckpt_type,post_opt", [
    ("mix", "no_post_opt"), ("mix", "post_opt_0.2"),
    ("wavlm_only", "no_post_opt"), ("wavlm_only", "post_opt_0.2")])
def test_convert_pair_host_pool_matches_jax(tmp_path, models, ckpt_type, post_opt):
    """The float waveform (no int16 quantize) of the host-pool path."""
    src, ref = write_pair(tmp_path)
    knn, jknn = _pair_of_models(ckpt_type, models)
    want = load_audio(jknn.convert_pair(src, ref, post_opt=post_opt,
                                        output_path=str(tmp_path / "jax.wav")))[0][0]
    before = gated_bias_attention_diag.launches
    got = load_audio(knn.convert_pair(src, ref, post_opt=post_opt,
                                      output_path=str(tmp_path / "torch.wav")))[0][0]
    assert gated_bias_attention_diag.launches == before        # CPU: the plain version
    assert got.shape == want.shape == (50 * 320,)
    assert np.abs(want).max() > 1e-2
    # not int16 codes: the host-pool path writes the float waveform
    assert np.abs(got * 32768 - np.round(got * 32768)).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)


def test_get_matching_set_match_and_self_match_match_jax(speaker, models):
    knn, jknn = _pair_of_models("wavlm_only", models)
    files = [str(speaker / "a.wav"), str(speaker / "b.wav")]
    got = knn.get_matching_set(files)
    want = jknn.get_matching_set(files)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL)
    # a non-one-hot weighting: the all-layer weighted sum
    mixed = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    np.testing.assert_allclose(knn.get_features(files[0], mixed),
                               jknn.get_features(files[0], mixed), atol=FEAT_ATOL)

    query = want[:30]
    f0 = _vibrato_f0(30, 200, 5)
    for kwargs in ({}, {"target_duration": 0.8}):
        np.testing.assert_allclose(knn.match(query, want, without_vocode=True, **kwargs),
                                   jknn.match(query, want, without_vocode=True, **kwargs),
                                   atol=1e-6)
    wav = knn.match(query, want, query_f0=f0)
    assert np.abs(wav).max() > 1e-2
    np.testing.assert_allclose(wav, jknn.match(query, want, query_f0=f0), atol=WAV_ATOL)
    np.testing.assert_allclose(knn.self_match(want, without_vocode=True),
                               jknn.self_match(want, without_vocode=True), atol=1e-6)
    np.testing.assert_allclose(knn.self_match(query, f0), jknn.self_match(query, f0),
                               atol=WAV_ATOL)


def test_vocode_batch_matches_jax(models):
    """Three utterances of the mix family in two frame buckets (of 50
    frames here, 250 by default): one vocoder call per bucket."""
    ckpt_type = "mix"
    knn, jknn = _pair_of_models(ckpt_type, models)
    rng = np.random.default_rng(6)
    feats = []
    for T in (20, 60, 45):
        harm = (np.abs(rng.standard_normal((T, 49))) * 0.05).astype(np.float32)
        feats.append((rng.standard_normal((T, 64)).astype(np.float32),
                      _vibrato_f0(T, 220, T), harm if ckpt_type == "mix" else None))
    got = knn.vocode_batch([ConversionFeatures(*f) for f in feats], bucket_frames=50)
    want = jknn.vocode_batch([JaxConversionFeatures(*f) for f in feats], bucket_frames=50)
    for g, w, f in zip(got, want, feats):
        assert g.shape == w.shape == (len(f[0]) * 320,)
        assert np.abs(w).max() > 1e-2
        np.testing.assert_allclose(g, w, atol=WAV_ATOL)
    # padding reaches only the samples near the pad boundary: the head of the
    # batched row is the unbatched vocode's
    one = knn.vocode(*feats[0])
    np.testing.assert_allclose(got[0][:3000], one[:3000], atol=1e-5)


def test_get_f0_rejects_another_rate(tmp_path, models):
    knn, _ = _pair_of_models("wavlm_only", models)
    save_audio(tmp_path / "x.wav", vibrato_wav(0.5, 200, 1), 22050)
    with pytest.raises(ValueError, match="22050"):
        knn.get_f0(str(tmp_path / "x.wav"))
