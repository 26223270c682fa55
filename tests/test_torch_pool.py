"""knnsvc_torch.match.pool.build_device_pool against the JAX package's on
the CPU, on a 31-s utterance: two 30-s chunks, each padded by the
reference's hop quirk, each chunk's spectrogram sliced at its offset."""

import numpy as np
import pytest
import torch

from knnsvc_tpu.match.pool import build_device_pool as jax_build_device_pool
from knnsvc_tpu.match.pool import harmonic_amplitudes_jax
from knnsvc_torch.dsp.f0 import save_f0_sidecar
from knnsvc_torch.io.jax_params import wavlm_from_numpy
from knnsvc_torch.match.pool import build_device_pool, harmonic_amplitudes
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import _sing, _vibrato_f0, small_wavlm


@pytest.mark.parametrize("seconds", [31.0, 1.0 + 320 / 16000])  # two chunks; hop-aligned
def test_build_device_pool_matches_jax(tmp_path, seconds):
    cfg, jcfg, params = small_wavlm()
    weights = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    wav = _sing(16000, seconds, 230, seed=7)
    audio_path = str(tmp_path / "utt.wav")
    save_f0_sidecar(audio_path, _vibrato_f0(len(wav) // 320 + 1, 230, seed=7))

    want = jax_build_device_pool(wav, params, jcfg, weights, weights, audio_path=audio_path)
    got = build_device_pool(wav, wavlm_from_numpy(params, cfg), weights, weights,
                            audio_path=audio_path)
    assert got.matching.shape == tuple(want.matching.shape)
    assert got.synth is got.matching
    np.testing.assert_allclose(got.matching.numpy(), np.asarray(want.matching), atol=2e-4)
    np.testing.assert_allclose(got.spec.numpy(), np.asarray(want.spec), rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(got.f0.numpy(), np.asarray(want.f0))
    np.testing.assert_allclose(harmonic_amplitudes(got.spec, got.f0).numpy(),
                               np.asarray(harmonic_amplitudes_jax(want.spec, want.f0)),
                               rtol=1e-4, atol=1e-6)


def test_failed_f0_reraises_on_every_access(monkeypatch):
    from knnsvc_torch.match import pool as pool_mod

    def boom(*args, **kwargs):
        raise RuntimeError("extractor exploded")

    monkeypatch.setattr(pool_mod, "get_f0", boom)
    cfg, _, params = small_wavlm()
    weights = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    pool = build_device_pool(_sing(16000, 0.5, 200, seed=1), wavlm_from_numpy(params, cfg),
                             weights, weights)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="exploded"):
            _ = pool.f0
    assert isinstance(pool.matching, torch.Tensor)
