"""knnsvc_torch WavLM against the JAX package's encoder on the CPU: the
relative-position buckets exactly, at the full-size config, and the early-exit
layer features within 2e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knnsvc_tpu.models.wavlm.model import compute_position_bias as jax_compute_position_bias
from knnsvc_tpu.models.wavlm.model import relative_position_bucket as jax_bucket
from knnsvc_tpu.models.wavlm.model import frame_count as jax_frame_count
from knnsvc_tpu.models.wavlm.model import wavlm_extract_layer
from knnsvc_torch.config import WavLMConfig
from knnsvc_torch.io.jax_params import wavlm_from_numpy
from knnsvc_torch.models.wavlm.model import (compute_position_bias, frame_count,
                                             relative_position_bucket)

from test_torch_common import _sing, small_wavlm


def test_relative_position_bucket_exact_full_size():
    """Every offset of a 30-s chunk (T=1500) at WavLM-Large's 320 buckets and
    max distance 1280: float32 bucket math, so boundaries fall as in JAX."""
    cfg = WavLMConfig()
    offsets = np.arange(-1499, 1500)
    want = np.asarray(jax_bucket(jnp.asarray(offsets), cfg.num_buckets, cfg.max_distance))
    got = relative_position_bucket(torch.from_numpy(offsets), cfg.num_buckets,
                                   cfg.max_distance).numpy()
    np.testing.assert_array_equal(got, want)


def test_position_bias_and_frame_count():
    cfg = WavLMConfig()
    table = np.random.default_rng(0).standard_normal((cfg.num_buckets, 16)).astype(np.float32)
    want = np.asarray(jax_compute_position_bias(jnp.asarray(table), 300, cfg.num_buckets,
                                                cfg.max_distance))
    got = compute_position_bias(torch.from_numpy(table), 300, cfg.num_buckets,
                                cfg.max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    for n in (16320, 480320, 123457):
        assert frame_count(cfg, n) == jax_frame_count(cfg, n)


@pytest.mark.parametrize("output_layer,batch", [(1, 1), (3, 1), (3, 2)],
                         ids=["1", "3", "3-batch2"])
def test_extract_layer_matches_jax(output_layer, batch):
    """Batch 2 runs the attention wrapper once per row, against the JAX
    package's einsum path (its Pallas gate takes B=1 only)."""
    cfg, jcfg, params = small_wavlm()
    model = wavlm_from_numpy(params, cfg)
    wav = np.stack([np.pad(_sing(16000, 1.2, hz, seed=3 + i), (0, 320))
                    for i, hz in enumerate((210, 260)[:batch])])
    want = np.asarray(wavlm_extract_layer(params, jcfg, jnp.asarray(wav), output_layer))
    with torch.no_grad():
        got = model.extract_layer(torch.from_numpy(wav), output_layer).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
