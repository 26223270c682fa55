"""knnsvc_torch WavLM against the JAX package's encoder on the CPU: the
relative-position buckets and the position bias (as its diagonal table,
expanded) exactly, at the full-size config, and the early-exit layer features
within 2e-4."""

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
from knnsvc_torch.models.wavlm.model import (compute_position_bias, compute_position_diag,
                                             frame_count, relative_position_bucket)
from knnsvc_torch.ops.attention import toeplitz_bias

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


@pytest.mark.parametrize("T", [1, 200, 1500])
def test_position_diag_matches_jax_bias(T):
    """The (H, 2T-1) table the kernel reads, expanded, equals the JAX
    package's (H, T, T) bias bit for bit, up to a 30-s chunk."""
    cfg = WavLMConfig()
    table = np.random.default_rng(1).standard_normal((cfg.num_buckets, 16)).astype(np.float32)
    want = np.asarray(jax_compute_position_bias(jnp.asarray(table), T, cfg.num_buckets,
                                                cfg.max_distance))
    diag = compute_position_diag(torch.from_numpy(table), T, cfg.num_buckets, cfg.max_distance)
    assert diag.shape == (16, 2 * T - 1) and diag.is_contiguous()
    np.testing.assert_array_equal(toeplitz_bias(diag).numpy(), want)


def test_position_bias_cache_holds_diagonals():
    cfg, _, params = small_wavlm()
    model = wavlm_from_numpy(params, cfg)
    a = model.position_bias(50)
    assert a.shape == (cfg.encoder_attention_heads, 99)
    assert model.position_bias(50) is a                 # cached per T
    assert model.position_bias(7).shape == (cfg.encoder_attention_heads, 13)
    with torch.no_grad():
        model.encoder.rel_attn_bias.add_(1.0)           # a new table drops the cache
    assert model.position_bias(50) is not a


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


def test_extract_all_layers_matches_jax():
    """The (L+1, B, T, C) stack: entry 0 the transformer input, then every
    layer's output, against wavlm_extract_all_layers."""
    from knnsvc_tpu.models.wavlm.model import wavlm_extract_all_layers

    cfg, jcfg, params = small_wavlm()
    model = wavlm_from_numpy(params, cfg)
    wav = np.pad(_sing(16000, 1.1, 240, seed=8), (0, 320))[None]
    want = np.asarray(wavlm_extract_all_layers(params, jcfg, jnp.asarray(wav)))
    with torch.no_grad():
        got = model.extract_all_layers(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (cfg.encoder_layers + 1, 1, want.shape[2],
                                       cfg.encoder_embed_dim)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("seconds", [0.7, 1.5, 2.3])
def test_extract_layer_bucketed_matches_jax(seconds):
    """Padded to the next sample bucket with the padded frames masked (zeroed
    before the positional conv, -inf logits as keys): the true frames
    against wavlm_extract_layer_bucketed; no attention kernel runs."""
    from knnsvc_tpu.models.wavlm.model import wavlm_extract_layer_bucketed
    from knnsvc_torch.ops.attention import gated_bias_attention_diag

    cfg, jcfg, params = small_wavlm()
    model = wavlm_from_numpy(params, cfg)
    wav = _sing(16000, seconds, 250, seed=4)[None]
    want = np.asarray(wavlm_extract_layer_bucketed(params, jcfg, jnp.asarray(wav), 2))
    before = gated_bias_attention_diag.launches
    with torch.no_grad():
        got = model.extract_layer_bucketed(torch.from_numpy(wav), 2).numpy()
    assert gated_bias_attention_diag.launches == before
    assert got.shape == want.shape == (1, frame_count(cfg, wav.shape[1]), cfg.encoder_embed_dim)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the mask is real: unmasked, the bucket's padded frames change the true ones
    from knnsvc_torch.models.wavlm.model import ENCODE_BUCKETS_SAMPLES

    bucket = next(b for b in ENCODE_BUCKETS_SAMPLES if b >= wav.shape[1])
    with torch.no_grad():
        unmasked = model.extract_layer(
            torch.from_numpy(np.pad(wav, ((0, 0), (0, bucket - wav.shape[1])))), 2).numpy()
    assert np.abs(unmasked[:, :got.shape[1]] - got).max() > 1e-3
