"""knnsvc_torch's incremental streaming encoder (models/wavlm/streaming.py)
against the JAX package's on the CPU: the framing helpers, the position
bias of a step, and step after step of `_stream_step` with the K/V ring
wrapping, in the 'layer_norm' (per-frame, WavLM-Large's), 'group_norm' (no
frontend norm, tests/test_streaming.py's config) and 'default' (GroupNorm
over the step) extractor modes. Tolerance: 1e-4, tests/test_streaming_encoder.py's
own for a step against the batch encode (fp32 sums in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knnsvc_tpu.models.wavlm import streaming as jax_streaming
from knnsvc_torch.io.jax_params import wavlm_from_numpy
from knnsvc_torch.models.wavlm import streaming

from test_torch_common import small_wavlm, vibrato_wav

ATOL = RTOL = 1e-4
MODES = [("layer_norm", True), ("group_norm", False), ("default", True)]


def _models(mode, layer_norm_first):
    cfg, jcfg, params = small_wavlm(overrides={"extractor_mode": mode,
                                               "layer_norm_first": layer_norm_first})
    return cfg, jcfg, params, wavlm_from_numpy(params, cfg, "cpu")


def _step_samples(wav, t0, n, hop=320):
    seg = wav[t0 * hop: t0 * hop + n]
    return np.pad(seg, (0, n - len(seg))).astype(np.float32)


@pytest.mark.parametrize("spec", [
    "[(32,10,5)] + [(32,4,4)] + [(32,4,4)] + [(32,4,4)]",
    "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2",        # WavLM-Large's frontend
])
def test_receptive_field_and_step_length_equal_jax(spec):
    cfg, jcfg, _ = small_wavlm(overrides={"conv_feature_layers": spec})
    assert streaming.conv_receptive_field(cfg) == jax_streaming.conv_receptive_field(jcfg)
    for n in (1, 7, 30, 200):
        assert streaming.step_sample_len(cfg, n) == jax_streaming.step_sample_len(jcfg, n)


@pytest.mark.parametrize("t_cache,t_new", [(10, 8), (200, 30), (1, 1)])
def test_stream_position_bias_equals_jax(t_cache, t_new):
    cfg, _, params = small_wavlm()
    table = np.array(params["encoder"]["rel_attn_bias"])
    want = np.asarray(jax_streaming._stream_position_bias(
        jnp.asarray(table), t_cache, t_new, cfg.num_buckets, cfg.max_distance))
    got = streaming._stream_position_bias(torch.from_numpy(table), t_cache, t_new,
                                          cfg.num_buckets, cfg.max_distance)
    assert got.shape == (cfg.encoder_attention_heads, t_new, t_cache + t_new)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,layer_norm_first", MODES)
@pytest.mark.parametrize("lookahead", [0, 2])
def test_stream_steps_equal_jax(mode, layer_norm_first, lookahead):
    """Six steps of 6 final frames against a 10-slot cache (the ring wraps
    at step 2): each step's features and the whole state equal JAX's."""
    cfg, jcfg, params, wavlm = _models(mode, layer_norm_first)
    F, L, Tc = 6, 2, 10
    n = streaming.step_sample_len(cfg, F + lookahead)
    wav = vibrato_wav(1.0, 210, 5)
    state = streaming.init_stream_state(cfg, L, Tc)
    jstate = jax_streaming.init_stream_state(jcfg, L, Tc)
    for step in range(6):
        x = _step_samples(wav, step * F, n)
        got, state = streaming._stream_step(wavlm, torch.from_numpy(x), state, L, F)
        want, jstate = jax_streaming._stream_step(params, jcfg, jnp.asarray(x), jstate, L, F)
        assert got.shape == (F + lookahead, cfg.encoder_embed_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
        for name in ("k_cache", "v_cache", "feat_cache"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), atol=ATOL, rtol=RTOL)
        # only the final frames fill cache slots: the lookahead is not cached
        assert int(state.valid) == int(jstate.valid) == min((step + 1) * F, Tc)
        assert state.valid.dtype == torch.int32


def test_only_final_frames_enter_the_caches():
    """With lookahead, a first step fills F cache slots, from the back, and
    its positional-conv cache ends with the projected features of frames
    [0, F): the lookahead frames enter neither."""
    cfg, _, _, wavlm = _models("layer_norm", True)
    F, CR, L, Tc = 5, 3, 2, 12
    wav = vibrato_wav(0.5, 190, 6)
    with_la = streaming._stream_step(
        wavlm, torch.from_numpy(_step_samples(wav, 0, streaming.step_sample_len(cfg, F + CR))),
        streaming.init_stream_state(cfg, L, Tc), L, F)[1]
    assert int(with_la.valid) == F
    assert (with_la.k_cache[:, :, :Tc - F] == 0).all()          # unfilled slots stay empty
    with torch.no_grad():
        feats = wavlm.post_extract_proj(wavlm.layer_norm(wavlm.feature_extractor(
            torch.from_numpy(_step_samples(wav, 0, streaming.step_sample_len(cfg, F + CR)))[None]
        ).transpose(1, 2)))[0]
    np.testing.assert_array_equal(with_la.feat_cache[-F:].detach().numpy(),
                                  feats[:F].numpy())


def test_single_step_equals_batch_encode():
    """An empty cache and the whole input in one step: the masked cache keys
    drop out of the softmax, so the step is the batch encode (layer_norm
    extractor: per-frame statistics)."""
    cfg, _, _, wavlm = _models("layer_norm", True)
    n_frames = 40
    x = torch.from_numpy(vibrato_wav(1.0, 230, 7)[:streaming.step_sample_len(cfg, n_frames)])
    enc = streaming.WavLMStreamEncoder(wavlm, output_layer=2, chunk_frames=n_frames,
                                       cache_frames=8)
    got = enc.step(x.numpy())
    with torch.no_grad():
        want = wavlm.extract_layer(x[None], 2)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="exactly"):
        enc.step(x[:-1].numpy())
    with pytest.raises(ValueError, match="cache_frames"):
        streaming.WavLMStreamEncoder(wavlm, 2, chunk_frames=4, cache_frames=0)
