"""The shapes that the port's three hand-written kernels take beyond the
served one, on the CPU against the JAX package: head dims other than 64,
concat-cost rows whose width is not a multiple of 4, and the f0 Viterbi
past 511 voiced states. On the CPU each wrapper runs its plain version, so
these tests hold the plain versions to the JAX package at those shapes; the
kernels themselves are held to the plain versions on the card
(test_torch_gpu.py, chip_smoke.py). The kernels' shape checks run here as
pure Python, on tensors of the meta device (no data, no card).

Tolerances: attention 2e-5, as tests/test_ops.py holds the Pallas kernel;
the WavLM attention layer 1e-5 (two linear layers around it, float32 in
another summation order); concat selections and Viterbi states exact;
device f0 voicing on every frame and voiced f0 within 0.05 cents (the
features differ only in FFT and matmul summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knnsvc_tpu.dsp import f0_device as jax_f0
from knnsvc_tpu.match.concat_cost import knn_with_concat_cost_pair as jax_pair
from knnsvc_tpu.models.wavlm.model import compute_position_bias as jax_position_bias
from knnsvc_tpu.models.wavlm.model import multihead_attention as jax_multihead_attention
from knnsvc_tpu.ops.attention import gated_bias_attention as jax_gated_bias_attention
from knnsvc_tpu.ops.attention import reference_attention as jax_reference_attention
from knnsvc_torch.dsp.f0_device import DeviceF0Params, device_f0
from knnsvc_torch.io.jax_params import wavlm_from_numpy
from knnsvc_torch.match.concat_cost import knn_with_concat_cost_pair
from knnsvc_torch.ops import attention, concat_scan, viterbi
from knnsvc_torch.ops.attention import (gated_bias_attention, gated_bias_attention_diag,
                                        kernel_scales)

from test_torch_common import small_wavlm

SR = 16000
LAM_S = float(np.float32(0.753) * np.float32(10.0 / 1200.0))
SWITCH = float(np.float32(0.291))


def _attention_inputs(H, T, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((H, T, d)).astype(np.float32) for _ in range(3))
    diag = rng.standard_normal((H, 2 * T - 1)).astype(np.float32)
    bias = rng.standard_normal((H, T, T)).astype(np.float32)
    gate = (rng.random((H, T)) * 2 - 0.5).astype(np.float32)
    return q, k, v, diag, bias, gate


def _expand(diag):
    """bias[h, i, j] = diag[h, T-1 + j - i], in numpy."""
    T = (diag.shape[-1] + 1) // 2
    i = np.arange(T)
    return diag[:, (T - 1) + i[None, :] - i[:, None]]


@pytest.mark.parametrize("d", [8, 12, 96, 200])
@pytest.mark.parametrize("T", [40, 64])
def test_plain_attention_at_other_head_dims_matches_jax(d, T):
    """Both bias forms of the port's attention against the Pallas kernel
    (interpret mode) and JAX's reference, at head dims the CUDA kernel
    zero-fills (8, 12, 96) or splits into column groups (200)."""
    q, k, v, diag, bias, gate = _attention_inputs(3, T, d, seed=d + T)
    for b, entry in ((_expand(diag), gated_bias_attention_diag), (bias, gated_bias_attention)):
        jax_args = [jnp.asarray(a) for a in (q, k, v, b, gate)]
        pallas = np.asarray(jax_gated_bias_attention(*jax_args, block_q=32, interpret=True))
        ref = np.asarray(jax_reference_attention(*jax_args))
        arg = diag if entry is gated_bias_attention_diag else bias
        got = entry(*map(torch.from_numpy, (q, k, v, arg, gate))).numpy()
        assert got.shape == (3, T, d)
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_multihead_attention_at_head_dim_16_matches_jax():
    """The port's MultiheadAttention at the JAX package's test config (64
    wide, 4 heads: head dim 16), weights carried across by
    wavlm_from_numpy, against JAX's multihead_attention with the same
    position bias."""
    cfg, jcfg, params = small_wavlm()
    H = cfg.encoder_attention_heads
    assert cfg.encoder_embed_dim // H == 16
    model = wavlm_from_numpy(params, cfg)
    T = 57
    x = np.random.default_rng(4).standard_normal((1, T, cfg.encoder_embed_dim)).astype(np.float32)
    layer0 = jax.tree.map(lambda a: jnp.asarray(a[0]), params["encoder"]["layers"]["attn"])
    table = jnp.asarray(params["encoder"]["rel_attn_bias"])
    pos_bias = jax_position_bias(table, T, cfg.num_buckets, cfg.max_distance)
    want = np.asarray(jax_multihead_attention(jnp.asarray(x), layer0, pos_bias, H))
    with torch.no_grad():
        got = model.encoder.layers[0].attn(torch.from_numpy(x), model.position_bias(T)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [1022, 1023])
def test_plain_concat_at_unaligned_widths_matches_jax(D):
    """The port's plain pair scan against JAX's at row widths that are not a
    multiple of 4 (the CUDA kernel copies them 4 bytes at a time): the
    same selections on every frame."""
    rng = np.random.default_rng(D)
    T, P, k = 30, 41, 4
    src = rng.standard_normal((T, D)).astype(np.float32)
    src[10:16] = src[10] + 0.01 * rng.standard_normal((6, D)).astype(np.float32)
    tgt = rng.standard_normal((P, D)).astype(np.float32)
    idx_u, idx_p = (rng.integers(0, P, (T, k)).astype(np.int32) for _ in range(2))
    idx_u[::3, 0] = P - 1
    sf0 = (80 + 300 * rng.random(T)).astype(np.float32)
    sf0[::5] = 0.0
    tf0 = (80 + 300 * rng.random(P)).astype(np.float32)
    want = jax_pair(*map(jnp.asarray, (idx_u, idx_p, src, tgt, sf0, tf0)), concat_weight=0.2)
    got = knn_with_concat_cost_pair(*map(torch.from_numpy, (idx_u, idx_p, src, tgt, sf0, tf0)),
                                    concat_weight=0.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _sung(seconds: float, hz: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(hz * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))) / SR
    x = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(len(t))
    x *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    x[: SR // 5] = 0.0
    return x.astype(np.float32)


def test_device_f0_at_grid_cents_5_matches_jax():
    """A 5-cent grid (963 voiced states, past the 511 that one CUDA instance
    holds): the same voicing on every frame of a 4-s sung clip and f0
    within 0.05 cents, i.e. the same states."""
    x = _sung(4.0, 230.0, seed=5)
    got = device_f0(x, SR, params=DeviceF0Params(grid_cents=5.0), device="cpu")
    want = jax_f0.device_f0(x, SR, params=jax_f0.DeviceF0Params(grid_cents=5.0))
    assert len(jax_f0._candidate_grid(jax_f0.DeviceF0Params(grid_cents=5.0))) == 963
    assert got.shape == want.shape
    np.testing.assert_array_equal(got > 0, want > 0)
    v = got > 0
    assert v.mean() > 0.5
    assert np.abs(1200 * np.log2(got[v] / want[v])).max() < 0.05


@pytest.mark.parametrize("N,C", [(60, 963), (40, 2406)])
def test_plain_viterbi_past_511_states_matches_jax(N, C):
    """The plain Viterbi's states against JAX's scan at the state counts of
    5- and 2-cent grids, with silent frames and flat runs (ties)."""
    rng = np.random.default_rng(N + C)
    cost_v = rng.standard_normal((N, C)).astype(np.float32)
    cost_u = (rng.standard_normal(N) * 0.5).astype(np.float32)
    cost_v[::3] = 1e3
    cost_v[1::4, C // 2:] = cost_v[1::4, C // 2:C // 2 + 1]
    want = np.asarray(jax.jit(jax_f0._viterbi)(jnp.asarray(cost_v), jnp.asarray(cost_u),
                                               jnp.float32(LAM_S), jnp.float32(SWITCH)))
    got = viterbi.f0_viterbi(torch.from_numpy(cost_v), torch.from_numpy(cost_u), LAM_S, SWITCH)
    np.testing.assert_array_equal(got.numpy(), want)


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("d", [1, 7, 64, 129, 256])
def test_attention_shape_check_takes_head_dims_up_to_256(d):
    H, T = 2, 9
    attention._check_inputs(_meta(H, T, d), _meta(H, T, d), _meta(H, T, d), _meta(H, 2 * T - 1),
                            _meta(H, T), lambda H, T: (H, 2 * T - 1))


def test_attention_shape_check_raises_above_256():
    H, T, d = 2, 9, 257
    with pytest.raises(ValueError, match=r"head dims 1\.\.256, got 257"):
        attention._check_inputs(_meta(H, T, d), _meta(H, T, d), _meta(H, T, d), _meta(H, T, T),
                                _meta(H, T), lambda H, T: (H, T, T))


@pytest.mark.parametrize("d,scales", [(64, (0.125, 1.0)), (16, (0.25, 1.0)), (256, (1 / 16, 1.0)),
                                      (1, (1.0, 1.0)), (32, (1.0, 32 ** -0.5)),
                                      (12, (1.0, 12 ** -0.5)), (200, (1.0, 200 ** -0.5))])
def test_attention_scale_goes_to_q_only_where_exact(d, scales):
    """d^-1/2 scales Q up front only where it is a power of two (exact); S
    after the product otherwise, as the plain version does."""
    assert kernel_scales(d) == scales


@pytest.mark.parametrize("k,D", [(1, 1), (4, 1022), (4, 1023), (8, 1021), (32, 3), (4, 1024)])
def test_concat_shape_check_takes_any_width(k, D):
    concat_scan._check_kernel_shape(k, D)


@pytest.mark.parametrize("k,D,match", [(0, 1024, "k <= 32"), (33, 1023, "k <= 32"),
                                       (4, 0, "D >= 1")])
def test_concat_shape_check_raises_outside_its_limits(k, D, match):
    with pytest.raises(ValueError, match=match):
        concat_scan._check_kernel_shape(k, D)


@pytest.mark.parametrize("C", [482, 963, 2406, 4812, 16383])
def test_viterbi_state_check_takes_up_to_16384_states(C):
    viterbi.check_states(C)


def test_viterbi_state_check_raises_above_16384_states():
    with pytest.raises(ValueError, match="16384 states, got C=16384"):
        viterbi.check_states(16384)
