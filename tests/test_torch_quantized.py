"""The port's int8 matcher against the JAX package on the CPU:
quantize_pool's bytes and inverse norms exactly, the int8 dots exactly,
knn_topk_quantized's indices exactly against the JAX package's exact
search (approx=False: lax.top_k, ties to the lowest index; its approx=True
default is lax.approx_min_k, which on the CPU orders exact ties otherwise,
and which the port serves as this exact search), its distances within
float32 rounding, and the int8 host-pair conversion within 2e-4 of the
waveform (COMPONENTS.md §2.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knnsvc_tpu.hub import KnnSvc as JaxKnnSvc
from knnsvc_tpu.match.quantized_pool import knn_topk_quantized as jax_knn_topk_quantized
from knnsvc_tpu.match.quantized_pool import quantize_pool as jax_quantize_pool
from knnsvc_torch.hub import KnnSvc
from knnsvc_torch.match.quantized_pool import (int8_dot, knn_topk_quantized, quantize_pool,
                                               quantize_rows)
from knnsvc_torch.ops.concat_scan import concat_cost_pair
from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

from test_torch_common import small_generator, small_wavlm, write_pair


def _features(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[3] = 0.0                                       # a zero row: inverse norm 0
    x[5] = x[6]                                      # a duplicate: tied distances
    return x


@pytest.mark.parametrize("P,D", [(300, 64), (1001, 1024)])
def test_quantize_pool_bytes_and_norms_equal(P, D):
    pool = _features(P, D, 1)
    got, want = quantize_pool(pool, device="cpu"), jax_quantize_pool(pool)
    assert got.values.dtype == torch.int8 and got.values.shape == (P, D)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.inv_norms.numpy(), np.asarray(want.inv_norms))
    assert got.inv_norms[3] == 0


@pytest.mark.parametrize("Q,P,D,k", [(40, 300, 64, 32), (129, 1001, 1024, 32), (20, 10, 64, 8)])
def test_knn_topk_quantized_matches_jax(Q, P, D, k):
    pool, query = _features(P, D, 2), _features(Q, D, 3) * 0.37
    query[7] = pool[5] * 2.0                          # an exact tie between pool rows 5 and 6
    q, pq = torch.from_numpy(query), quantize_pool(pool, device="cpu")
    want_idx, want_d = jax_knn_topk_quantized(jnp.asarray(query), jax_quantize_pool(pool), k=k,
                                              approx=False)
    got_idx, got_d = knn_topk_quantized(q, pq, k=k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6)
    assert list(got_idx[7, :2]) == [5, 6]             # ties keep ascending pool order
    # the int8 dots are exact: against an int64 product of the same int8 rows
    q8, _ = quantize_rows(q)
    want_dot = q8.long() @ pq.values.long().T
    assert torch.equal(int8_dot(q8, pq.values).long(), want_dot)
    # a pool smaller than k: all of it, as match/knn.py (the JAX function raises)
    assert knn_topk_quantized(q, quantize_pool(pool[:7], device="cpu"), k=32)[0].shape == (Q, 7)


def test_convert_pair_int8_matches_jax(tmp_path):
    """The host-pool path with matcher='int8': the step path's int8 kNN,
    register shift, f0 re-rank and top-k means. (Its post_opt lanes run
    the concat wrapper held to the JAX scan in test_torch_concat.py; the
    card run counts their launches.)"""
    post_opt = "no_post_opt"
    src, ref = write_pair(tmp_path)
    cfg, jcfg, params = small_wavlm()
    h, jh, _, _, gen = small_generator("mix")
    w = generate_matrix_from_index(2, size=cfg.encoder_layers + 1)
    jknn = JaxKnnSvc(jax.tree.map(np.asarray, params), jcfg, gen, jh, "mix")
    knn = KnnSvc(params, cfg, gen, h, "mix", device="cpu")
    jknn.weighting = knn.weighting = w
    from knnsvc_torch.io.audio import load_audio

    want = load_audio(jknn.convert_pair(src, ref, matcher="int8", post_opt=post_opt,
                                        output_path=str(tmp_path / "jax.wav")))[0][0]
    before = concat_cost_pair.launches
    got = load_audio(knn.convert_pair(src, ref, matcher="int8", post_opt=post_opt,
                                      output_path=str(tmp_path / "torch.wav")))[0][0]
    assert concat_cost_pair.launches == before       # CPU: the plain version
    assert got.shape == want.shape == (50 * 320,)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-4)
