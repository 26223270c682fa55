"""knnsvc_torch's carried (streaming) concat-cost reselection on the CPU
against the JAX package: the plain carried cores against
`concat_cost_stream_core` / `concat_cost_pair_stream_core`, selection for
selection and in the weight after each frame, with a carried weight of
concat_weight and of 0, k in 1, 4, 8, on inputs whose baselines cross 0.08;
chunks chained through the carry against the whole-utterance pass; the
CPU wrapper of the kernel's carried entry against the plain core; and
`match_utterance_stream` against the JAX package's on the same window.
The CUDA kernel's own carried checks are in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knnsvc_tpu.config import PostOpt as JaxPostOpt
from knnsvc_tpu.match import concat_cost as jax_cc
from knnsvc_tpu.match.pipeline import match_utterance_stream as jax_match_stream
from knnsvc_torch.config import PostOpt
from knnsvc_torch.match.concat_cost import (concat_cost_pair_stream_core, concat_cost_stream_core,
                                            knn_with_concat_cost, knn_with_concat_cost_pair)
from knnsvc_torch.match.pipeline import match_utterance_stream
from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_pair_stream,
                                          concat_cost_single_stream)

from test_torch_concat import _inputs

CW = 0.2
S = 10          # the chunk starts at frame 10 of the 37: frames 12-19 are smooth, 20 jumps


def _chunk(case, k, seed=3):
    """(numpy) idx_u, idx_p, src, tgt, sf0, tf0 of frames [S, T), the
    previous frame's source row and a carry of pool ids (2, k)."""
    idx_u, idx_p, src, tgt, sf0, tf0 = _inputs(case, k=k)
    carry = np.random.default_rng(seed).integers(0, tgt.shape[0], (2, k)).astype(np.int32)
    return (idx_u[S:], idx_p[S:], src[S:], tgt, sf0[S:], tf0), src[S - 1], carry


def _jax_gather(tgt):
    t = jnp.asarray(tgt)
    return lambda idx: t[idx]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_baselines_cross_the_latch():
    (_, _, src, _, _, _), prev_src, _ = _chunk("sticky_latch", 4)
    s = np.concatenate([prev_src[None], src])
    s = s / np.linalg.norm(s, axis=1, keepdims=True)
    b = 2 * (1 - (s[:-1] * s[1:]).sum(1))
    assert (b < 0.08).any() and (b >= 0.08).any()


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("case", ["sticky_latch", "clamp_and_duplicates"])
@pytest.mark.parametrize("carry_weight", [CW, 0.0])
def test_pair_stream_core_equals_jax(case, k, carry_weight):
    (iu, ip, src, tgt, sf0, tf0), prev_src, carry = _chunk(case, k)
    want_u, want_p, want_w = map(np.asarray, jax_cc.concat_cost_pair_stream_core(
        _jax_gather(tgt), jnp.asarray(iu), jnp.asarray(ip), jnp.asarray(prev_src),
        jnp.asarray(src), tgt.shape[0], jnp.asarray(sf0), jnp.log2(jnp.asarray(tf0) + 1e-5),
        jnp.asarray(carry), jnp.float32(carry_weight), concat_weight=CW))
    got_u, got_p, got_w = concat_cost_pair_stream_core(
        _t(iu), _t(ip), _t(prev_src), _t(src), _t(tgt), _t(sf0), _t(tf0), _t(carry),
        carry_weight, concat_weight=CW)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    # the kernel's wrapper on CPU tensors is the plain core, and counts nothing
    before = concat_cost_pair.launches
    wrap = concat_cost_pair_stream(_t(iu), _t(ip), _t(prev_src), _t(src), _t(tgt), _t(sf0),
                                   _t(tf0), _t(carry), torch.tensor(carry_weight),
                                   concat_weight=CW)
    assert concat_cost_pair.launches == before
    for a, b in zip(wrap, (got_u, got_p, got_w)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("pitched", [False, True])
@pytest.mark.parametrize("carry_weight", [CW, 0.0])
def test_single_stream_core_equals_jax(pitched, k, carry_weight):
    """The single lane: the unpitched one carries its weight unchanged and
    costs with concat_weight; the pitched one latches."""
    (iu, ip, src, tgt, sf0, tf0), prev_src, carry = _chunk("sticky_latch", k)
    idx = ip if pitched else iu
    prev = carry[1 if pitched else 0]
    f0s = dict(shifted_src_f0=jnp.asarray(sf0), tgt_log_f0=jnp.log2(jnp.asarray(tf0) + 1e-5)
               ) if pitched else {}
    want, want_w = map(np.asarray, jax_cc.concat_cost_stream_core(
        _jax_gather(tgt), jnp.asarray(idx), jnp.asarray(prev_src), jnp.asarray(src),
        tgt.shape[0], jnp.asarray(prev), jnp.float32(carry_weight), concat_weight=CW, **f0s))
    tf0s = dict(shifted_src_f0=_t(sf0), tgt_f0=_t(tf0)) if pitched else {}
    got, got_w = concat_cost_stream_core(_t(idx), _t(prev_src), _t(src), _t(tgt), _t(prev),
                                         carry_weight, concat_weight=CW, **tf0s)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    if not pitched:
        assert (got_w == np.float32(carry_weight)).all()
    wrap = concat_cost_single_stream(_t(idx), _t(prev_src), _t(src), _t(tgt), _t(prev),
                                     carry_weight, concat_weight=CW, **tf0s)
    assert torch.equal(wrap[0], got) and torch.equal(wrap[1], got_w)


@pytest.mark.parametrize("bounds", [(0, 9, 20, 37), (0, 1, 2, 15, 37), (0, 12, 13, 30, 37)])
def test_chained_chunks_equal_the_whole_utterance(bounds):
    """Chunk 0 through the whole-utterance entry, every later chunk from
    the previous chunk's last picks and weight: frame for frame the whole
    pass (both lanes, and each single lane), the JAX package's whole pass
    too."""
    idx_u, idx_p, src, tgt, sf0, tf0 = map(_t, _inputs("sticky_latch", k=4))
    whole_u, whole_p = knn_with_concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0, CW)
    jax_u, jax_p = map(np.asarray, jax_cc.knn_with_concat_cost_pair(
        *[jnp.asarray(x.numpy()) for x in (idx_u, idx_p, src, tgt, sf0, tf0)], concat_weight=CW))
    np.testing.assert_array_equal(whole_u.numpy(), jax_u)
    np.testing.assert_array_equal(whole_p.numpy(), jax_p)
    whole_sp = knn_with_concat_cost(idx_p, src, tgt, sf0, tf0, CW)
    a, b = bounds[0], bounds[1]
    us, ps = list(knn_with_concat_cost_pair(idx_u[a:b], idx_p[a:b], src[a:b], tgt, sf0[a:b],
                                            tf0, CW))
    sps = [knn_with_concat_cost(idx_p[a:b], src[a:b], tgt, sf0[a:b], tf0, CW)]
    us, ps = [us], [ps]
    # the pitched weight after chunk 0: concat_weight until the first
    # baseline at or over 0.08
    s = src[a:b] / torch.linalg.norm(src[a:b], dim=1, keepdim=True)
    w = CW * float(torch.prod(((2 * (1 - (s[:-1] * s[1:]).sum(1))) < 0.08).float()))
    w_single = w
    for a, b in zip(bounds[1:-1], bounds[2:]):
        carry = torch.stack([us[-1][-1], ps[-1][-1]])
        u, p, ws = concat_cost_pair_stream_core(idx_u[a:b], idx_p[a:b], src[a - 1], src[a:b], tgt,
                                                sf0[a:b], tf0, carry, w, CW)
        sp, wss = concat_cost_stream_core(idx_p[a:b], src[a - 1], src[a:b], tgt, sps[-1][-1],
                                          w_single, sf0[a:b], tf0, CW)
        us.append(u)
        ps.append(p)
        sps.append(sp)
        w, w_single = ws[-1], wss[-1]
    assert torch.equal(torch.cat(us), whole_u) and torch.equal(torch.cat(ps), whole_p)
    assert torch.equal(torch.cat(sps), whole_sp)
    assert float(w) == 0.0      # the latch fell inside the utterance and held across chunks


def _window(T, P, D, seed):
    """Window features, f0 and a target pool (numpy)."""
    from test_torch_common import _vibrato_f0

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, D)).astype(np.float32)
    q[5:14] = q[5] + 0.01 * rng.standard_normal((9, D)).astype(np.float32)
    matching, synth = (rng.standard_normal((P, D)).astype(np.float32) for _ in range(2))
    harm = rng.random((P, 49)).astype(np.float32)
    return q, _vibrato_f0(T, 190, seed), matching, synth, _vibrato_f0(P, 260, seed + 1), harm


@pytest.mark.parametrize("ckpt_type,with_carry,post_opt", [
    *[(c, w, "no_post_opt_0.2") for c in ("mix", "wavlm_only") for w in (False, True)],
    ("mix", True, "post_opt_0.2"),              # and the optimizer per window slice
])
def test_match_utterance_stream_equals_jax(ckpt_type, with_carry, post_opt):
    q, qf0, matching, synth, pool_f0, harm = _window(40, 150, 64, 4)
    scan_from, topk = 8, 4
    lanes = 2 if ckpt_type == "mix" else 1
    carry = None
    if with_carry:
        ids = np.random.default_rng(5).integers(0, 150, (lanes, topk)).astype(np.int32)
        carry = (ids, np.float32(0.0 if ckpt_type == "mix" else CW))
    anchor = float(np.median(np.log(qf0[qf0 > 0])))
    want = jax_match_stream(
        jnp.asarray(q), jnp.asarray(qf0), jnp.asarray(matching), jnp.asarray(synth),
        jnp.asarray(pool_f0), jnp.asarray(harm), ckpt_type, JaxPostOpt.parse(post_opt), scan_from,
        None if carry is None else (jnp.asarray(carry[0]), jnp.float32(carry[1])),
        topk=topk, matcher="exact", query_f0_log_median=anchor)
    got = match_utterance_stream(
        q, qf0, _t(matching), _t(synth), _t(pool_f0), _t(harm) if lanes == 2 else None,
        ckpt_type, PostOpt.parse(post_opt), scan_from,
        None if carry is None else (_t(carry[0]).long(), torch.tensor(carry[1])),
        topk=topk, matcher="exact", query_f0_log_median=anchor)
    # equal selections; the optimizer's fp32 rounding as in test_torch_smoothness.py
    atol = 3e-3 if post_opt == "post_opt_0.2" else 1e-6
    assert got[0].shape == (40 - scan_from, 64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    if lanes == 2:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=atol)
    else:
        assert got[2] is None and want[2] is None
    for emit_end in (scan_from + 1, 25, 40):
        (sel, w), (jsel, jw) = got[3](emit_end), want[3](emit_end)
        assert sel.shape == (lanes, topk)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        assert float(w) == float(jw)


def test_match_utterance_stream_rejects():
    q, qf0, matching, synth, pool_f0, harm = _window(20, 30, 16, 6)
    args = (q, qf0, _t(matching), _t(synth), _t(pool_f0), _t(harm), "mix",
            PostOpt.parse("post_opt_0.2"))
    with pytest.raises(ValueError, match="match each window alone"):   # no carry to thread
        match_utterance_stream(*args, 2, None, matcher="sharded")
    with pytest.raises(ValueError, match="matcher"):
        match_utterance_stream(*args, 2, None, matcher="int8")
    with pytest.raises(ValueError, match="carry"):
        match_utterance_stream(*args, 2, (torch.zeros(1, 4, dtype=torch.long), 0.2))
    with pytest.raises(ValueError, match="scan_from"):
        match_utterance_stream(*args, 0, (torch.zeros(2, 4, dtype=torch.long), 0.2))
