"""knnsvc_torch's CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked gpu and skips when torch sees no CUDA device
(decided inside the test). The file imports neither JAX nor the JAX
package, so it also runs where those are not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances: 1e-4 at the main path's T=1500, where the kernel sums 1500
terms per score row and per output in another order than cuBLAS and
torch.softmax, its products in 3 TF32 tensor-core passes (fp32-grade);
2e-5 (test_ops.py's bound for the Pallas kernel) at T<=200. Under the
"fastest" policy the kernel takes one TF32 pass (10 mantissa bits):
ATTN_ATOL_TF32, ~3x the 7.9e-4 that chip_smoke.py measures at the main
shape on an H100 (and checks against the same bound). The attention
kernel's full-bias entry is held to the same bounds on a random (H, T, T)
bias, and on a Toeplitz bias it equals the diagonal entry bit for bit.
Both entries take every head dim from 1 to 256 at these bounds (d = 257
raises), and encoders of head dim 8 and 16 encode on the card.
The concat-cost kernel's selections must equal its plain version's exactly
on these random inputs, at every tested k (1..32), with its rows in shared
memory (every k at D = 128, k = 4 at D = 1024) and read from L2 (k = 8 at
D = 1024), at row widths that are not a multiple of 4 too (D = 1..127,
1021-1023: 4-byte copies); its pre-pass values within 1e-5 relative of the
plain norms and dots (sums of D fp32 terms in another order). Its carried
(streaming) entry equals the plain carried cores in picks and in the
weight after each frame, and chunks chained through it give the
whole-utterance kernel's picks. Its shard-table entries (a pool split into
logical shards of the card) equal the plain version reading the same
shards, and the dense entry with one shard; a shard on the CPU raises. The
sharded match on the card equals the dense match on these inputs (one
shard: the same GEMM; four: the shares of equal rows stay at 100% here).
The f0 Viterbi kernel's states must equal its plain version's on every
frame (both do the same fp32 operations in the same order, ties included),
in every instance: C + 1 up to 512 and 1024 in registers, up to 2048, 4096,
8192 and 16384 in shared memory (C = 16384 raises).
Device f0 on the card against the CPU: cuFFT and cuBLAS sum in other orders
than pocketfft and the CPU matmul, so voicing must agree on >= 99.5% of
frames and f0 within 1 cent on >= 99% of the frames voiced in both.
"""

import numpy as np
import pytest
import torch

from knnsvc_torch.match.concat_cost import (concat_cost_pair_stream_core,
                                            concat_cost_stream_core, knn_with_concat_cost,
                                            knn_with_concat_cost_pair, scan_inputs)
from knnsvc_torch.ops.attention import (gated_bias_attention, gated_bias_attention_diag,
                                        reference_attention, toeplitz_bias)
from knnsvc_torch.ops.concat_scan import (concat_cost_pair, concat_cost_pair_sharded,
                                          concat_cost_pair_stream, concat_cost_prepass,
                                          concat_cost_single, concat_cost_single_sharded,
                                          concat_cost_single_stream)
from knnsvc_torch.ops.viterbi import MAX_STATES, f0_viterbi, viterbi_plain
from knnsvc_torch.precision import get_precision, set_precision

ATTN_ATOL_TF32 = 2.5e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled for sm_90a")
    return torch.device("cuda")


def _inputs(H, T, d, gate_value, seed, device):
    """q, k, v, the bias's (H, 2T-1) diagonal table, gate."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((H, T, d)).astype(np.float32) for _ in range(3)]
    arrays.append(rng.standard_normal((H, 2 * T - 1)).astype(np.float32))
    arrays.append((rng.random((H, T)) * 2).astype(np.float32) if gate_value is None
                  else np.full((H, T), gate_value, np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("H,T,gate_value,atol", [
    (16, 1500, None, 1e-4),   # the main path's shape (one 30-s chunk)
    (4, 200, 1.0, 2e-5),
    (4, 200, 0.0, 2e-5),
    (4, 200, -0.5, 2e-5),
    (3, 61, None, 2e-5),      # one ragged key tile and one ragged query block
    (2, 1, None, 2e-5),       # a single key
    (2, 65, -0.5, 2e-5),      # one key past a tile
])
def test_attention_kernel_matches_plain(H, T, gate_value, atol):
    arrays = _inputs(H, T, 64, gate_value, seed=5, device=_cuda())
    before = gated_bias_attention_diag.launches
    got = gated_bias_attention_diag(*arrays)
    torch.cuda.synchronize()
    assert gated_bias_attention_diag.launches == before + 1
    want = reference_attention(*arrays)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("H,T", [(16, 1500), (3, 61)])
def test_attention_kernel_fastest_takes_one_tf32_pass(H, T):
    """Under "fastest" the kernel's TF32 error shows against the fp32 plain
    version, and stays within ATTN_ATOL_TF32."""
    arrays = _inputs(H, T, 64, None, seed=7, device=_cuda())
    want = reference_attention(*arrays)
    exact = float((gated_bias_attention_diag(*arrays) - want).abs().max())
    mode = get_precision()
    set_precision("fastest")
    try:
        got = gated_bias_attention_diag(*arrays)
        torch.cuda.synchronize()
    finally:
        set_precision(mode)
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all() and err <= ATTN_ATOL_TF32
    assert err > exact   # one pass is measurably coarser than three


@pytest.mark.gpu
def test_attention_kernel_rejects_bad_inputs():
    q, k, v, diag, gate = _inputs(2, 64, 64, None, seed=6, device=_cuda())
    before = gated_bias_attention_diag.launches
    with pytest.raises(TypeError):
        gated_bias_attention_diag(q.double(), k, v, diag, gate)
    with pytest.raises(ValueError):                 # a full (H, T, T) bias: the other entry
        gated_bias_attention_diag(q, k, v, torch.zeros(2, 64, 64, device=q.device), gate)
    with pytest.raises(ValueError):                 # a diagonal not 2T-1 long
        gated_bias_attention_diag(q, k, v, diag[:, :-2].contiguous(), gate)
    wide = [torch.zeros(2, 64, 257, device=q.device) for _ in range(3)]
    with pytest.raises(ValueError, match="1..256"):  # head dim 257: above the widest instance
        gated_bias_attention_diag(*wide, diag, gate)
    with pytest.raises(ValueError):
        gated_bias_attention_diag(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, diag, gate)
    assert gated_bias_attention_diag.launches == before


def _full_inputs(H, T, gate_value, seed, device, d=64):
    """q, k, v, a random (H, T, T) bias (not Toeplitz), gate."""
    q, k, v, _, gate = _inputs(H, T, d, gate_value, seed, device)
    bias = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal((H, T, T))
                            .astype(np.float32)).to(device)
    return [q, k, v, bias, gate]


@pytest.mark.gpu
@pytest.mark.parametrize("H,T,gate_value,atol", [
    (16, 1500, None, 1e-4),   # the main path's shape; 16-byte bias copies (T % 4 == 0)
    (4, 200, 1.0, 2e-5),
    (4, 200, 0.0, 2e-5),
    (4, 200, -0.5, 2e-5),
    (3, 61, None, 2e-5),      # 4-byte bias copies, a ragged tile and query block
    (2, 1, None, 2e-5),
    (2, 65, -0.5, 2e-5),
])
def test_full_bias_attention_matches_plain(H, T, gate_value, atol):
    """The full-bias entry against the plain version on a random
    (non-Toeplitz) bias, with the launch counter."""
    arrays = _full_inputs(H, T, gate_value, seed=11, device=_cuda())
    before = (gated_bias_attention.launches, gated_bias_attention_diag.launches)
    got = gated_bias_attention(*arrays)
    torch.cuda.synchronize()
    assert (gated_bias_attention.launches, gated_bias_attention_diag.launches) == (
        before[0] + 1, before[1])
    want = reference_attention(*arrays)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("H,T", [(16, 1500), (3, 61)])
@pytest.mark.parametrize("mode", ["highest", "fastest"])
def test_full_bias_entry_equals_diagonal_entry_on_a_toeplitz_bias(H, T, mode):
    """One inner loop: the Toeplitz bias expanded from a diagonal table gives
    the diagonal entry's output bit for bit, in both precision modes."""
    q, k, v, diag, gate = _inputs(H, T, 64, None, seed=12, device=_cuda())
    bias = toeplitz_bias(diag).contiguous()
    previous = get_precision()
    set_precision(mode)
    try:
        full = gated_bias_attention(q, k, v, bias, gate)
        diagonal = gated_bias_attention_diag(q, k, v, diag, gate)
        torch.cuda.synchronize()
    finally:
        set_precision(previous)
    assert torch.equal(full, diagonal)


@pytest.mark.gpu
def test_full_bias_attention_rejects_bad_inputs():
    q, k, v, bias, gate = _full_inputs(2, 64, None, seed=13, device=_cuda())
    before = gated_bias_attention.launches
    with pytest.raises(TypeError):
        gated_bias_attention(q, k, v, bias.double(), gate)
    with pytest.raises(ValueError):                 # a diagonal table: the other entry
        gated_bias_attention(q, k, v, bias[:, 0, :].contiguous(), gate)
    with pytest.raises(ValueError):                 # not (H, T, T)
        gated_bias_attention(q, k, v, bias[:, :-1].contiguous(), gate)
    wide = [torch.zeros(2, 64, 257, device=q.device) for _ in range(3)]
    with pytest.raises(ValueError, match="1..256"):  # head dim 257: above the widest instance
        gated_bias_attention(*wide, bias, gate)
    with pytest.raises(ValueError):                 # a transposed (non-contiguous) bias
        gated_bias_attention(q, k, v, bias.transpose(1, 2), gate)
    with pytest.raises(ValueError):                 # the bias on the CPU
        gated_bias_attention(q, k, v, bias.cpu(), gate)
    assert gated_bias_attention.launches == before


HEAD_DIMS = (1, 3, 8, 12, 16, 17, 31, 32, 33, 48, 63, 65, 96, 100, 127, 128, 129, 200, 255, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("H,T,d,atol", [
    *[(3, 61, d, 2e-5) for d in HEAD_DIMS],      # a ragged key tile and query block
    *[(4, 200, d, 2e-5) for d in (8, 12, 16, 32, 48, 96, 128, 200, 256)],
    (32, 1500, 32, 1e-4), (8, 1500, 128, 1e-4),   # H d = 1024 at a 30-s chunk's T
])
def test_attention_kernel_at_any_head_dim_matches_plain(H, T, d, atol):
    """Both entries at head dims other than 64 (zero-filled up to the
    instance of 16, 32, 64, 128 or 256 columns; above 128 in two column
    groups), under "highest" and "fastest"; a Toeplitz bias through the full
    entry gives the diagonal entry's output bit for bit."""
    q, k, v, diag, gate = _inputs(H, T, d, None, seed=d, device=_cuda())
    bias = torch.from_numpy(np.random.default_rng(d + 1).standard_normal((H, T, T))
                            .astype(np.float32)).to(q.device)
    previous = get_precision()
    try:
        for mode, bound in (("highest", atol), ("fastest", ATTN_ATOL_TF32)):
            set_precision(mode)
            before = (gated_bias_attention.launches, gated_bias_attention_diag.launches)
            got_diag = gated_bias_attention_diag(q, k, v, diag, gate)
            got_full = gated_bias_attention(q, k, v, bias, gate)
            toeplitz = gated_bias_attention(q, k, v, toeplitz_bias(diag).contiguous(), gate)
            torch.cuda.synchronize()
            assert (gated_bias_attention.launches, gated_bias_attention_diag.launches) == (
                before[0] + 2, before[1] + 1)
            for got, b in ((got_diag, diag), (got_full, bias)):
                assert got.shape == (H, T, d) and torch.isfinite(got).all()
                assert float((got - reference_attention(q, k, v, b, gate)).abs().max()) <= bound
            assert torch.equal(toeplitz, got_diag)
    finally:
        set_precision(previous)


# the JAX package's test encoder (tests/test_wavlm.py: 64 wide, 4 heads, head
# dim 16) and the port's tiny training-world encoder (16 wide, 2 heads, 8)
_SMALL_HEAD_WAVLMS = {
    16: dict(extractor_mode="layer_norm", encoder_layers=3, encoder_embed_dim=64,
             encoder_ffn_embed_dim=128, encoder_attention_heads=4, layer_norm_first=True,
             conv_feature_layers="[(32,10,5)] + [(32,3,2)] + [(32,2,2)]", conv_bias=False,
             conv_pos=16, conv_pos_groups=4, relative_position_embedding=True, num_buckets=32,
             max_distance=64, gru_rel_pos=True),
    8: dict(extractor_mode="layer_norm", encoder_layers=2, encoder_embed_dim=16,
            encoder_ffn_embed_dim=32, encoder_attention_heads=2, layer_norm_first=True,
            conv_feature_layers="[(16,10,5)] + [(16,4,4)] + [(16,4,4)] + [(16,4,4)]",
            conv_bias=True, conv_pos=8, conv_pos_groups=2, relative_position_embedding=True,
            num_buckets=16, max_distance=32, gru_rel_pos=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [16, 8])
def test_encoder_at_small_head_dims_card_matches_cpu(head_dim):
    """The port's WavLM at head dims 16 and 8 launches the kernel once per
    layer on the card, and its layers agree with the CPU's."""
    from knnsvc_torch.config import WavLMConfig
    from knnsvc_torch.io.jax_params import wavlm_from_numpy
    from knnsvc_torch.models.wavlm.model import init_wavlm_params

    dev = _cuda()
    cfg = WavLMConfig.from_dict(_SMALL_HEAD_WAVLMS[head_dim])
    assert cfg.encoder_embed_dim // cfg.encoder_attention_heads == head_dim
    params = init_wavlm_params(cfg, torch.Generator().manual_seed(head_dim))
    card, cpu = wavlm_from_numpy(params, cfg, dev), wavlm_from_numpy(params, cfg, "cpu")
    wav = _sung(1.3, head_dim)
    before = gated_bias_attention_diag.launches
    with torch.no_grad():
        got = card.extract_all_layers(wav.to(dev))
        torch.cuda.synchronize()
        assert gated_bias_attention_diag.launches == before + cfg.encoder_layers
        want = cpu.extract_all_layers(wav)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got.cpu() - want).abs().max()) <= 1e-3


def _concat_inputs(T, P, D, seed, device, clamp_and_duplicates=False, k=4):
    """Random ids and features with a smooth source stretch (baselines under
    0.08, so the pitched lane's weight latches part way through)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((T, D)).astype(np.float32)
    src[12:20] = src[12] + 0.01 * rng.standard_normal((8, D)).astype(np.float32)
    tgt = rng.standard_normal((P, D)).astype(np.float32)
    idx_u = rng.integers(0, P, (T, k))
    idx_p = rng.integers(0, P, (T, k))
    if clamp_and_duplicates:
        idx_u[::3, 0] = P - 1
        idx_p[::4, 1 % k] = P - 1
        idx_u[1::2, 2 % k] = idx_u[1::2, 1 % k]
        idx_p[1:, 3 % k] = np.minimum(idx_p[:-1, 0] + 1, P - 1)
    sf0 = (80 + 300 * rng.random(T)).astype(np.float32)
    sf0[::5] = 0.0
    tf0 = (80 + 300 * rng.random(P)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (idx_u, idx_p, src, tgt, sf0, tf0)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,P,D,clamp_and_duplicates,k", [
    # test_ops.py's shape for the Pallas kernel, random ids, and ids at row
    # P-1 with own candidates equal to prev + 1
    *[(37, 53, 128, dup, k) for dup in (False, True) for k in (1, 3, 4, 8, 16, 32)],
    (300, 400, 1024, False, 4),   # the served width, rows in shared memory
    (300, 400, 1024, False, 8),   # the served width, rows read from L2
    # widths that are no multiple of 4: 4-byte copies into zero-padded rows
    *[(37, 53, D, True, k) for D in (1, 2, 3, 5, 127) for k in (1, 4, 8, 32)],
    (300, 400, 1023, False, 4), (300, 400, 1022, False, 4), (300, 400, 1021, False, 4),
    (300, 400, 1023, False, 8),   # read from L2 by scalar loads
])
def test_concat_kernel_matches_plain(T, P, D, clamp_and_duplicates, k):
    idx_u, idx_p, src, tgt, sf0, tf0 = _concat_inputs(T, P, D, 7, _cuda(), clamp_and_duplicates,
                                                      k)
    before = concat_cost_pair.launches
    got_u, got_p = concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0, concat_weight=0.2)
    got_s = concat_cost_single(idx_u, src, tgt, concat_weight=0.2)
    got_sp = concat_cost_single(idx_p, src, tgt, sf0, tf0, concat_weight=0.3)
    torch.cuda.synchronize()
    assert concat_cost_pair.launches == before + 3
    want_u, want_p = knn_with_concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0,
                                               concat_weight=0.2)
    assert torch.equal(got_u, want_u) and torch.equal(got_p, want_p)
    assert torch.equal(got_s, want_u)
    assert torch.equal(got_sp, knn_with_concat_cost(idx_p, src, tgt, sf0, tf0,
                                                    concat_weight=0.3))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1024, 1023])
def test_concat_prepass_matches_plain_norms_and_dots(D):
    idx_u, idx_p, src, tgt, sf0, tf0 = _concat_inputs(50, 70, D, 9, _cuda(), k=4)
    idx = torch.stack([idx_u, idx_p], dim=1).to(torch.int32).contiguous()
    svn = scan_inputs(src, None, None)[0]
    before = concat_cost_pair.launches
    pnorm, osd = concat_cost_prepass(idx, svn, tgt)
    torch.cuda.synchronize()
    assert concat_cost_pair.launches == before
    want_norm = torch.sqrt((tgt * tgt).sum(-1))
    own = idx.long()
    want_own = (tgt[own] * svn[:, None, None, :]).sum(-1)
    nxt = torch.clamp(own[:-1] + 1, max=tgt.shape[0] - 1)
    want_next = (tgt[nxt] * svn[1:, None, None, :]).sum(-1)
    assert torch.allclose(pnorm, want_norm, rtol=1e-5, atol=0)
    assert torch.allclose(osd[0], want_own, rtol=1e-5, atol=1e-5)
    assert torch.allclose(osd[1, :-1], want_next, rtol=1e-5, atol=1e-5)
    assert (osd[1, -1] == 0).all()


@pytest.mark.gpu
def test_concat_kernel_rejects_bad_inputs():
    _, _, src, tgt, sf0, tf0 = _concat_inputs(20, 30, 64, 8, _cuda())
    idx_u, idx_p = (torch.randint(0, 30, (20, 33), device=src.device) for _ in range(2))
    before = concat_cost_pair.launches
    for k in (0, 33):                                        # outside 1..32
        with pytest.raises(ValueError, match="k <= 32"):
            concat_cost_pair(idx_u[:, :k], idx_p[:, :k], src, tgt, sf0, tf0)
        with pytest.raises(ValueError, match="k <= 32"):
            concat_cost_single(idx_u[:, :k], src, tgt)
    idx_u, idx_p = idx_u[:, :4], idx_p[:, :4]
    with pytest.raises(ValueError, match="D >= 1"):         # rows of no float
        concat_cost_pair(idx_u, idx_p, src[:, :0].contiguous(), tgt[:, :0].contiguous(),
                         sf0, tf0)
    with pytest.raises(TypeError, match="integers"):
        concat_cost_pair(idx_u.float(), idx_p, src, tgt, sf0, tf0)
    with pytest.raises(ValueError, match="is on"):          # a pool left on the CPU
        concat_cost_pair(idx_u, idx_p, src, tgt.cpu(), sf0, tf0)
    with pytest.raises(TypeError):
        concat_cost_pair(idx_u, idx_p, src.double(), tgt.double(), sf0, tf0)
    assert concat_cost_pair.launches == before


LAM_S = float(np.float32(0.753) * np.float32(10.0 / 1200.0))
SWITCH = float(np.float32(0.291))


def _viterbi_costs(N, C, seed, ties, device):
    rng = np.random.default_rng(seed)
    cost_v = rng.standard_normal((N, C)).astype(np.float32)
    cost_u = (rng.standard_normal(N) * 0.5).astype(np.float32)
    if ties == "const":                                    # every row one value
        cost_v[:] = cost_v[:, :1]
    elif ties:
        cost_v[::3] = 1e3                                  # silent frames
        cost_v[1::4, C // 2:] = cost_v[1::4, C // 2:C // 2 + 1]   # flat runs
        cost_v[2::5] = np.round(cost_v[2::5])              # repeated values
        cost_u[::7] = 1e3
    return torch.from_numpy(cost_v).to(device), torch.from_numpy(cost_u).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("N,C,ties", [
    *[(N, C, True) for N in (1, 2, 1501) for C in (1, 9, 482)],
    (1501, 482, False),     # the main path's shape: one 30-s chunk, 482 candidates
    (300, MAX_STATES - 1, True),   # the limit: 16384 states in shared memory
    # C + 1 on either side of a thread's (4 states) and a warp's (128) boundary
    *[(70, C, True) for C in (3, 4, 5, 127, 128, 129, 255, 256, 511)],
    # on either side of each instance: 512 and 1024 states in registers,
    # 2048 to 16384 in shared memory
    *[(70, C, True) for C in (512, 1023, 1024, 2047, 2048, 4095, 4096, 8191, 8192)],
    # grid_cents 5, 2 and 1: a 30-s chunk's frames
    *[(1501, C, True) for C in (963, 2406, 4812)],
    *[(N, 2406, True) for N in (1, 2, 33)],
    # N around the emission ring (8 rows) and the backtrack block (32 rows)
    *[(N, 482, True) for N in (7, 8, 9, 32, 33, 64, 65)],
    # every cost_v row constant: the argmin ties at every level
    (1501, 482, "const"), (65, MAX_STATES - 1, "const"), (33, 5, "const"),
    (65, 963, "const"), (65, 4812, "const"),
])
def test_viterbi_kernel_matches_plain(N, C, ties):
    cost_v, cost_u = _viterbi_costs(N, C, seed=N + C, ties=ties, device=_cuda())
    before = f0_viterbi.launches
    got = f0_viterbi(cost_v, cost_u, LAM_S, SWITCH)
    torch.cuda.synchronize()
    assert f0_viterbi.launches == before + 1
    want = viterbi_plain(cost_v, cost_u, LAM_S, SWITCH)
    assert got.dtype == torch.int32 and got.shape == (N,)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), viterbi_plain(cost_v.cpu(), cost_u.cpu(), LAM_S, SWITCH))


@pytest.mark.gpu
def test_viterbi_kernel_rejects_bad_inputs():
    cost_v, cost_u = _viterbi_costs(20, 9, seed=1, ties=False, device=_cuda())
    before = f0_viterbi.launches
    with pytest.raises(TypeError, match="float32"):
        f0_viterbi(cost_v.double(), cost_u, LAM_S, SWITCH)
    with pytest.raises(ValueError, match="contiguous"):
        f0_viterbi(cost_v.t().contiguous().t(), cost_u, LAM_S, SWITCH)
    with pytest.raises(ValueError, match="states"):
        f0_viterbi(torch.zeros(4, MAX_STATES, device=cost_v.device), cost_u[:4], LAM_S, SWITCH)
    with pytest.raises(ValueError, match="is on"):
        f0_viterbi(cost_v, cost_u.cpu(), LAM_S, SWITCH)
    assert f0_viterbi.launches == before


@pytest.mark.gpu
def test_device_f0_card_matches_cpu():
    from knnsvc_torch.dsp.f0_device import device_f0

    dev = _cuda()
    rng = np.random.default_rng(3)
    t = np.arange(16000 * 8) / 16000
    phase = 2 * np.pi * np.cumsum(220 * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))) / 16000
    x = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    x = (x * (0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t)))).astype(np.float32)
    x[:8000] = 0.0
    before = f0_viterbi.launches
    card = device_f0(x, 16000, device=dev)
    assert f0_viterbi.launches == before + 1
    cpu = device_f0(x, 16000, device="cpu")
    assert card.shape == cpu.shape == (len(x) // 320 + 1,)
    assert ((card > 0) == (cpu > 0)).mean() >= 0.995
    both = (card > 0) & (cpu > 0)
    assert both.mean() > 0.5
    assert (np.abs(1200 * np.log2(card[both] / cpu[both])) <= 1.0).mean() >= 0.99


# a small encoder with WavLM-Large's head dim (64) and its 24 layers; the head
# dim is a choice: the kernel takes every head dim up to 256
_GPU_WAVLM = dict(extractor_mode="layer_norm", encoder_layers=24, encoder_embed_dim=128,
                  encoder_ffn_embed_dim=256, encoder_attention_heads=2, layer_norm_first=True,
                  conv_feature_layers="[(32,10,5)] + [(32,4,4)] + [(32,4,4)] + [(32,4,4)]",
                  conv_bias=True, conv_pos=16, conv_pos_groups=4,
                  relative_position_embedding=True, num_buckets=32, max_distance=128,
                  gru_rel_pos=True)


def _gpu_wavlm(device):
    from knnsvc_torch.config import WavLMConfig
    from knnsvc_torch.io.jax_params import wavlm_from_numpy
    from knnsvc_torch.models.wavlm.model import init_wavlm_params

    cfg = WavLMConfig.from_dict(_GPU_WAVLM)
    params = init_wavlm_params(cfg, torch.Generator().manual_seed(0))
    return wavlm_from_numpy(params, cfg, device), wavlm_from_numpy(params, cfg, "cpu")


def _sung(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    phase = 2 * np.pi * np.cumsum(230 * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))) / 16000
    x = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(len(t))
    return torch.from_numpy(x.astype(np.float32))[None]


@pytest.mark.gpu
def test_bucketed_encode_card_matches_cpu_without_the_kernel():
    """The masked bucketed encoder runs plain attention (no kernel launch),
    as the JAX package sends masked calls to its einsums; an exact encode of
    the same samples launches the kernel once per layer."""
    dev = _cuda()
    card, cpu = _gpu_wavlm(dev)
    wav = _sung(1.7, 1)
    before = gated_bias_attention_diag.launches
    with torch.no_grad():
        got = card.extract_layer_bucketed(wav.to(dev), 6)
        torch.cuda.synchronize()
        assert gated_bias_attention_diag.launches == before
        want = cpu.extract_layer_bucketed(wav, 6)
        card.extract_layer(wav.to(dev), 6)
        torch.cuda.synchronize()
    assert gated_bias_attention_diag.launches == before + 6
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_all_layer_encode_launches_the_kernel_per_layer():
    dev = _cuda()
    card, cpu = _gpu_wavlm(dev)
    wav = _sung(1.3, 2)
    before = gated_bias_attention_diag.launches
    with torch.no_grad():
        got = card.extract_all_layers(wav.to(dev))
        torch.cuda.synchronize()
        assert gated_bias_attention_diag.launches == before + 24
        want = cpu.extract_all_layers(wav)
    assert got.shape == want.shape == (25, 1, want.shape[2], 128)
    assert float((got.cpu() - want).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("Q,P,D", [(1500, 9000, 1024), (7, 101, 60)])
def test_int8_knn_card_matches_cpu_exactly(Q, P, D):
    """torch._int_mm on the card (rows, columns and depth padded to its
    shape rules) against the CPU's exact float32 product: dots and indices
    equal."""
    from knnsvc_torch.match.quantized_pool import (int8_dot, knn_topk_quantized,
                                                   quantize_pool, quantize_rows)

    dev = _cuda()
    rng = np.random.default_rng(Q)
    pool = rng.standard_normal((P, D)).astype(np.float32)
    query = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    cpu_pool, card_pool = quantize_pool(pool, device="cpu"), quantize_pool(pool, dev)
    q8, _ = quantize_rows(query)
    q8_card, _ = quantize_rows(query.to(dev))
    assert torch.equal(q8_card.cpu(), q8)
    assert torch.equal(int8_dot(q8_card, card_pool.values).cpu(), int8_dot(q8, cpu_pool.values))
    got, _ = knn_topk_quantized(query.to(dev), card_pool)
    want, _ = knn_topk_quantized(query, cpu_pool)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_concat_kernel_at_bulk_shapes():
    """A bulk target pool (P = 3000 > one 30-s chunk) and a bucket-padded
    query (T = 1750, a multiple of 250): picks equal to the plain version."""
    idx_u, idx_p, src, tgt, sf0, tf0 = _concat_inputs(1750, 3000, 1024, 11, _cuda())
    src[1700:] = src[1699]                      # the edge-replicated bucket padding
    sf0[1700:] = 0.0
    got = concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0, concat_weight=0.2)
    want = knn_with_concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0, concat_weight=0.2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4, 8, 32])
@pytest.mark.parametrize("carry_weight", [0.2, 0.0])
@pytest.mark.parametrize("D", [128, 127])
def test_concat_carried_entry_matches_plain(k, carry_weight, D):
    """The carried entry (carry as frame 0, the pitched lanes from the
    carried weight) against the plain carried cores, both lanes and each
    single lane, one launch each."""
    idx_u, idx_p, src, tgt, sf0, tf0 = _concat_inputs(37, 53, D, 13, _cuda(), True, k)
    s = 9
    carry = torch.randint(0, 53, (2, k), generator=torch.Generator().manual_seed(k)).to(src.device)
    args = (idx_u[s:], idx_p[s:], src[s - 1], src[s:], tgt, sf0[s:], tf0, carry,
            torch.tensor(carry_weight, device=src.device))
    before = concat_cost_pair.launches
    got = concat_cost_pair_stream(*args, concat_weight=0.2)
    got_s = concat_cost_single_stream(idx_u[s:], src[s - 1], src[s:], tgt, carry[0],
                                      carry_weight, concat_weight=0.2)
    got_sp = concat_cost_single_stream(idx_p[s:], src[s - 1], src[s:], tgt, carry[1],
                                       carry_weight, sf0[s:], tf0, concat_weight=0.2)
    torch.cuda.synchronize()
    assert concat_cost_pair.launches == before + 3
    want = concat_cost_pair_stream_core(*args, concat_weight=0.2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    want_s = concat_cost_stream_core(idx_u[s:], src[s - 1], src[s:], tgt, carry[0],
                                     carry_weight, concat_weight=0.2)
    want_sp = concat_cost_stream_core(idx_p[s:], src[s - 1], src[s:], tgt, carry[1],
                                      carry_weight, sf0[s:], tf0, concat_weight=0.2)
    for g, w in (*zip(got_s, want_s), *zip(got_sp, want_sp)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_concat_chained_chunks_equal_the_whole_utterance_kernel():
    """Three chunks (the first through the whole-utterance entry, the
    others carried) give the whole-utterance kernel's picks on every frame."""
    idx_u, idx_p, src, tgt, sf0, tf0 = _concat_inputs(300, 400, 1024, 17, _cuda(), k=4)
    whole = concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0, concat_weight=0.2)
    bounds = (0, 120, 121, 300)
    u, p = concat_cost_pair(idx_u[:120], idx_p[:120], src[:120], tgt, sf0[:120], tf0,
                            concat_weight=0.2)
    us, ps = [u], [p]
    s = scan_inputs(src[:120], None, None)[1]
    w = 0.2 * float(torch.prod((s < 0.08).float()))
    for a, b in zip(bounds[1:-1], bounds[2:]):
        u, p, ws = concat_cost_pair_stream(idx_u[a:b], idx_p[a:b], src[a - 1], src[a:b], tgt,
                                           sf0[a:b], tf0, torch.stack([us[-1][-1], ps[-1][-1]]),
                                           w, concat_weight=0.2)
        us.append(u)
        ps.append(p)
        w = ws[-1]
    assert torch.equal(torch.cat(us), whole[0]) and torch.equal(torch.cat(ps), whole[1])


# tests/test_training.py's tiny vocoder (TINY_H), discriminators at 1/8 width
_TINY_H = dict(upsample_initial_channel=32, n_harmonic=4, hubert_dim=16, hifi_dim=16,
               segment_size=1280, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
               batch_size=2)


@pytest.mark.gpu
def test_train_step_card_matches_cpu():
    """Three GAN train steps on the card against the CPU from one state and
    batch, "highest" precision: metrics at rtol 1e-3, parameters at 1e-4
    (cuDNN and cuFFT sum in other orders than the CPU kernels)."""
    from knnsvc_torch.config import HiFiGANConfig, ModelFamily
    from knnsvc_torch.io.jax_params import tree_from_module
    from knnsvc_torch.train.trainer import init_train_state, make_train_step

    dev = _cuda()
    set_precision("highest")
    h = HiFiGANConfig.from_dict(_TINY_H)
    rng = np.random.default_rng(3)
    T = h.segment_size // h.hop_size
    batch = {"feats": rng.standard_normal((2, T, 16)), "audio": rng.standard_normal((2, 1280)) * 0.1,
             "mel_loss": np.full((2, 80, 4), -5.0), "f0": rng.random((2, T, 1)) * 200,
             "harmonics": rng.random((2, T, 49)) * 0.05}
    results = []
    for device in (dev, torch.device("cpu")):
        state = init_train_state(0, h, ModelFamily.MIX, disc_width_scale=8, device=device)
        step = make_train_step(h, ModelFamily.MIX)
        b = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in batch.items()}
        metrics = [{k: float(v) for k, v in step(state, b).items()} for _ in range(3)]
        results.append((metrics, tree_from_module(state.generator)))
    (card_m, card_g), (cpu_m, cpu_g) = results
    for a, b in zip(card_m, cpu_m):
        for k in a:
            assert np.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-3 * abs(b[k]), (k, a[k], b[k])
    a_leaves, b_leaves = [], []

    def walk(x, y):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k])
        elif isinstance(x, list):
            for u, v in zip(x, y):
                walk(u, v)
        else:
            a_leaves.append(x)
            b_leaves.append(y)

    walk(card_g, cpu_g)
    assert max(float(np.abs(u - v).max()) for u, v in zip(a_leaves, b_leaves)) <= 1e-4


@pytest.mark.gpu
def test_prematch_on_the_card_launches_the_kernel(tmp_path):
    """per_spk_extract on the card: 6 attention launches per 30-s chunk of
    each utterance (a 24-layer encoder with the kernel's head dim, layer 6),
    the pickles written with the JAX package's keys and dtypes."""
    import pickle

    from knnsvc_torch.config import WavLMConfig
    from knnsvc_torch.io.audio import save_audio
    from knnsvc_torch.models.wavlm.model import init_wavlm_params
    from knnsvc_torch.train.prematch import per_spk_extract
    from knnsvc_torch.utils.layer_weights import generate_matrix_from_index

    dev = _cuda()
    (tmp_path / "data" / "spk").mkdir(parents=True)
    for i in range(2):
        save_audio(tmp_path / "data" / "spk" / f"u{i}.wav", _sung(1.5 + i, i)[0].numpy(), 16000)
    cfg = WavLMConfig.from_dict(_GPU_WAVLM)
    params = init_wavlm_params(cfg, torch.Generator().manual_seed(0))
    w = generate_matrix_from_index(6)
    before = gated_bias_attention_diag.launches
    per_spk_extract(tmp_path / "data", tmp_path / "out", params, cfg, w, w, device=dev)
    assert gated_bias_attention_diag.launches == before + 2 * 6
    with open(tmp_path / "out" / "spk" / "u1.pt", "rb") as fh:
        fd = pickle.load(fh)
    assert fd["nearest_nbrs"].dtype == np.int64 and fd["nearest_nbrs"].shape[1] == 32
    assert np.isfinite(fd["harmonics_best_weight_para"]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("S,k,D", [(1, 4, 1024), (2, 4, 1024), (3, 8, 1024), (4, 32, 128),
                                   (1, 4, 1023), (2, 4, 1022), (3, 8, 1021), (4, 32, 127)])
def test_concat_sharded_entries_match_plain(S, k, D):
    from knnsvc_torch.parallel import make_mesh
    from knnsvc_torch.parallel.mesh import gather_rows, shard_rows

    dev = _cuda()
    T, P = 120, 301                                  # 301: no multiple of 2, 3 or 4
    idx_u, idx_p, src, tgt, sf0, tf0 = _concat_inputs(T, P, D, 17, dev, True, k)
    shards = shard_rows(tgt, make_mesh(1, S, devices=[dev] * S))[0]
    before = concat_cost_pair.launches
    got = concat_cost_pair_sharded(idx_u, idx_p, src, shards, P, sf0, tf0, concat_weight=0.2)
    got_s = concat_cost_single_sharded(idx_p, src, shards, P, sf0, tf0, concat_weight=0.3)
    torch.cuda.synchronize()
    assert concat_cost_pair.launches == before + 2
    rows = lambda ids: gather_rows(shards, ids)
    want = knn_with_concat_cost_pair(idx_u, idx_p, src, rows, sf0, tf0, concat_weight=0.2,
                                     pool_len=P)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got_s, knn_with_concat_cost(idx_p, src, rows, sf0, tf0,
                                                   concat_weight=0.3, pool_len=P))
    dense = concat_cost_pair(idx_u, idx_p, src, tgt, sf0, tf0, concat_weight=0.2)
    assert all(torch.equal(a, b) for a, b in zip(got, dense))
    with pytest.raises(ValueError, match="is on cpu"):
        concat_cost_pair_sharded(idx_u, idx_p, src, [t.cpu() for t in shards], P, sf0, tf0)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 4])
def test_sharded_match_on_the_card_equals_dense(S):
    from knnsvc_torch.match.pipeline import match_core_post_opt
    from knnsvc_torch.parallel import make_mesh
    from knnsvc_torch.parallel.sharded_match import shard_speaker_pool, sharded_match_core

    dev = _cuda()
    rng = np.random.default_rng(23)
    T, P, D = 200, 1001, 1024
    q, matching, synth = (torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
                          .to(dev) for n in (T, P, P))
    pool_f0 = torch.from_numpy((150 + 300 * rng.random(P)).astype(np.float32)).to(dev)
    qf0 = torch.from_numpy((100 + 200 * rng.random(T)).astype(np.float32)).to(dev)
    harm = torch.from_numpy(rng.random((P, 49)).astype(np.float32)).to(dev)
    mesh = make_mesh(1, S, devices=[dev] * S)
    sp = shard_speaker_pool(matching, synth, pool_f0, harm, mesh)
    before = concat_cost_pair.launches
    got = sharded_match_core(q, qf0, sp.matching, sp.synth, sp.harmonics, sp.f0, sp.true_len,
                             None, mesh=mesh, topk=4, use_harmonics=True, concat_weight=0.2,
                             opt_enabled=False)
    torch.cuda.synchronize()
    assert concat_cost_pair.launches == before + 1
    want = match_core_post_opt(q, matching, synth, pool_f0, harm, qf0, None, topk=4,
                               use_harmonics=True, concat_weight=0.2, opt_enabled=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _tiny_train_run(device, mesh=None, n=3, batch_size=2):
    """n tiny GAN steps from init_train_state(0) on `device` (or mesh):
    -> (metrics per step, generator tree)."""
    from knnsvc_torch.config import HiFiGANConfig, ModelFamily
    from knnsvc_torch.io.jax_params import tree_from_module
    from knnsvc_torch.train.trainer import init_train_state, make_train_step

    h = HiFiGANConfig.from_dict(_TINY_H)
    rng = np.random.default_rng(4)
    T = h.segment_size // h.hop_size
    batch = {"feats": rng.standard_normal((batch_size, T, 16)),
             "audio": rng.standard_normal((batch_size, 1280)) * 0.1,
             "mel_loss": np.full((batch_size, 80, 4), -5.0),
             "f0": rng.random((batch_size, T, 1)) * 200,
             "harmonics": rng.random((batch_size, T, 49)) * 0.05}
    state = init_train_state(0, h, ModelFamily.MIX, disc_width_scale=8, device=device)
    step = make_train_step(h, ModelFamily.MIX, mesh=mesh)
    b = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(state, b).items()} for _ in range(n)]
    return metrics, tree_from_module(state.generator)


def _max_tree_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(_max_tree_diff(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return max(_max_tree_diff(u, v) for u, v in zip(a, b))
    return float(np.abs(a - b).max())


@pytest.mark.gpu
def test_data_parallel_step_on_logical_shards_of_the_card():
    """The train step on a (2, 1) mesh of the card (two replicas, a batch
    of 4 split in two) against the one-device step: metrics at rtol 1e-4,
    the generator at 1e-5 (tests/test_training.py:101-120's bounds)."""
    from knnsvc_torch.parallel.mesh import make_mesh

    dev = _cuda()
    set_precision("highest")
    one_m, one_g = _tiny_train_run(dev, batch_size=4)
    two_m, two_g = _tiny_train_run(dev, make_mesh(2, 1, devices=[dev] * 2), batch_size=4)
    for a, b in zip(two_m, one_m):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (k, a[k], b[k])
    assert _max_tree_diff(two_g, one_g) <= 1e-5


@pytest.mark.gpu
def test_nccl_group_of_one_runs_the_all_reduce():
    """initialize_distributed over NCCL with a world of 1 at 127.0.0.1: the
    step all-reduces its gradients and metrics on the card and gives the
    plain step's numbers; the group is torn down after."""
    import socket

    from knnsvc_torch.parallel.mesh import initialize_distributed

    dev = _cuda()
    set_precision("highest")
    want_m, want_g = _tiny_train_run(dev, n=2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        got_m, got_g = _tiny_train_run(dev, n=2)
    finally:
        torch.distributed.destroy_process_group()
    for a, b in zip(got_m, want_m):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), (k, a[k], b[k])
    assert _max_tree_diff(got_g, want_g) <= 1e-6
