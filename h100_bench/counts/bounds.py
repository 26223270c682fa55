"""Least times of the hand-written kernels' work on an H100, from their
shapes: frozen copies of chip_smoke.py:352-362 `attention_bound_ms`,
chip_smoke.py:623-631 `concat_bound_ms` and chip_smoke.py:820-827
`viterbi_bound_ms` (VITERBI_FLOPS_PER_STATE from chip_smoke.py:239)."""

from __future__ import annotations

from .peaks import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS

VITERBI_FLOPS_PER_STATE = 10     # fp32 adds, subtracts and compares per state and frame


def attention_bound_ms(H: int, T: int, d: int, passes: int = 3,
                       full: bool = False) -> tuple[float, str]:
    """Least time for the kernel's work on an H100: `passes` TF32
    tensor-core passes of the two products (2 flops per multiply-add,
    4*H*T^2*d each); bytes = q, k, v, the bias (its (H, 2T-1) diagonal, or
    the (H, T, T) tensor when full) and gate read once and out written
    once."""
    ops = passes * 4 * H * T * T * d
    nbytes = 4 * (4 * H * T * d + (H * T * T if full else H * (2 * T - 1)) + H * T)
    t_ops, t_bytes = ops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def concat_bound_ms(T: int, P: int, D: int, lanes: int, k: int) -> tuple[float, str]:
    """Least time for the work on an H100: per frame and lane 2k^2 + 2k
    dots of D multiply-adds (k x 2k cross dots against the picks, 2k source
    dots), plus the P pool norms once, 2 flops each; bytes = source and pool
    rows, ids, f0 tracks and baselines read once and the picks written once."""
    ops = (lanes * (T - 1) * (2 * k * k + 2 * k) + P) * 2 * D
    nbytes = 4 * (T * D + P * D + 2 * T * lanes * k + (T - 1) + T + P)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def viterbi_bound_ms(N: int, C: int) -> tuple[float, str]:
    """Least time for the recursion on an H100: the (N, C) and (N,) costs
    read once and the (N,) states written once at the HBM rate; per frame
    and state ~VITERBI_FLOPS_PER_STATE fp32 operations at the fp32 peak."""
    nbytes = 4 * (N * C + N + N)
    ops = VITERBI_FLOPS_PER_STATE * (N - 1) * (C + 1)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
