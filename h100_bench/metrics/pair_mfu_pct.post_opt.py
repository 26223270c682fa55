"""The matmul and conv FLOPs (counts/flops.py at each request's lengths) of
the untraced window's requests, over its wall time on the host's clock,
against the card's 67-TFLOP/s fp32 peak."""

from h100_bench.metrics._shares import pair_mfu_pct


def read(view):
    return pair_mfu_pct(view)
