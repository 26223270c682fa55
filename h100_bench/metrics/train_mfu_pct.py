"""A step's matmul and conv FLOPs (counts/train_flops.py) times the steps of
the untraced window that the traced steps follow, over its wall time to its
closing synchronize, against the card's 67-TFLOP/s fp32 peak."""

from h100_bench.counts.peaks import PEAK_FP32_FLOPS
from h100_bench.counts.train_flops import train_step_flops


def read(view):
    if not view.window_units or view.window_wall_s <= 0:
        return None
    return 100.0 * train_step_flops(view.config) * len(view.window_units) \
        / view.window_wall_s / PEAK_FP32_FLOPS
