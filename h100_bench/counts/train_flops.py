"""Matmul and conv FLOPs (2 x multiply-adds) of one training step of the
vocoder (knnsvc_torch/train/trainer.py's D step then G step), from its
shapes. Per batch item of L samples and T = L / hop frames, with G the
generator's forward (counts/flops.py `hifigan_flops` at T) and D the MPD's
and the MSD's forward on one signal:

    D step:  G (y_hat, no gradient) + 2 D (y and y_hat) + 4 D (the
             backward: gradients in the weights and in the inputs)
    G step:  G + 2 G (its backward) + 2 D (y and y_hat) + 1 D (the
             backward through the frozen D on y_hat, inputs only)
    step  =  4 G + 9 D per item

A backward counts twice its forward (weights and inputs), once where only
the inputs' gradient is needed. The log-mel, the losses and AdamW are left
out, so a share of the peak from these counts is a lower bound."""

from __future__ import annotations

from types import SimpleNamespace

from h100_bench.counts.flops import hifigan_flops
from h100_bench.inputs import MPD_CHANNELS, MPD_PERIODS, msd_channels


def _conv_out(n: int, k: int, s: int, pad: int) -> int:
    return (n + 2 * pad - k) // s + 1


def mpd_flops(n_samples: int, width_scale: int = 1) -> int:
    """The five period sub-discriminators on one signal."""
    top = 1024 // width_scale
    chans = [1] + [c // width_scale for c in MPD_CHANNELS] + [top]
    total = 0
    for p in MPD_PERIODS:
        h = -(-n_samples // p)                       # reflect-padded to a multiple of p
        for i in range(5):
            cin, cout = (chans[i], chans[i + 1]) if i < 4 else (top, top)
            h = _conv_out(h, 5, 3 if i < 4 else 1, 2)
            total += 2 * 5 * cin * cout * h * p
        total += 2 * 3 * top * 1 * h * p             # conv_post
    return total


def msd_flops(n_samples: int, width_scale: int = 1) -> int:
    """The three scale sub-discriminators (AvgPool(4, 2, pad 2) between)."""
    total, n = 0, n_samples
    specs = msd_channels(width_scale)
    for scale in range(3):
        if scale:
            n = _conv_out(n, 4, 2, 2)
        length = n
        for cin, cout, k, s, g, pad in specs:
            length = _conv_out(length, k, s, pad)
            total += 2 * k * (cin // g) * cout * length
        total += 2 * 3 * specs[-1][1] * length       # conv_post
    return total


def train_step_flops(config: dict) -> int:
    h = SimpleNamespace(**config["hifigan"])
    family = "mix" if config["family"] == "mix" else "f0"
    ws = config.get("disc_width_scale", 1)
    L = h.segment_size
    g = hifigan_flops(h, L // h.hop_size, family)
    d = mpd_flops(L, ws) + msd_flops(L, ws)
    return h.batch_size * (4 * g + 9 * d)
