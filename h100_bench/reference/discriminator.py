"""HiFi-GAN v1's discriminators (ref hifigan/ddsp_models.py:496-616): a frozen
copy of knnsvc_torch/models/hifigan/discriminator.py:95-218 with plain convs.
Their weight and spectral norms are applied by reference/train.py, which
calls these modules on effective weights."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LRELU_SLOPE

MPD_PERIODS = (2, 3, 5, 7, 11)
_MPD_CHANNELS = (32, 128, 512, 1024)
_MSD_SPECS = [
    # (out, k, stride, groups, pad)
    (128, 15, 1, 1, 7),
    (128, 41, 2, 4, 20),
    (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20),
    (1024, 41, 4, 16, 20),
    (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
]


class DiscriminatorP(nn.Module):
    """One period sub-discriminator (ref ddsp_models.py:496-529)."""

    def __init__(self, period: int, width_scale: int = 1):
        super().__init__()
        self.period = period
        top = 1024 // width_scale
        chans = [1] + [c // width_scale for c in _MPD_CHANNELS] + [top]
        self.convs = nn.ModuleList(
            [nn.Conv2d(chans[i], chans[i + 1], (5, 1), (3, 1), padding=(2, 0)) for i in range(4)]
            + [nn.Conv2d(top, top, (5, 1), 1, padding=(2, 0))])
        self.conv_post = nn.Conv2d(top, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x: torch.Tensor):
        """x (B, 1, T) -> (logits (B, n), feature maps)."""
        return discriminator_p_apply(self, self.period, x)


class MultiPeriodDiscriminator(nn.Module):
    """(ref ddsp_models.py:532-556). n_periods < 5 keeps the first periods."""

    def __init__(self, width_scale: int = 1, n_periods: int | None = None):
        super().__init__()
        periods = MPD_PERIODS[: len(MPD_PERIODS) if n_periods is None else n_periods]
        self.discriminators = nn.ModuleList(DiscriminatorP(p, width_scale) for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (y_d_rs, y_d_gs, fmap_rs, fmap_gs)."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            r, fr = d(y)
            g, fg = d(y_hat)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def _msd_channels(width_scale: int) -> list[tuple[int, int, int, int, int, int]]:
    """(in, out, k, stride, groups, pad) of each scale conv."""
    in_c, out = 1, []
    for o, k, s, g, pad in _MSD_SPECS:
        o = max(g, o // width_scale)
        out.append((in_c, o, k, s, g, pad))
        in_c = o
    return out


class DiscriminatorS(nn.Module):
    """One scale sub-discriminator (ref ddsp_models.py:559-584)."""

    def __init__(self, width_scale: int = 1):
        super().__init__()
        specs = _msd_channels(width_scale)
        self.convs = nn.ModuleList(nn.Conv1d(i, o, k, s, groups=g, padding=pad)
                                   for i, o, k, s, g, pad in specs)
        self.conv_post = nn.Conv1d(specs[-1][1], 1, 3, 1, padding=1)

    def forward(self, x: torch.Tensor):
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """(ref ddsp_models.py:587-616). n_scales < 3 keeps the first scales."""

    def __init__(self, width_scale: int = 1, n_scales: int | None = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(width_scale) for _ in range(3 if n_scales is None else n_scales))
        # AvgPool1d(4, 2, padding=2), count_include_pad=True
        self.meanpool = nn.AvgPool1d(4, 2, padding=2)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (y_d_rs, y_d_gs, fmap_rs, fmap_gs)."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i != 0:
                y, y_hat = self.meanpool(y), self.meanpool(y_hat)
            r, fr = d(y)
            g, fg = d(y_hat)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def discriminator_p_apply(disc: DiscriminatorP, period: int, x: torch.Tensor,
                          kernel_size: int = 5, stride: int = 3):
    """One period sub-discriminator on x (B, 1, T) folded to (T/period,
    period), its first four convs at `stride` over time: -> (logits (B, n),
    feature maps). kernel_size is taken and unused, as in the JAX package:
    the kernel is the weights' own and the padding (2, 0)."""
    del kernel_size
    B, C, T = x.shape
    if T % period:
        x = F.pad(x, (0, period - T % period), mode="reflect")
    x = x.reshape(B, C, -1, period)
    fmap = []
    for i, conv in enumerate(disc.convs):
        x = F.conv2d(x, conv.weight, conv.bias, (stride, 1) if i < 4 else 1, (2, 0))
        x = F.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = disc.conv_post(x)
    fmap.append(x)
    return x.reshape(B, -1), fmap


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """Sum of mean |.| over every feature map pair, x2 (ref :619-625)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN D loss (ref :628-639). Returns (total, r_losses, g_losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN G adversarial loss (ref :642-650). Returns (total, per-disc losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1 - dg) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses
