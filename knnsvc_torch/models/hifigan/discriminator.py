"""HiFi-GAN v1 discriminators as nn.Modules (counterpart of
knnsvc_tpu/models/hifigan/discriminator.py; ref hifigan/ddsp_models.py:496-616).

- MultiPeriodDiscriminator: 5 period sub-discriminators (2, 3, 5, 7, 11),
  each a stack of strided Conv2d over the waveform folded to (T/p, p).
- MultiScaleDiscriminator: 3 scale sub-discriminators with AvgPool(4, 2)
  between scales; the first is spectral-normed, the rest weight-normed.

The modules are built with plain convs; the normalizations are attached from
the parameter tree (io/jax_params.py: `discriminators_from_numpy`), where
{"g", "v"} becomes torch's weight-norm parametrization and
{"v_sn", "u", "v_pow"} the SpectralNorm parametrization below.

Spectral norm follows the JAX package, not torch.nn.utils.spectral_norm
(which power-iterates on every forward in train mode): `u` and `v_pow` are
buffers, so no optimizer sees them; every forward uses them as they are,
and `power_iterate` runs the one step the trainer takes per D pass, on the
pre-update weight and outside the gradient (trainer.py there: the
msd_apply(update_sn=True) of the D loss; the G pass uses the result).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import parametrize

from knnsvc_torch.models.hifigan.layers import LRELU_SLOPE

Params = dict[str, Any]

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


class SpectralNorm(nn.Module):
    """Weight parametrization w / sigma, sigma = u^T W v_pow with W the
    weight as (out, -1) and (u, v_pow) stored buffers (eps 1e-12 in the
    power step, as torch.nn.utils.spectral_norm)."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        out, rest = weight.shape[0], weight[0].numel()
        self.register_buffer("u", torch.full((out,), out ** -0.5, device=weight.device))
        self.register_buffer("v_pow", torch.full((rest,), rest ** -0.5, device=weight.device))

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        w_mat = weight.reshape(weight.shape[0], -1)
        sigma = torch.dot(self.u, torch.mv(w_mat, self.v_pow))
        return weight / sigma

    @torch.no_grad()
    def power_iterate(self, weight: torch.Tensor, dtype: torch.dtype | None = None) -> None:
        """One power-iteration step on `weight` (the parametrization's
        original), computed in `dtype` (the step's compute dtype) and stored
        in the buffers' own dtype."""
        dtype = dtype or self.u.dtype
        w = weight.reshape(weight.shape[0], -1).to(dtype)
        v = torch.mv(w.T, self.u.to(dtype))
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = torch.mv(w, v)
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        self.u.copy_(u)
        self.v_pow.copy_(v)


def power_iterate(module: nn.Module, dtype: torch.dtype | None = None) -> None:
    """One power-iteration step of every spectral-normed weight in `module`."""
    for sub in module.modules():
        if parametrize.is_parametrized(sub, "weight"):
            plist = sub.parametrizations.weight
            if isinstance(plist[0], SpectralNorm):
                plist[0].power_iterate(plist.original, dtype)


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


def discriminator_s_apply(disc: DiscriminatorS, x: torch.Tensor, update_sn: bool = False):
    """One scale sub-discriminator on x (B, 1, T), after one spectral-norm
    power-iteration step when update_sn: -> (logits, feature maps, disc).
    The module holds the updated u / v_pow buffers, so it stands where the
    JAX function returns its updated parameters."""
    if update_sn:
        power_iterate(disc)
    return (*disc(x), disc)


def mpd_apply(mpd: MultiPeriodDiscriminator, y: torch.Tensor, y_hat: torch.Tensor):
    """The JAX package's functional form of calling the MPD:
    -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs)."""
    return mpd(y, y_hat)


def msd_apply(msd: MultiScaleDiscriminator, y: torch.Tensor, y_hat: torch.Tensor,
              update_sn: bool = False):
    """The MSD's outputs after one spectral-norm power-iteration step when
    update_sn (the JAX package's D pass): -> (y_d_rs, y_d_gs, fmap_rs,
    fmap_gs, msd). The module holds the updated u / v_pow buffers, so it
    stands where the JAX function returns its updated parameters."""
    if update_sn:
        power_iterate(msd)
    return (*msd(y, y_hat), msd)


# ------------------------------------------------------------------ init


def _randn(generator: torch.Generator, shape, std: float) -> np.ndarray:
    return (torch.randn(shape, generator=generator) * std).numpy()


def _weight_normed(w: np.ndarray) -> Params:
    return {"v": w, "g": np.linalg.norm(w.reshape(w.shape[0], -1), axis=1).reshape(
        (-1,) + (1,) * (w.ndim - 1)).astype(np.float32)}


def init_mpd_params(generator: torch.Generator, weight_norm_parametrized: bool = True,
                    width_scale: int = 1, n_periods: int | None = None) -> Params:
    """Random MPD weights in the JAX package's tree layout (std 0.02, zero
    biases), drawn from `generator`: live weight norm ({"g", "v"}), or the
    effective weights ({"w"}) when not weight_norm_parametrized."""
    top = 1024 // width_scale
    chans = [1] + [c // width_scale for c in _MPD_CHANNELS] + [top]

    def conv2(out_c, in_c, kh):
        w = _randn(generator, (out_c, in_c, kh, 1), 0.02)
        return {**(_weight_normed(w) if weight_norm_parametrized else {"w": w}),
                "b": np.zeros(out_c, np.float32)}

    discs = []
    for _ in MPD_PERIODS[: len(MPD_PERIODS) if n_periods is None else n_periods]:
        convs = [conv2(chans[i + 1], chans[i], 5) for i in range(4)]
        convs.append(conv2(top, top, 5))
        discs.append({"convs": convs, "conv_post": conv2(1, top, 3)})
    return {"discriminators": discs}


def init_msd_params(generator: torch.Generator, weight_norm_parametrized: bool = True,
                    width_scale: int = 1, n_scales: int | None = None) -> Params:
    """Random MSD weights in the JAX package's tree layout: scale 0
    spectral-normed ({"v_sn", "u", "v_pow"}, u and v_pow unit vectors), the
    others weight-normed, or their effective weights ({"w"}) when not
    weight_norm_parametrized."""

    def conv1(out_c, in_c, k, spectral):
        w = _randn(generator, (out_c, in_c, k), 0.02)
        if spectral:
            u = torch.randn(out_c, generator=generator)
            v = torch.randn(in_c * k, generator=generator)
            p = {"v_sn": w, "u": (u / torch.linalg.vector_norm(u)).numpy(),
                 "v_pow": (v / torch.linalg.vector_norm(v)).numpy()}
        elif weight_norm_parametrized:
            p = _weight_normed(w)
        else:
            p = {"w": w}
        p["b"] = np.zeros(out_c, np.float32)
        return p

    discs = []
    for d in range(3 if n_scales is None else n_scales):
        spectral = d == 0  # ref ddsp_models.py:590-594
        specs = _msd_channels(width_scale)
        convs = [conv1(o, i // g, k, spectral) for i, o, k, s, g, pad in specs]
        discs.append({"convs": convs, "conv_post": conv1(1, specs[-1][1], 3, spectral)})
    return {"discriminators": discs}
