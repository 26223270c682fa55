"""Conv blocks of the vocoder (counterpart of knnsvc_tpu/models/hifigan/layers.py).

Weight layout is torch's own, so the JAX package's folded weights carry
across unchanged (io/jax_params.py); its ConvTranspose1d, lowered there as a
matmul plus overlap-add, is torch's ConvTranspose1d here with the same
(in, out, k) weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1  # ref hifigan/ddsp_models.py:10


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    # ref hifigan/utils.py:37-38
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """Pairs of (dilated conv, plain conv) with pre-activation leaky-relu and
    residual adds (ref hifigan/ddsp_models.py:13-44)."""

    def __init__(self, ch: int, kernel_size: int, dilations: tuple[int, ...]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(ch, ch, kernel_size, dilation=d, padding=get_padding(kernel_size, d))
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(ch, ch, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """Dilated convs only, each with a pre-activation leaky-relu and a
    residual add (ref hifigan/ddsp_models.py:55-72)."""

    def __init__(self, ch: int, kernel_size: int, dilations: tuple[int, ...]):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(ch, ch, kernel_size, dilation=d, padding=get_padding(kernel_size, d))
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class ResBlock3(nn.Module):
    """A single dilated conv with a residual add (ref hifigan/ddsp_models.py:81-94)."""

    def __init__(self, ch: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv1d(ch, ch, kernel_size, dilation=dilation,
                                              padding=get_padding(kernel_size, dilation))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


def _check_block(p: nn.Module, kernel_size: int, dilations) -> None:
    """The JAX package's resblock functions take the kernel size and the
    dilations beside the parameters; the port's blocks carry them. They
    must agree."""
    convs = getattr(p, "convs1", getattr(p, "convs", None))
    got = ([c.kernel_size[0] for c in convs], [c.dilation[0] for c in convs])
    want = ([kernel_size] * len(convs), list(dilations))
    if got != want:
        raise ValueError(f"{type(p).__name__} has kernel sizes and dilations {got}, "
                         f"called with {want}")


def resblock1_apply(x: torch.Tensor, p: ResBlock1, kernel_size: int,
                    dilations: tuple[int, ...]) -> torch.Tensor:
    """The JAX package's functional form of calling a ResBlock1."""
    _check_block(p, kernel_size, dilations)
    return p(x)


def resblock2_apply(x: torch.Tensor, p: ResBlock2, kernel_size: int,
                    dilations: tuple[int, ...]) -> torch.Tensor:
    """The JAX package's functional form of calling a ResBlock2."""
    _check_block(p, kernel_size, dilations)
    return p(x)


def resblock3_apply(x: torch.Tensor, p: ResBlock3, kernel_size: int = 3,
                    dilation: int = 1) -> torch.Tensor:
    """The JAX package's functional form of calling a ResBlock3."""
    _check_block(p, kernel_size, [dilation] * len(p.convs))
    return p(x)
