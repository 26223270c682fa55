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
