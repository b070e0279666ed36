"""Residual block, tied residual stack and nearest upsampling in (B, C, T).

Counterpart of ``vqvae_speech_tpu/nn/layers.py``. Jitter is a training-time
layer and is not ported yet.
"""
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_speech_tpu_torch.nn.conv import Conv1d


class Residual(nn.Module):
    """ReLU -> conv k3 p1 (no bias) -> ReLU -> conv k1 (no bias), plus x."""

    def __init__(self, in_ch: int, num_hiddens: int, num_residual_hiddens: int,
                 use_weight_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv1d(in_ch, num_residual_hiddens, 3, padding=1,
                            bias=False, use_weight_norm=use_weight_norm,
                            generator=generator)
        self.conv2 = Conv1d(num_residual_hiddens, num_hiddens, 1, bias=False,
                            use_weight_norm=use_weight_norm, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class ResidualStack(nn.Module):
    """ONE Residual block applied ``num_layers`` times (tied weights, as the
    reference's list-multiplied layer list, PARITY #4), then a ReLU."""

    def __init__(self, in_ch: int, num_hiddens: int, num_layers: int,
                 num_residual_hiddens: int, use_weight_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block = Residual(in_ch, num_hiddens, num_residual_hiddens,
                              use_weight_norm, generator)
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.num_layers):
            x = self.block(x)
        return F.relu(x)


def upsample_nearest(x_bct: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """nn.Upsample(scale_factor=scale) nearest-neighbour along time."""
    return torch.repeat_interleave(x_bct, scale, dim=2)
