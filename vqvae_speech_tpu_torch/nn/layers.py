"""Residual block, tied residual stack, time-jitter and nearest upsampling
in (B, C, T).

Counterpart of ``vqvae_speech_tpu/nn/layers.py``.
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


def jitter_masks(T: int, probability: float = 0.12, inverted: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
    """The jitter's two draws for T timesteps: ``replace`` (T,) bool and
    ``direction`` (T,) int64 in {-1, +1}, drawn on the CPU from ``generator``
    (so that one seed gives one sequence on any device) and moved to
    ``device``. ``inverted`` replaces with probability 1 - p (the reference's
    quirk, PARITY #5)."""
    p_replace = (1.0 - probability) if inverted else probability
    replace = torch.rand(T, generator=generator) < p_replace
    direction = torch.where(torch.rand(T, generator=generator) < 0.5, 1, -1)
    return replace.to(device), direction.to(device)


def jitter(x_bct: torch.Tensor, probability: float = 0.12,
           inverted: bool = True, detach_replacements: bool = True, *,
           replace: Optional[torch.Tensor] = None,
           direction: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Chorowski time-jitter on (B, C, T): each timestep is replaced, with
    one draw shared across batch and channels, by a neighbour's frame.

    Boundary frames use their only neighbour (t=0 -> 1, t=T-1 -> T-2);
    interior frames take t-1 or t+1 by ``direction``. Replacements read the
    ORIGINAL tensor. With ``detach_replacements`` (the reference's gradient
    semantics, PARITY #34) replaced frames carry no gradient; without it the
    gather is live and a replaced frame backpropagates into its source.
    ``replace`` (T,) bool and ``direction`` (T,) of +-1 are taken when given
    (tests feed the JAX package's draws) and drawn from ``generator``
    otherwise. A neighbour index past the end is clamped, as JAX clamps its
    gathers: at T = 1 every frame reads frame 0 (and, as JAX drops the
    out-of-range scatter of that gather's gradient, with no gradient).
    """
    T = x_bct.shape[2]
    if replace is None or direction is None:
        replace, direction = jitter_masks(T, probability, inverted, generator,
                                          x_bct.device)
    replace = replace.to(x_bct.device, torch.bool)
    t = torch.arange(T, device=x_bct.device)
    neighbor = torch.where(
        t == 0, 1, torch.where(t == T - 1, T - 2,
                               t + direction.to(x_bct.device, t.dtype)))
    in_range = neighbor.clamp(0, T - 1)
    clamped = replace & (in_range != neighbor)
    neighbor = in_range
    if not detach_replacements:
        out = x_bct[:, :, torch.where(replace, neighbor, t)]
        return torch.where(clamped[None, None, :], out.detach(), out)
    return torch.where(replace[None, None, :],
                       x_bct.detach()[:, :, neighbor], x_bct)
