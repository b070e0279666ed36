"""1-D convolutions in PyTorch's (B, C, T) layout.

Counterpart of ``vqvae_speech_tpu/nn/conv.py``. Padding is symmetric, as in
the reference's ``nn.Conv1d``/``nn.ConvTranspose1d``. With
``use_weight_norm`` the module holds the explicit ``weight_norm(dim=0)``
pair: direction ``v`` and per-dim-0 magnitude ``g``, resolved on every
forward to ``w = g * v / ||v||`` with the norm over the other two axes —
(Cin, K) for a conv, (Cout, K) for a transposed conv, which is the JAX
package's norm over (K, Cin) of its (K, Cin, Cout) storage.
"""
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Resolve weight norm: ``g * v / ||v||`` with the norm over dims 1, 2."""
    return g[:, None, None] * v / v.square().sum((1, 2), keepdim=True).sqrt()


class _ConvBase(nn.Module):
    def __init__(self, shape, fan_in: int, bias_size: int, bias: bool,
                 use_weight_norm: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # torch's default conv init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)); real
        # weights come from convert.load_jax_params
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty(shape).uniform_(-bound, bound, generator=generator)
        if use_weight_norm:
            self.v = nn.Parameter(w)
            self.g = nn.Parameter(w.square().sum((1, 2)).sqrt())
        else:
            self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.empty(bias_size).uniform_(
            -bound, bound, generator=generator)) if bias else None)
        self.use_weight_norm = use_weight_norm

    def resolved_weight(self) -> torch.Tensor:
        return conv_weight(self.v, self.g) if self.use_weight_norm else self.weight


class Conv1d(_ConvBase):
    """(B, Cin, T) -> (B, Cout, T'); weight (Cout, Cin, K)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 use_weight_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__((out_ch, in_ch, kernel_size), in_ch * kernel_size,
                         out_ch, bias, use_weight_norm, generator)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.resolved_weight(), self.bias,
                        stride=self.stride, padding=self.padding)


class ConvTranspose1d(_ConvBase):
    """(B, Cin, T) -> (B, Cout, (T-1)*stride - 2*padding + K);
    weight (Cin, Cout, K)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 use_weight_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__((in_ch, out_ch, kernel_size), out_ch * kernel_size,
                         out_ch, bias, use_weight_norm, generator)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.resolved_weight(), self.bias,
                                  stride=self.stride, padding=self.padding)
