"""Chorowski-2019 convolutional speech encoder (downsample x2).

Counterpart of ``vqvae_speech_tpu/models/encoder.py``: two k3/p1 convs (the
second with a residual add), a k4/s2/p2 strided conv halving time, two more
k3/p1 residual convs, then the tied residual stack with a skip connection.
ReLU after every conv. (B, features, T) -> (B, num_hiddens, ceil((T+1)/2)).
"""
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_speech_tpu_torch.nn import Conv1d, ResidualStack


class ConvolutionalEncoder(nn.Module):
    def __init__(self, features_filters: int, num_hiddens: int,
                 num_residual_layers: int, num_residual_hiddens: int,
                 use_weight_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(use_weight_norm=use_weight_norm, generator=generator)
        self.conv_1 = Conv1d(features_filters, num_hiddens, 3, padding=1, **kw)
        self.conv_2 = Conv1d(num_hiddens, num_hiddens, 3, padding=1, **kw)
        self.conv_3 = Conv1d(num_hiddens, num_hiddens, 4, stride=2, padding=2,
                             **kw)
        self.conv_4 = Conv1d(num_hiddens, num_hiddens, 3, padding=1, **kw)
        self.conv_5 = Conv1d(num_hiddens, num_hiddens, 3, padding=1, **kw)
        self.residual_stack = ResidualStack(num_hiddens, num_hiddens,
                                            num_residual_layers,
                                            num_residual_hiddens, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.relu(self.conv_1(x))
        x = F.relu(self.conv_2(x1)) + x1
        x3 = F.relu(self.conv_3(x))
        x4 = F.relu(self.conv_4(x3)) + x3
        x5 = F.relu(self.conv_5(x4)) + x4
        return self.residual_stack(x5) + x5
