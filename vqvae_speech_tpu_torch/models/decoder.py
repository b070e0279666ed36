"""Deconvolutional decoder (upsample x2 back to feature rate), eval forward.

Counterpart of ``vqvae_speech_tpu/models/decoder.py``: conv k3/p1, nearest x2
upsample, tied residual stack, then convT k3/p1 -> convT k3/p0 -> convT k2/p0.
Time lengths: T -> 2T -> 2T -> 2T+2 -> 2T+3. Speaker conditioning and
training-time jitter are not ported yet and raise NotImplementedError.
"""
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_speech_tpu_torch.nn import (
    Conv1d,
    ConvTranspose1d,
    ResidualStack,
    upsample_nearest,
)


class DeconvolutionalDecoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_hiddens: int,
                 num_residual_layers: int, num_residual_hiddens: int,
                 use_weight_norm: bool = False,
                 use_speaker_conditioning: bool = False,
                 use_jitter: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_speaker_conditioning:
            raise NotImplementedError(
                "speaker conditioning is not ported to the PyTorch decoder yet")
        kw = dict(use_weight_norm=use_weight_norm, generator=generator)
        self.use_jitter = use_jitter
        self.conv_1 = Conv1d(in_channels, num_hiddens, 3, padding=1, **kw)
        self.residual_stack = ResidualStack(num_hiddens, num_hiddens,
                                            num_residual_layers,
                                            num_residual_hiddens, **kw)
        self.conv_trans_1 = ConvTranspose1d(num_hiddens, num_hiddens, 3,
                                            padding=1, **kw)
        self.conv_trans_2 = ConvTranspose1d(num_hiddens, num_hiddens, 3,
                                            padding=0, **kw)
        self.conv_trans_3 = ConvTranspose1d(num_hiddens, out_channels, 2,
                                            padding=0, **kw)

    def forward(self, x_bct: torch.Tensor) -> torch.Tensor:
        """(B, in_channels, T) -> (B, out_channels, 2T+3)."""
        if self.use_jitter and self.training:
            raise NotImplementedError(
                "training-time jitter is not ported to PyTorch yet")
        x = upsample_nearest(self.conv_1(x_bct), 2)
        x = self.residual_stack(x)
        x = F.relu(self.conv_trans_1(x))
        x = F.relu(self.conv_trans_2(x))
        return self.conv_trans_3(x)
