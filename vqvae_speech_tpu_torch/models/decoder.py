"""Deconvolutional decoder (upsample x2 back to feature rate).

Counterpart of ``vqvae_speech_tpu/models/decoder.py``: optional training-time
jitter, optional 40-channel speaker conditioning concatenated after it, conv
k3/p1, nearest x2 upsample, tied residual stack, then convT k3/p1 -> convT
k3/p0 -> convT k2/p0. Time lengths: T -> 2T -> 2T -> 2T+2 -> 2T+3.
"""
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_speech_tpu_torch.models.global_conditioning import GlobalConditioning
from vqvae_speech_tpu_torch.nn import (
    Conv1d,
    ConvTranspose1d,
    ResidualStack,
    jitter,
    upsample_nearest,
)

GIN_CHANNELS = 40  # the reference hardcodes 40


class DeconvolutionalDecoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_hiddens: int,
                 num_residual_layers: int, num_residual_hiddens: int,
                 use_weight_norm: bool = False,
                 use_speaker_conditioning: bool = False,
                 use_jitter: bool = False,
                 generator: Optional[torch.Generator] = None,
                 num_speakers: int = 0, jitter_probability: float = 0.12):
        super().__init__()
        kw = dict(use_weight_norm=use_weight_norm, generator=generator)
        self.use_jitter = use_jitter
        self.jitter_probability = jitter_probability
        in_ch = in_channels + (GIN_CHANNELS if use_speaker_conditioning else 0)
        self.conv_1 = Conv1d(in_ch, num_hiddens, 3, padding=1, **kw)
        self.residual_stack = ResidualStack(num_hiddens, num_hiddens,
                                            num_residual_layers,
                                            num_residual_hiddens, **kw)
        self.conv_trans_1 = ConvTranspose1d(num_hiddens, num_hiddens, 3,
                                            padding=1, **kw)
        self.conv_trans_2 = ConvTranspose1d(num_hiddens, num_hiddens, 3,
                                            padding=0, **kw)
        self.conv_trans_3 = ConvTranspose1d(num_hiddens, out_channels, 2,
                                            padding=0, **kw)
        self.speaker_embedding = (
            GlobalConditioning(num_speakers, GIN_CHANNELS, generator=generator)
            if use_speaker_conditioning else None)

    def forward(self, x_bct: torch.Tensor, speaker_ids=None, *,
                jitter_masks=None,
                jitter_generator: Optional[torch.Generator] = None,
                jitter_detach: bool = True) -> torch.Tensor:
        """(B, in_channels, T) -> (B, out_channels, 2T+3).

        In training with ``use_jitter`` the latents are jittered first, with
        ``jitter_masks`` = (replace, direction) when given and draws from
        ``jitter_generator`` otherwise. ``jitter_detach`` is the reference's
        gradient semantics (PARITY #34); False is the live gather."""
        x = x_bct
        if self.use_jitter and self.training:
            replace, direction = jitter_masks or (None, None)
            x = jitter(x, self.jitter_probability,
                       detach_replacements=jitter_detach, replace=replace,
                       direction=direction, generator=jitter_generator)
        if self.speaker_embedding is not None:
            if speaker_ids is None:
                raise ValueError("a speaker-conditioned decoder needs "
                                 "speaker_ids")
            x = torch.cat([x, self.speaker_embedding(speaker_ids, x.shape[2])],
                          dim=1)
        x = upsample_nearest(self.conv_1(x), 2)
        x = self.residual_stack(x)
        x = F.relu(self.conv_trans_1(x))
        x = F.relu(self.conv_trans_2(x))
        return self.conv_trans_3(x)
