"""ClariNet Gaussian WaveNet (mean + log_std output): the batch core.

Counterpart of ``vqvae_speech_tpu/models/clarinet/wavenet.py:28-141``
(reference src/clarinet/wavenet.py:30-127): front causal conv (kernel 32) +
num_blocks x num_layers gated resblocks with dilation ``kernel_size**n`` +
ReLU/1x1 head with out_channels=2 (mean, log_std), and LC upsampling (16x16
= hop 256). Parameters are the tensor trees of
``convert.load_gaussian_wavenet_params``. The teacher's autoregressive
``gaussian_wavenet_generate`` is not ported yet.
"""
from dataclasses import dataclass
from typing import Sequence

import torch

from vqvae_speech_tpu_torch.models.clarinet.modules import (
    conv_apply,
    resblock_apply,
    upsample_apply,
)
from vqvae_speech_tpu_torch.ops.fused_resblock import fused_block_chain_tiled


@dataclass(frozen=True)
class GaussianWaveNetConfig:
    out_channels: int = 2
    num_blocks: int = 4
    num_layers: int = 6
    front_channels: int = 32       # front conv kernel size (reference :47)
    residual_channels: int = 128
    gate_channels: int = 256
    skip_channels: int = 128
    kernel_size: int = 3
    cin_channels: int = 80
    upsample_scales: Sequence[int] = (16, 16)
    causal: bool = True

    def dilation(self, i):
        return self.kernel_size ** (i % self.num_layers)

    @property
    def total_layers(self):
        return self.num_blocks * self.num_layers

    def receptive_field_size(self):
        dil = [self.dilation(i) for i in range(self.total_layers)]
        return (self.kernel_size - 1) * sum(dil) + self.front_channels


def gaussian_wavenet_upsample(params, c, cfg: GaussianWaveNetConfig):
    return upsample_apply(params["upsample_conv"], c, cfg.upsample_scales)


def _head(params, skip):
    out = torch.relu(skip)
    out = torch.relu(conv_apply(params["final_conv_1"], out, 1))
    return conv_apply(params["final_conv_2"], out, 1)


def gaussian_wavenet_core(params, cfg: GaussianWaveNetConfig, x, c_up):
    """x: (B, T, 1) waveform; c_up: (B, T, cin) upsampled conditioning."""
    h = torch.relu(conv_apply(params["front_conv"], x, cfg.front_channels,
                              causal=cfg.causal))
    skip = 0.0
    for i, p in enumerate(params["res_blocks"]):
        h, s = resblock_apply(p, h, c_up, cfg.kernel_size, cfg.dilation(i),
                              cfg.causal)
        skip = skip + s
    return _head(params, skip)


def gaussian_wavenet_core_fused(params, cfg: GaussianWaveNetConfig, x, c_up):
    """Batch-1 core with every ``num_layers``-deep resblock chain run by
    ``ops.fused_resblock.fused_block_chain_tiled``: on a CUDA tensor one
    call of the hand-written chain kernel per chain, over
    ``params["chains"]`` (the weights stacked once, at load). The front
    conv and the two head 1x1s stay plain PyTorch. The chains' skip sums
    are f32 at any dtype and are summed in f32, then cast to x's dtype
    before the head, as in the JAX package (at bf16 the plain core sums
    skip in bf16)."""
    if x.shape[0] != 1:
        raise ValueError("fused core is the batch-1 (single-stream) path; "
                         f"got batch {x.shape[0]}")
    if not cfg.causal:
        raise ValueError("fused core implements the causal chain only")
    h = torch.relu(conv_apply(params["front_conv"], x, cfg.front_channels,
                              causal=cfg.causal))[0].contiguous()
    T = h.shape[0]
    c = c_up[0, :T].contiguous()
    skip = None
    for stacked in params["chains"]:
        h, s = fused_block_chain_tiled(h, c, stacked, layers=cfg.num_layers,
                                       kernel_size=cfg.kernel_size)
        skip = s if skip is None else skip + s
    return _head(params, skip[None].to(x.dtype))
