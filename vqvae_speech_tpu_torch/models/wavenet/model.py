"""WaveNet vocoder with local and global conditioning: the batch forward.

Counterpart of ``vqvae_speech_tpu/models/wavenet/model.py`` (reference
src/wavenet_vocoder/wavenet.py:87-264, modules.py:87-217):

* first 1x1 conv -> ``layers`` gated residual blocks with dilation
  ``2**(layer % layers_per_stack)`` -> skip sum (legacy sqrt(1/2) scaling
  after the first layer) -> ReLU -> 1x1 -> ReLU -> 1x1,
* gated unit: causal dilated conv (LEFT padding ``(k-1)*d``) + the local and
  global conditioning 1x1 projections -> tanh(a)*sigmoid(b) -> skip and
  residual 1x1s, ``(x + res) * sqrt(1/2)``,
* speaker embedding table for global conditioning,
* single-channel ConvTranspose2d (freq_kernel x scale, stride (1, scale))
  + ReLU stages upsampling the local conditioning to the sample rate.

Every conv carries the weight-norm pair ``{v, g}`` and a bias, as the JAX
package's ``_conv_init`` makes them. Activations are (B, C, T) inside;
``forward``, ``upsample_lc`` and ``expand_global`` keep the JAX (B, T, C)
layout at their edges.

In training mode the forward applies dropout (``cfg.dropout``) to each
residual layer's input, ``where(mask, x / keep, 0)`` with ``keep = 1 -
dropout``, as ``_residual_glu_apply`` does; the masks are fed
(``dropout_masks``, one a layer, so that a test can hand over the JAX
package's draws) or drawn from ``dropout_generator``; with neither, as
with JAX's ``rng=None``, nothing is dropped. The module runs in the dtype of
its parameters and inputs: below f32 (the bf16 decoder of WaveNet-VQ-VAE
training) Python constants are rounded to that dtype before they multiply
and the sigmoid is ``1/(1+exp(-x))``, as JAX rounds them.
"""
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_speech_tpu_torch.models.clarinet.modules import scaled, sigmoid
from vqvae_speech_tpu_torch.nn import Conv1d
from vqvae_speech_tpu_torch.nn.conv import with_bias

_SQRT_HALF = math.sqrt(0.5)


@dataclass(frozen=True)
class WaveNetConfig:
    out_channels: int = 256
    layers: int = 20
    stacks: int = 2
    residual_channels: int = 512
    gate_channels: int = 512
    skip_out_channels: int = 512
    kernel_size: int = 3
    dropout: float = 1 - 0.95
    cin_channels: int = -1
    gin_channels: int = -1
    n_speakers: Optional[int] = None
    upsample_conditional_features: bool = False
    upsample_scales: Optional[Sequence[int]] = None
    freq_axis_kernel_size: int = 3
    scalar_input: bool = False
    use_speaker_embedding: bool = True
    legacy: bool = True

    @property
    def layers_per_stack(self):
        assert self.layers % self.stacks == 0
        return self.layers // self.stacks

    def dilation(self, layer):
        return 2 ** (layer % self.layers_per_stack)


def receptive_field_size(total_layers, num_cycles, kernel_size,
                         dilation=lambda x: 2**x):
    """Receptive field in samples (reference wavenet.py:66-84)."""
    assert total_layers % num_cycles == 0
    layers_per_cycle = total_layers // num_cycles
    dilations = [dilation(i % layers_per_cycle) for i in range(total_layers)]
    return (kernel_size - 1) * sum(dilations) + 1


class ResidualConv1dGLU(nn.Module):
    """One gated residual block: (B, C, T) -> ((B, C, T), skip (B, S, T))."""

    def __init__(self, cfg: WaveNetConfig, dilation: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(use_weight_norm=True, generator=generator)
        gate_out = cfg.gate_channels // 2
        self.pad = (cfg.kernel_size - 1) * dilation
        self.keep = 1.0 - cfg.dropout
        self.conv = Conv1d(cfg.residual_channels, cfg.gate_channels,
                           cfg.kernel_size, dilation=dilation, **kw)
        self.conv1x1c = (Conv1d(cfg.cin_channels, cfg.gate_channels, 1, **kw)
                         if cfg.cin_channels > 0 else None)
        self.conv1x1g = (Conv1d(cfg.gin_channels, cfg.gate_channels, 1, **kw)
                         if cfg.gin_channels > 0 else None)
        self.conv1x1_skip = Conv1d(gate_out, cfg.skip_out_channels, 1, **kw)
        self.conv1x1_out = Conv1d(gate_out, cfg.residual_channels, 1, **kw)

    def forward(self, x, c=None, g=None, keep_mask=None):
        """c: (B, cin, T) or None; g: (B, gin, 1) or None; keep_mask:
        (B, C, T) bool, the dropout's kept elements, or None."""
        residual = x
        if keep_mask is not None:
            x = torch.where(keep_mask,
                            x / torch.tensor(self.keep, dtype=x.dtype), 0.0)
        x = self.conv(F.pad(x, (self.pad, 0)))
        if c is not None:
            x = x + self.conv1x1c(c)
        if g is not None:
            x = x + self.conv1x1g(g)
        a, b = x.chunk(2, dim=1)
        h = torch.tanh(a) * sigmoid(b)
        return (scaled(self.conv1x1_out(h) + residual, _SQRT_HALF),
                self.conv1x1_skip(h))


class UpsampleStage(nn.Module):
    """ConvTranspose2d(1, 1, (kh, s), stride (1, s), padding (pad, 0)) + ReLU
    on a (B, 1, F, W) image, with weight norm taken over the WHOLE kernel
    (``v`` (1, 1, kh, s), ``g`` (1,)): the reference's per-tensor norm
    (``model.py:141-143``), unlike ``nn.conv.conv_weight``'s per-channel one.
    The weight is filled with 1/kh and the bias zeroed: the reference's
    averaging init (PARITY #36)."""

    def __init__(self, freq_kernel: int, scale: int, freq_pad: int):
        super().__init__()
        v = torch.full((1, 1, freq_kernel, scale), 1.0 / freq_kernel)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(v.square().sum().sqrt().reshape(1))
        self.b = nn.Parameter(torch.zeros(1))
        self.scale, self.freq_pad = scale, freq_pad

    def weight(self) -> torch.Tensor:
        return self.g * self.v / self.v.square().sum().sqrt()

    def forward(self, x):
        # a transposed conv needs no kernel flip; the JAX package's subpixel
        # correlation flips along frequency to compute the same thing
        return F.relu(with_bias(F.conv_transpose2d, x, self.weight(), self.b,
                                stride=(1, self.scale),
                                padding=(self.freq_pad, 0)))


class WaveNet(nn.Module):
    def __init__(self, cfg: WaveNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(use_weight_norm=True, generator=generator)
        in_ch = 1 if cfg.scalar_input else cfg.out_channels
        self.first_conv = Conv1d(in_ch, cfg.residual_channels, 1, **kw)
        self.conv_layers = nn.ModuleList(
            ResidualConv1dGLU(cfg, cfg.dilation(layer), generator)
            for layer in range(cfg.layers))
        self.last_conv_1 = Conv1d(cfg.skip_out_channels,
                                  cfg.skip_out_channels, 1, **kw)
        self.last_conv_2 = Conv1d(cfg.skip_out_channels, cfg.out_channels, 1,
                                  **kw)
        self.embed_speakers = None
        if cfg.gin_channels > 0 and cfg.use_speaker_embedding:
            assert cfg.n_speakers is not None
            self.embed_speakers = nn.Parameter(0.1 * torch.randn(
                cfg.n_speakers, cfg.gin_channels, generator=generator))
        self.upsample_conv = None
        if cfg.upsample_conditional_features:
            self.upsample_conv = nn.ModuleList(
                UpsampleStage(cfg.freq_axis_kernel_size, s,
                              (cfg.freq_axis_kernel_size - 1) // 2)
                for s in cfg.upsample_scales)

    @property
    def upsample_factor(self) -> int:
        return math.prod(self.cfg.upsample_scales) \
            if self.cfg.upsample_conditional_features else 1

    def upsample_lc(self, c: torch.Tensor) -> torch.Tensor:
        """(B, Tc, cin) -> (B, Tc * prod(scales), cin)
        (``_upsample_lc``: the channels are the image's frequency axis)."""
        x = c.transpose(1, 2)[:, None]                   # (B, 1, cin, Tc)
        for stage in self.upsample_conv:
            x = stage(x)
        return x[:, 0].transpose(1, 2)

    def expand_global(self, g: Optional[torch.Tensor], B: int):
        """Speaker ids (B,) or features (B, 1, gin) -> (B, gin, 1), or None
        (``_expand_global`` before its broadcast over time)."""
        if g is None:
            return None
        if self.embed_speakers is not None and g.dim() <= 2:
            return self.embed_speakers[g.reshape(B).long()][:, :, None]
        return g.reshape(B, 1, -1).transpose(1, 2)

    def dropout_masks(self, shape, generator: torch.Generator,
                      device=None) -> list:
        """One keep mask a layer, (B, T, C) bool in the JAX layout, each
        element kept with probability ``1 - cfg.dropout``, drawn from
        ``generator`` (on ``device``, which must be the generator's)."""
        keep = 1.0 - self.cfg.dropout
        return [torch.rand(shape, generator=generator, device=device) < keep
                for _ in range(self.cfg.layers)]

    def forward(self, x, c=None, g=None, softmax: bool = False, *,
                dropout_masks=None,
                dropout_generator: Optional[torch.Generator] = None):
        """x: (B, T, in) one-hot audio; c: (B, Tc, cin) local conditioning
        (upsampled and trimmed to T here if configured); g: (B,) speaker ids
        or (B, 1, gin) features. Returns (B, T, out_channels)
        (``wavenet_apply``).

        In training mode with ``cfg.dropout > 0``, ``dropout_masks`` (one
        (B, T, residual_channels) bool tensor a layer, True = kept) or
        draws from ``dropout_generator`` drop each layer's input."""
        B, T = x.shape[0], x.shape[1]
        masks = [None] * self.cfg.layers
        if self.training and self.cfg.dropout > 0:
            if dropout_masks is None and dropout_generator is not None:
                dropout_masks = self.dropout_masks(
                    (B, T, self.cfg.residual_channels), dropout_generator,
                    dropout_generator.device)
            if dropout_masks is not None:
                if len(dropout_masks) != self.cfg.layers:
                    raise ValueError(f"{len(dropout_masks)} dropout masks "
                                     f"for {self.cfg.layers} layers")
                masks = [m.to(x.device, torch.bool).transpose(1, 2)
                         for m in dropout_masks]
        g_b = self.expand_global(g, B)
        if c is not None and self.cfg.upsample_conditional_features:
            c = self.upsample_lc(c)
            if c.shape[1] < T:
                raise ValueError(f"conditioning of {c.shape[1]} samples is "
                                 f"shorter than the input's {T}")
            c = c[:, :T]
        c_bct = None if c is None else c.transpose(1, 2)
        h = self.first_conv(x.transpose(1, 2))
        skips = None
        for layer, mask in zip(self.conv_layers, masks):
            h, s = layer(h, c_bct, g_b, mask)
            if skips is None:
                skips = s
            else:
                skips = skips + s
                if self.cfg.legacy:
                    skips = scaled(skips, _SQRT_HALF)
        out = F.relu(skips)
        out = F.relu(self.last_conv_1(out))
        out = self.last_conv_2(out).transpose(1, 2)
        return torch.softmax(out, dim=-1) if softmax else out
