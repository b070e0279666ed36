"""ClariNet building blocks: causal/SAME convs, gated ResBlock, LC upsampling.

Counterpart of ``vqvae_speech_tpu/models/clarinet/modules.py`` (reference
src/clarinet/modules.py:34-98), as plain functions on tensors. Activations
keep the JAX package's channels-last (B, T, C) layout at every function.
A conv's parameters are ``{"w": (Cout, Cin, K), "b": (Cout,)}`` with weight
norm already resolved (``convert.py`` does that once, at load); an
upsampling stage's are ``{"w": (1, 1, 3, 2s), "b": (1,)}``.

* conv: causal mode pads left ``d*(k-1)``; SAME mode pads ``d*(k-1)//2`` on
  both sides,
* resblock: filter/gate dilated convs + 1x1 conditioning projections,
  tanh*sigmoid, res/skip 1x1s, ``(x+res)*sqrt(0.5)``,
* upsampling: ConvTranspose2d(1, 1, (3, 2s), stride (1, s), padding
  (1, s//2)) + LeakyReLU(0.4) per scale (reference src/clarinet/wavenet.py:
  69-76). The JAX package computes even scales as a subpixel correlation
  with the kernel flipped along frequency; a transposed conv needs no flip.
  An odd scale gives ``T*s + 1`` rows, as there.
"""
import math

import torch
import torch.nn.functional as F

_SQRT_HALF = math.sqrt(0.5)


def conv_apply(p, x, kernel_size, dilation=1, causal=True, mode="SAME"):
    """x: (B, T, Cin) -> (B, T', Cout)."""
    if kernel_size == 1:
        return F.linear(x, p["w"][:, :, 0], p["b"])
    if causal and mode == "SAME":
        pad = (dilation * (kernel_size - 1), 0)
    elif mode == "SAME":
        h = dilation * (kernel_size - 1) // 2
        pad = (h, h)
    else:
        pad = (0, 0)
    y = F.conv1d(F.pad(x.transpose(1, 2), pad), p["w"], p["b"],
                 dilation=dilation)
    return y.transpose(1, 2)


def resblock_apply(p, x, c, kernel_size, dilation, causal=True):
    """-> ((x + res) * sqrt(1/2) (B, T, C), skip (B, T, S))."""
    h_f = conv_apply(p["filter_conv"], x, kernel_size, dilation, causal)
    h_g = conv_apply(p["gate_conv"], x, kernel_size, dilation, causal)
    if c is not None:
        h_f = h_f + conv_apply(p["filter_conv_c"], c, 1)
        h_g = h_g + conv_apply(p["gate_conv_c"], c, 1)
    out = torch.tanh(h_f) * torch.sigmoid(h_g)
    res = conv_apply(p["res_conv"], out, 1)
    skip = conv_apply(p["skip_conv"], out, 1)
    return (x + res) * _SQRT_HALF, skip


def upsample_apply(params, c, upsample_scales, negative_slope=0.4):
    """c: (B, T, C) -> (B, T*prod(scales), C) for even scales (the channels
    are the image's frequency axis)."""
    x = c.transpose(1, 2)[:, None]                        # (B, 1, F=C, W=T)
    for p, s in zip(params, upsample_scales):
        x = F.leaky_relu(
            F.conv_transpose2d(x, p["w"], p["b"], stride=(1, s),
                               padding=(1, s // 2)), negative_slope)
    return x[:, 0].transpose(1, 2)
