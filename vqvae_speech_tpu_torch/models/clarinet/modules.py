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

from vqvae_speech_tpu_torch.ops._kernels import PreparedFusedChain
from vqvae_speech_tpu_torch.ops.fused_resblock import stack_block_weights

_SQRT_HALF = math.sqrt(0.5)
# the vocoders' compute dtypes: None and f32 both mean f32
COMPUTE_DTYPES = (None, torch.float32, torch.bfloat16)


def check_compute_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r}: takes None, "
                         "torch.float32 or torch.bfloat16")


def scaled(x, factor):
    """x * factor with the Python constant in x's dtype first, as JAX's
    weak types round it (at f32 the product torch takes anyway)."""
    return x * torch.tensor(factor, dtype=x.dtype)


class _ExpandedSigmoid(torch.autograd.Function):
    """``1 / (1 + exp(-x))`` op by op, with the logistic's own derivative
    ``g * (y * (1 - y))`` (JAX's rule for ``lax.logistic``): autograd
    through the expansion would give 0 * inf = NaN where exp(-x)
    overflows."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x):
    """torch.sigmoid at f32; at bf16 XLA's expansion, step by step (and its
    gradient the logistic's)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return _ExpandedSigmoid.apply(x)


def conv_apply(p, x, kernel_size, dilation=1, causal=True, mode="SAME"):
    """x: (B, T, Cin) -> (B, T', Cout). At f32 the bias is fused into the
    product; at bf16 it is added after the product's rounding, as JAX adds
    it (fusing it moves 30% of a bf16 conv's outputs by an ulp)."""
    fused = x.dtype == torch.float32
    b = p["b"] if fused else None
    if kernel_size == 1:
        y = F.linear(x, p["w"][:, :, 0], b)
        return y if fused else y + p["b"]
    if causal and mode == "SAME":
        pad = (dilation * (kernel_size - 1), 0)
    elif mode == "SAME":
        h = dilation * (kernel_size - 1) // 2
        pad = (h, h)
    else:
        pad = (0, 0)
    y = F.conv1d(F.pad(x.transpose(1, 2), pad), p["w"], b,
                 dilation=dilation).transpose(1, 2)
    return y if fused else y + p["b"]


def resblock_apply(p, x, c, kernel_size, dilation, causal=True):
    """-> ((x + res) * sqrt(1/2) (B, T, C), skip (B, T, S))."""
    h_f = conv_apply(p["filter_conv"], x, kernel_size, dilation, causal)
    h_g = conv_apply(p["gate_conv"], x, kernel_size, dilation, causal)
    if c is not None:
        h_f = h_f + conv_apply(p["filter_conv_c"], c, 1)
        h_g = h_g + conv_apply(p["gate_conv_c"], c, 1)
    out = torch.tanh(h_f) * sigmoid(h_g)
    res = conv_apply(p["res_conv"], out, 1)
    skip = conv_apply(p["skip_conv"], out, 1)
    return scaled(x + res, _SQRT_HALF), skip


def upsample_apply(params, c, upsample_scales, negative_slope=0.4):
    """c: (B, T, C) -> (B, T*prod(scales), C) for even scales (the channels
    are the image's frequency axis)."""
    x = c.transpose(1, 2)[:, None]                        # (B, 1, F=C, W=T)
    for p, s in zip(params, upsample_scales):
        if x.dtype == torch.float32:
            x = F.leaky_relu(
                F.conv_transpose2d(x, p["w"], p["b"], stride=(1, s),
                                   padding=(1, s // 2)), negative_slope)
        else:
            x = F.conv_transpose2d(x, p["w"], stride=(1, s),
                                   padding=(1, s // 2)) + p["b"]
            x = torch.where(x >= 0, x, scaled(x, negative_slope))
    return x[:, 0].transpose(1, 2)


def _chain_dtype(chain):
    return (chain.dtype if isinstance(chain, PreparedFusedChain)
            else chain["wf"].dtype)


def cast_params(tree, dtype):
    """A vocoder's parameter tree (``convert.load_*_params``) in ``dtype``,
    as JAX's ``tree_map(lambda p: p.astype(dtype), params)``: every tensor
    cast, and each ``"chains"`` list (biases f32 by design) stacked again
    from the cast ``"res_blocks"`` unless it is in ``dtype`` already. A tree
    loaded in ``dtype`` comes back with the same tensors. Casting resolved
    f32 weights is not JAX's order, which casts before it resolves the
    weight norm: load the tree in ``dtype`` (``compute_dtype=``) to get
    JAX's weights."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.dtype == dtype else tree.to(dtype)
    if isinstance(tree, list):
        return [cast_params(t, dtype) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: cast_params(v, dtype) for k, v in tree.items() if k != "chains"}
    if "chains" in tree:
        chains = tree["chains"]
        if any(_chain_dtype(c) != dtype for c in chains):
            blocks = out["res_blocks"]
            per = len(blocks) // len(chains)
            chains = [stack_block_weights(blocks[at:at + per], dtype)
                      for at in range(0, len(blocks), per)]
        out["chains"] = chains
    return out
