"""Fused gated-resblock chains for batch-1 one-pass vocoder synthesis.

Counterpart of ``vqvae_speech_tpu/ops/fused_resblock.py``. A chain is L
gated resblocks (``models/clarinet/modules.py::resblock_apply``) over one
stream in channels-last layout:

  x     (T, C)     chain input           c_up (T, cin)  conditioning
  wf, wg   (L, k, C, G)   dilated filter / gate conv taps
  wfc, wgc (L, cin, G)    conditioning 1x1 projections
  wres (L, G, C), wskip (L, G, S)
  bf, bg (L, G) with the conditioning convs' biases folded in,
  bres (L, C), bskip (L, S)

Per layer l and row t:
  hf/hg = c[t] @ wfc/wgc[l] + bf/bg[l] + sum_j x[t + off(j, l)] @ wf/wg[l, j]
  out   = tanh(hf) * sigmoid(hg)
  skip[t] += out @ wskip[l] + bskip[l]
  x[t]  = (x[t] + out @ wres[l] + bres[l]) * sqrt(1/2)
Causal: ``off = -(k-1-j) * d_l``; non-causal: ``off = (j - (k-1)//2) * d_l``;
rows outside [0, T) read as zero at every layer. Returns (x (T, C),
skip (T, S)).

Three entry points, as in the JAX package, each beside its plain PyTorch
version: ``fused_block_chain`` (causal, d = k**l; the whole-T prototype),
``fused_block_chain_tiled`` (the same chain, the form the student serves
with) and ``fused_block_chain_nc`` (non-causal, any dilations; the
FloWaveNet couplings). Each dispatches on the device of ``x``: a CUDA
tensor always goes to the hand-written kernel ``csrc/fused_resblock.cu``, a
CPU tensor to the plain chain. There is no threshold and no fallback. The
JAX functions' ``tile`` and ``interpret`` arguments size and emulate the TPU
kernel and have no counterpart: no result here depends on a tiling.
"""
import math

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.ops._kernels import (
    fused_block_chain_cuda,
    fused_block_chain_nc_cuda,
    fused_block_chain_tiled_cuda,
)

_SQRT_HALF = math.sqrt(0.5)


def stack_block_weights(block_params):
    """Stack one chain's resblock parameters (a list of L trees with
    resolved ``{"w": (Cout, Cin, K), "b"}`` convs) into the dense arrays
    above."""
    def taps(name):                                       # (L, k, Cin, Cout)
        return torch.stack([p[name]["w"].permute(2, 1, 0)
                            for p in block_params]).contiguous()

    def bias(*names):
        return torch.stack([sum(p[n]["b"] for n in names)
                            for p in block_params]).contiguous()

    return dict(
        wf=taps("filter_conv"), wg=taps("gate_conv"),
        wfc=taps("filter_conv_c")[:, 0].contiguous(),
        wgc=taps("gate_conv_c")[:, 0].contiguous(),
        wres=taps("res_conv")[:, 0].contiguous(),
        wskip=taps("skip_conv")[:, 0].contiguous(),
        bf=bias("filter_conv", "filter_conv_c"),
        bg=bias("gate_conv", "gate_conv_c"),
        bres=bias("res_conv"), bskip=bias("skip_conv"))


def _causal_offsets(kernel_size, dilations):
    """Per layer, the row offset of each tap of a causal dilated conv."""
    return [[-(kernel_size - 1 - j) * d for j in range(kernel_size)]
            for d in dilations]


def _centred_offsets(kernel_size, dilations):
    """Per layer, the row offset of each tap of a SAME-padded conv."""
    return [[(j - (kernel_size - 1) // 2) * d for j in range(kernel_size)]
            for d in dilations]


def _power_dilations(layers, kernel_size):
    return tuple(kernel_size ** i for i in range(layers))


def _shifted(x, off):
    """Rows x[t + off], zero where t + off falls outside [0, T)."""
    if off == 0:
        return x
    if abs(off) >= x.shape[0]:
        return torch.zeros_like(x)
    return F.pad(x, (0, 0, -off, off))


def _chain_torch(x, c_up, stacked, offsets):
    skip = x.new_zeros((x.shape[0], stacked["wskip"].shape[-1]))
    for l, offs in enumerate(offsets):
        hf = c_up @ stacked["wfc"][l] + stacked["bf"][l]
        hg = c_up @ stacked["wgc"][l] + stacked["bg"][l]
        for j, off in enumerate(offs):
            xs = _shifted(x, off)
            hf = hf + xs @ stacked["wf"][l, j]
            hg = hg + xs @ stacked["wg"][l, j]
        out = torch.tanh(hf) * torch.sigmoid(hg)
        skip = skip + (out @ stacked["wskip"][l] + stacked["bskip"][l])
        x = (x + out @ stacked["wres"][l] + stacked["bres"][l]) * _SQRT_HALF
    return x, skip


def _check_layers(stacked, layers, kernel_size):
    L, k = stacked["wf"].shape[:2]
    if (L, k) != (layers, kernel_size):
        raise ValueError(f"stacked weights hold {L} layers of kernel {k}, "
                         f"not layers={layers}, kernel_size={kernel_size}")


def _nc_dilations(layers, kernel_size, dilations):
    if dilations is None:
        return _power_dilations(layers, kernel_size)
    if len(dilations) != layers:
        raise ValueError(f"{len(dilations)} dilations for {layers} layers")
    return tuple(int(d) for d in dilations)


def fused_block_chain_torch(x, c_up, stacked, layers=6, kernel_size=3):
    """The plain PyTorch causal chain with d = kernel_size**l."""
    _check_layers(stacked, layers, kernel_size)
    return _chain_torch(x, c_up, stacked, _causal_offsets(
        kernel_size, _power_dilations(layers, kernel_size)))


def fused_block_chain_tiled_torch(x, c_up, stacked, layers=6, kernel_size=3):
    """The plain version of ``fused_block_chain_tiled``: the tiled TPU
    kernel computes exactly the whole-T causal chain, so this is it."""
    return fused_block_chain_torch(x, c_up, stacked, layers, kernel_size)


def fused_block_chain_nc_torch(x, c_up, stacked, layers=2, kernel_size=3,
                               dilations=None):
    """The plain PyTorch non-causal chain (per-layer zero padding of the
    symmetric convs); ``dilations`` defaults to kernel_size**l."""
    _check_layers(stacked, layers, kernel_size)
    return _chain_torch(x, c_up, stacked, _centred_offsets(
        kernel_size, _nc_dilations(layers, kernel_size, dilations)))


def _on_cpu(name, x):
    if x.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {x.device}")


def fused_block_chain(x, c_up, stacked, layers=6, kernel_size=3):
    """One causal L-layer chain over the whole T. x: (T, C); c_up:
    (T, cin); stacked: stack_block_weights()."""
    if x.is_cuda:
        _check_layers(stacked, layers, kernel_size)
        return fused_block_chain_cuda(x, c_up, stacked)
    _on_cpu("fused_block_chain", x)
    return fused_block_chain_torch(x, c_up, stacked, layers, kernel_size)


def fused_block_chain_tiled(x, c_up, stacked, layers=6, kernel_size=3):
    """The causal chain in the form the IAF student serves with."""
    if x.is_cuda:
        _check_layers(stacked, layers, kernel_size)
        return fused_block_chain_tiled_cuda(x, c_up, stacked)
    _on_cpu("fused_block_chain_tiled", x)
    return fused_block_chain_tiled_torch(x, c_up, stacked, layers,
                                         kernel_size)


def fused_block_chain_nc(x, c_up, stacked, layers=2, kernel_size=3,
                         dilations=None):
    """The non-causal chain (FloWaveNet coupling nets pass
    ``2**(i % layers)`` as ``dilations``)."""
    if x.is_cuda:
        _check_layers(stacked, layers, kernel_size)
        return fused_block_chain_nc_cuda(
            x, c_up, stacked, _nc_dilations(layers, kernel_size, dilations))
    _on_cpu("fused_block_chain_nc", x)
    return fused_block_chain_nc_torch(x, c_up, stacked, layers, kernel_size,
                                      dilations)
