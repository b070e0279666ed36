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
FloWaveNet couplings). Each dispatches on the device and the dtype of
``x``: a CUDA tensor always goes to the hand-written kernel
``csrc/fused_resblock.cu`` (its f32 or its bf16 form), a CPU tensor to the
plain chain. There is no threshold and no fallback. The JAX functions'
``tile`` and ``interpret`` arguments size and emulate the TPU kernel and
have no counterpart: no result here depends on a tiling.

Two dtypes, as the JAX kernels take them: everything f32, or x, c_up and
the weights bf16 (``stack_block_weights(..., compute_dtype=torch.bfloat16)``,
the vocoders' bf16 serving configuration) with the biases f32. At bf16 the
chain is another function: every product takes bf16 operands and sums in
f32, the gated output is rounded to bf16 before the projections, x is
rounded to bf16 after every layer and skip stays f32. Any other mix raises.

The kernel multiplies on the tensor cores in error-compensated TF32: each
f32 operand is split into ``hi = tf32(a)`` and ``lo = tf32(a - hi)`` and a
product is ``hi @ lo + lo @ hi + hi @ hi`` with f32 sums. ``split_tf32`` and
``fused_block_chain_tf32_torch`` are that arithmetic in plain PyTorch (its
twin, for tests on any device), ``prepared_chain_weights_torch`` the layout
the kernel reads its weights in, and ``prepare_block_chain`` binds a
weight set to the kernel once, for callers that run a chain many times. The
bf16 kernel takes ONE bf16 product a product (the products of bf16 values
are exact in f32), on weights in the same layout without the split.
``fused_block_chain_bf16_torch`` is the plain bf16 chain with its sums in
f32 or correctly rounded, the yardstick the bf16 kernel is held to.
"""
import math

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.ops._kernels import (
    PreparedFusedChain,
    fused_block_chain_bf16_cuda,
    fused_block_chain_cuda,
    fused_block_chain_nc_bf16_cuda,
    fused_block_chain_nc_cuda,
    fused_block_chain_tiled_bf16_cuda,
    fused_block_chain_tiled_cuda,
)

_SQRT_HALF = math.sqrt(0.5)


def stack_block_weights(block_params, compute_dtype=None):
    """Stack one chain's resblock parameters (a list of L trees with
    resolved ``{"w": (Cout, Cin, K), "b"}`` convs) into the dense arrays
    above: the weights in ``compute_dtype`` (None: as given), the biases f32,
    each pair of conv biases summed in ``compute_dtype`` first (JAX sums the
    parameters it was given, which its bf16 models cast before stacking)."""
    def cast(t):
        return t if compute_dtype is None else t.to(compute_dtype)

    def taps(name):                                       # (L, k, Cin, Cout)
        return cast(torch.stack([p[name]["w"].permute(2, 1, 0)
                                 for p in block_params])).contiguous()

    def bias(*names):
        return torch.stack([sum(cast(p[n]["b"]) for n in names)
                            for p in block_params]).float().contiguous()

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


def _chain_torch(x, c_up, stacked, offsets, mm=torch.matmul):
    """The chain with every product taken by ``mm``."""
    skip = x.new_zeros((x.shape[0], stacked["wskip"].shape[-1]))
    for l, offs in enumerate(offsets):
        hf = mm(c_up, stacked["wfc"][l]) + stacked["bf"][l]
        hg = mm(c_up, stacked["wgc"][l]) + stacked["bg"][l]
        for j, off in enumerate(offs):
            xs = _shifted(x, off)
            hf = hf + mm(xs, stacked["wf"][l, j])
            hg = hg + mm(xs, stacked["wg"][l, j])
        out = torch.tanh(hf) * torch.sigmoid(hg)
        skip = skip + (mm(out, stacked["wskip"][l]) + stacked["bskip"][l])
        x = (x + mm(out, stacked["wres"][l]) + stacked["bres"][l]) * _SQRT_HALF
    return x, skip


def _chain_bf16_torch(x, c_up, stacked, offsets, exact=False):
    """The bf16 chain: bf16 operands, f32 sums (``a.float() @ b.float()`` is
    exact in its products; torch's bf16 matmul would round its result), the
    gated output and x rounded to bf16, skip f32, the conditioning and bias
    summed first, then the taps, as the JAX kernels do. ``exact`` takes
    every product and sum in float64 and rounds it to f32 once, where the
    f32 sums round: the same chain with its sums correctly rounded."""
    wide = torch.float64 if exact else torch.float32

    def mm(a, b):
        return a.to(wide) @ b.to(wide)

    skip = x.new_zeros((x.shape[0], stacked["wskip"].shape[-1]), dtype=wide)
    for l, offs in enumerate(offsets):
        hf = mm(c_up, stacked["wfc"][l]) + stacked["bf"][l].to(wide)
        hg = mm(c_up, stacked["wgc"][l]) + stacked["bg"][l].to(wide)
        for j, off in enumerate(offs):
            xs = _shifted(x, off)
            hf = hf + mm(xs, stacked["wf"][l, j])
            hg = hg + mm(xs, stacked["wg"][l, j])
        out = (torch.tanh(hf.float()) * torch.sigmoid(hg.float())).to(x.dtype)
        skip = skip + (mm(out, stacked["wskip"][l])
                       + stacked["bskip"][l].to(wide))
        res = mm(out, stacked["wres"][l]) + stacked["bres"][l].to(wide)
        x = ((x.to(wide) + res) * _SQRT_HALF).float().to(x.dtype)
    return x, skip.float()


def _plain_chain(x, c_up, stacked, offsets):
    if x.dtype == torch.bfloat16:
        return _chain_bf16_torch(x, c_up, stacked, offsets)
    return _chain_torch(x, c_up, stacked, offsets)


def fused_block_chain_bf16_torch(x, c_up, stacked, layers, kernel_size,
                                 dilations=None, causal=True, exact=False):
    """The plain bf16 chain (the plain version of the bf16 kernels) with its
    sums in f32 in the JAX kernels' order, or with ``exact`` the same sums
    correctly rounded (float64). The two are legitimate orders of one bf16
    function; x is rounded to bf16 after every layer, so they disagree on
    some elements by an ulp and the flips propagate, and their distance is
    the spread the bf16 kernel is held to a multiple of. ``dilations``
    defaults to kernel_size**l."""
    _check_dtypes("fused_block_chain_bf16_torch", x, c_up, stacked)
    _check_layers(stacked, layers, kernel_size)
    offsets = (_causal_offsets if causal else _centred_offsets)(
        kernel_size, _nc_dilations(layers, kernel_size, dilations))
    return _chain_bf16_torch(x, c_up, stacked, offsets, exact)


def split_tf32(a):
    """(hi, lo) with ``hi = tf32(a)`` and ``lo = tf32(a - hi)``, both f32
    tensors whose low 13 mantissa bits are clear. The rounding is to nearest
    with ties away from zero, as the kernel's ``cvt.rna.tf32.f32``, done on
    the bit patterns: add half a TF32 unit to the magnitude and cut."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def _matmul_tf32x3(a, b):
    """a @ b as the kernel takes it: three products of TF32 values, the two
    small ones first, summed in f32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def _matmul_tf32(a, b):
    """a @ b in one TF32 product: what the split avoids."""
    return split_tf32(a)[0] @ split_tf32(b)[0]


def fused_block_chain_tf32_torch(x, c_up, stacked, layers, kernel_size,
                                 dilations=None, causal=True, passes=3):
    """The chain with the kernel's arithmetic, in plain PyTorch: every
    product in error-compensated TF32 (``passes=3``), or in one TF32
    product (``passes=1``, for measuring what the compensation buys).
    ``dilations`` defaults to kernel_size**l."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    _check_layers(stacked, layers, kernel_size)
    offsets = (_causal_offsets if causal else _centred_offsets)(
        kernel_size, _nc_dilations(layers, kernel_size, dilations))
    return _chain_torch(x, c_up, stacked, offsets,
                        _matmul_tf32x3 if passes == 3 else _matmul_tf32)


def prepared_chain_weights_torch(stacked):
    """One chain's weights as the kernel reads them, built with plain
    tensor operations: reduction index contiguous, split into TF32 parts.

      wgate (2, L, 2G, k*C8 + cin8)  rows [0, G) filter, [G, 2G) gate; along
                                     the reduction tap j's C channels at
                                     j*C8, then the conditioning's cin
      wproj (2, L, C+S, G8)          rows [0, C) wres^T, [C, C+S) wskip^T

    Index 0 is hi, 1 lo; x8 is x rounded up to 8, the padding zero. bf16
    weights keep the layout and are not split: the leading index has one
    entry, the weights as they are."""
    def pad8(w):                              # along the last axis
        return F.pad(w, (0, -w.shape[-1] % 8))

    taps = torch.cat([stacked["wf"], stacked["wg"]], dim=-1)    # (L,k,C,2G)
    cond = torch.cat([stacked["wfc"], stacked["wgc"]], dim=-1)  # (L,cin,2G)
    L, k, _, G2 = taps.shape
    gate = torch.cat([pad8(taps.permute(0, 3, 1, 2)).reshape(L, G2, -1),
                      pad8(cond.permute(0, 2, 1))], dim=-1)
    proj = pad8(torch.cat([stacked["wres"], stacked["wskip"]],
                          dim=-1).permute(0, 2, 1))
    if gate.dtype == torch.bfloat16:
        return dict(wgate=gate.contiguous()[None], wproj=proj.contiguous()[None])
    return dict(wgate=torch.stack(split_tf32(gate.contiguous())),
                wproj=torch.stack(split_tf32(proj.contiguous())))


def prepare_block_chain(stacked):
    """Bind one chain's stacked weights to the chain kernel, once: CUDA
    weights become a ``PreparedFusedChain`` (validated, transposed, and at
    f32 split, about twice the weights' bytes of device memory more; at bf16
    as many bytes as the weights), which the three
    ``fused_block_chain*`` functions take in place of ``stacked``. CPU
    weights are returned as they are: the plain chain needs nothing."""
    if isinstance(stacked, PreparedFusedChain) or not stacked["wf"].is_cuda:
        return stacked
    return PreparedFusedChain(stacked)


def _check_layers(stacked, layers, kernel_size):
    if isinstance(stacked, PreparedFusedChain):
        L, k = stacked.layers, stacked.kernel_size
    else:
        L, k = stacked["wf"].shape[:2]
    if (L, k) != (layers, kernel_size):
        raise ValueError(f"stacked weights hold {L} layers of kernel {k}, "
                         f"not layers={layers}, kernel_size={kernel_size}")


def _check_dtypes(name, x, c_up, stacked):
    """x, c_up and the weights of one dtype, as the JAX kernels take them:
    all f32 or all bf16 (the biases f32 either way; the kernels take no
    other, the plain chains any one float dtype). Returns whether it is
    bf16."""
    w = (stacked.dtype if isinstance(stacked, PreparedFusedChain)
         else stacked["wf"].dtype)
    if c_up.dtype != x.dtype or w != x.dtype:
        raise ValueError(f"{name}: x, c_up and the weights must be of one "
                         f"dtype (float32 or bfloat16), got x {x.dtype}, "
                         f"c_up {c_up.dtype}, weights {w}")
    return x.dtype == torch.bfloat16


def _nc_dilations(layers, kernel_size, dilations):
    if dilations is None:
        return _power_dilations(layers, kernel_size)
    if len(dilations) != layers:
        raise ValueError(f"{len(dilations)} dilations for {layers} layers")
    return tuple(int(d) for d in dilations)


def fused_block_chain_torch(x, c_up, stacked, layers=6, kernel_size=3):
    """The plain PyTorch causal chain with d = kernel_size**l (f32 or bf16,
    by the dtype of x)."""
    _check_dtypes("fused_block_chain_torch", x, c_up, stacked)
    _check_layers(stacked, layers, kernel_size)
    return _plain_chain(x, c_up, stacked, _causal_offsets(
        kernel_size, _power_dilations(layers, kernel_size)))


def fused_block_chain_tiled_torch(x, c_up, stacked, layers=6, kernel_size=3):
    """The plain version of ``fused_block_chain_tiled``: the tiled TPU
    kernel computes exactly the whole-T causal chain, so this is it."""
    return fused_block_chain_torch(x, c_up, stacked, layers, kernel_size)


def fused_block_chain_nc_torch(x, c_up, stacked, layers=2, kernel_size=3,
                               dilations=None):
    """The plain PyTorch non-causal chain (per-layer zero padding of the
    symmetric convs); ``dilations`` defaults to kernel_size**l."""
    _check_dtypes("fused_block_chain_nc_torch", x, c_up, stacked)
    _check_layers(stacked, layers, kernel_size)
    return _plain_chain(x, c_up, stacked, _centred_offsets(
        kernel_size, _nc_dilations(layers, kernel_size, dilations)))


def _on_cpu(name, x):
    if x.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {x.device}")


def fused_block_chain(x, c_up, stacked, layers=6, kernel_size=3):
    """One causal L-layer chain over the whole T. x: (T, C); c_up:
    (T, cin); stacked: stack_block_weights()."""
    bf16 = _check_dtypes("fused_block_chain", x, c_up, stacked)
    if x.is_cuda:
        _check_layers(stacked, layers, kernel_size)
        return (fused_block_chain_bf16_cuda if bf16
                else fused_block_chain_cuda)(x, c_up, stacked)
    _on_cpu("fused_block_chain", x)
    return fused_block_chain_torch(x, c_up, stacked, layers, kernel_size)


def fused_block_chain_tiled(x, c_up, stacked, layers=6, kernel_size=3):
    """The causal chain in the form the IAF student serves with."""
    bf16 = _check_dtypes("fused_block_chain_tiled", x, c_up, stacked)
    if x.is_cuda:
        _check_layers(stacked, layers, kernel_size)
        return (fused_block_chain_tiled_bf16_cuda if bf16
                else fused_block_chain_tiled_cuda)(x, c_up, stacked)
    _on_cpu("fused_block_chain_tiled", x)
    return fused_block_chain_tiled_torch(x, c_up, stacked, layers,
                                         kernel_size)


def fused_block_chain_nc(x, c_up, stacked, layers=2, kernel_size=3,
                         dilations=None):
    """The non-causal chain (FloWaveNet coupling nets pass
    ``2**(i % layers)`` as ``dilations``)."""
    bf16 = _check_dtypes("fused_block_chain_nc", x, c_up, stacked)
    if x.is_cuda:
        _check_layers(stacked, layers, kernel_size)
        return (fused_block_chain_nc_bf16_cuda if bf16
                else fused_block_chain_nc_cuda)(
            x, c_up, stacked, _nc_dilations(layers, kernel_size, dilations))
    _on_cpu("fused_block_chain_nc", x)
    return fused_block_chain_nc_torch(x, c_up, stacked, layers, kernel_size,
                                      dilations)
