"""FloWaveNet: the flow-based parallel vocoder (exact MLE + one-pass
synthesis).

Counterpart of ``vqvae_speech_tpu/models/flowavenet/model.py`` (reference
src/flow_wavenet/model.py:35-289 and src/flow_wavenet/modules.py):

* ActNorm ``scale * (x + loc)`` with logdet, its data-dependent init, and
  its reverse ``y / scale - loc``,
* AffineCoupling: a non-causal WaveNet with a zero-init output conv maps
  (in_a, c_a) -> (log_s, t); forward ``out_b = (in_b - t) * exp(-log_s)``
  with logdet ``-sum(log_s)``, reverse ``in_b = out_b * exp(log_s) + t``,
* change_order half-swap between flows,
* Block: time-squeeze x2 -> n_flow flows -> optional multi-scale split with
  a WaveNet Gaussian prior,
* ``flowavenet_forward`` -> (log_p, logdet) per dim for MLE training,
  ``flowavenet_reverse`` inverts everything for single-pass synthesis,
* ConvTranspose2d (3, 2s) LC upsampling (scales [16, 16] = hop 256).

Activations keep the JAX package's channels-last (B, T, C) layout, so
squeeze and unsqueeze are the same reshapes. ``flowavenet_reverse`` takes
the resolved trees of ``convert.load_flowavenet_params``;
``flowavenet_forward`` and ``actnorm_initialize`` take the JAX-layout tensor
tree (``convert.tensor_tree``), as JAX's do, and resolve it themselves
(the forward inside autograd, so the gradients reach its leaves).
"""
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from vqvae_speech_tpu_torch.models.clarinet.modules import (
    cast_params,
    check_compute_dtype,
    conv_apply,
    resblock_apply,
    scaled,
    upsample_apply,
)
from vqvae_speech_tpu_torch.ops.fused_resblock import fused_block_chain_nc


@dataclass(frozen=True)
class CouplingNetConfig:
    in_channels: int
    out_channels: int
    num_blocks: int = 1
    num_layers: int = 6
    residual_channels: int = 256
    gate_channels: int = 256
    skip_channels: int = 256
    kernel_size: int = 3
    cin_channels: int = 80
    causal: bool = False

    @property
    def total_layers(self):
        return self.num_blocks * self.num_layers

    def dilation(self, i):
        return 2 ** (i % self.num_layers)


def _zero_conv_apply(p, x):
    """ZeroConv1d: 1x1 conv with a learned exp(scale*3) gain
    (reference modules.py:50-63); ``w`` is (1, in, out) as in JAX."""
    return (x @ p["w"][0] + p["b"]) * torch.exp(scaled(p["scale"], 3.0))


def coupling_net_apply(params, cfg: CouplingNetConfig, x, c, use_fused=False):
    """x: (B, T, in) -> (B, T, out). ``use_fused`` (batch 1, non-causal)
    runs each ``num_layers``-deep resblock chain by
    ``ops.fused_resblock.fused_block_chain_nc`` over ``params["chains"]``:
    on a CUDA tensor one call of the hand-written chain kernel a chain.
    The front conv, the final 1x1 and the zero conv stay plain PyTorch. The
    chains' skip sums are summed in f32 and cast to x's dtype, as in the
    JAX package."""
    h = torch.relu(conv_apply(params["front_conv"], x, 3, causal=cfg.causal))
    if use_fused:
        if cfg.causal or x.shape[0] != 1:
            raise ValueError("fused coupling chain is the non-causal "
                             "batch-1 path")
        dil = tuple(cfg.dilation(i) for i in range(cfg.num_layers))
        T = h.shape[1]
        h = h[0].contiguous()
        c0 = c[0, :T].contiguous()
        skip = None
        for stacked in params["chains"]:
            h, s = fused_block_chain_nc(h, c0, stacked, layers=cfg.num_layers,
                                        kernel_size=cfg.kernel_size,
                                        dilations=dil)
            skip = s if skip is None else skip + s
        skip = skip[None].to(x.dtype)
    else:
        skip = 0.0
        for i, p in enumerate(params["res_blocks"]):
            h, s = resblock_apply(p, h, c, cfg.kernel_size, cfg.dilation(i),
                                  cfg.causal)
            skip = skip + s
    out = torch.relu(skip)
    out = torch.relu(conv_apply(params["final_conv_1"], out, 1))
    return _zero_conv_apply(params["final_zero_conv"], out)


def actnorm_forward(p, x):
    """x: (B, T, C) -> (scale*(x+loc), logdet) with
    logdet = B*T*sum(log|scale|) (reference model.py:64-79)."""
    B, T = x.shape[0], x.shape[1]
    logdet = torch.sum(torch.log(torch.abs(p["scale"]))) * B * T
    return p["scale"] * (x + p["loc"]), logdet


def actnorm_reverse(p, y):
    return y / p["scale"] - p["loc"]


def _data_dependent_actnorm(x):
    """Per-channel -mean and 1/(std+1e-6) from a data batch
    (reference model.py:45-62; std is the unbiased torch .std())."""
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0)
    n = flat.shape[0]
    std = torch.sqrt(torch.sum(torch.square(flat - mean), 0) / (n - 1))
    return {"loc": -mean, "scale": 1.0 / (std + 1e-6)}


def _change_order(x, c):
    xa, xb = x.chunk(2, dim=-1)
    ca, cb = c.chunk(2, dim=-1)
    return torch.cat([xb, xa], -1), torch.cat([cb, ca], -1)


def _squeeze(x):
    """(B, T, C) -> (B, T//2, 2C), new channel ch = c*2 + parity: the
    interleaved order of the reference's view/permute squeeze
    (model.py:184-188), so couple/split channel groupings match."""
    B, T, C = x.shape
    return x.reshape(B, T // 2, 2, C).transpose(2, 3).reshape(B, T // 2, 2 * C)


def _unsqueeze(x):
    B, T2, C2 = x.shape
    return x.reshape(B, T2, C2 // 2, 2).transpose(2, 3).reshape(
        B, T2 * 2, C2 // 2)


@dataclass(frozen=True)
class FlowavenetConfig:
    in_channel: int = 1
    cin_channel: int = 80
    n_block: int = 8
    n_flow: int = 6
    n_layer: int = 2
    affine: bool = True
    block_per_split: int = 8
    filter_size: int = 256
    upsample_scales: Sequence[int] = (16, 16)

    def split_at(self, i):
        return bool(not ((i + 1) % self.block_per_split
                         or i == self.n_block - 1))


def _block_channels(cfg: FlowavenetConfig):
    """(in_channel, cin_channel) entering each block (pre-squeeze)."""
    chans = []
    in_ch, cin_ch = cfg.in_channel, cfg.cin_channel
    for i in range(cfg.n_block):
        chans.append((in_ch, cin_ch))
        cin_ch *= 2
        if not cfg.split_at(i):
            in_ch *= 2
    return chans


def _flow_net_cfg(cfg: FlowavenetConfig, sq, sqc):
    return CouplingNetConfig(
        in_channels=sq // 2, out_channels=sq if cfg.affine else sq // 2,
        num_blocks=1, num_layers=cfg.n_layer,
        residual_channels=cfg.filter_size, gate_channels=cfg.filter_size,
        skip_channels=cfg.filter_size, cin_channels=sqc // 2, causal=False)


def _prior_net_cfg(sq, sqc):
    return CouplingNetConfig(
        in_channels=sq // 2, out_channels=sq, num_blocks=1, num_layers=2,
        residual_channels=256, gate_channels=256, skip_channels=256,
        cin_channels=sqc, causal=False)


def _coupling_forward(p, net_cfg, x, c, affine):
    in_a, in_b = x.chunk(2, dim=-1)
    c_a, _ = c.chunk(2, dim=-1)
    net_out = coupling_net_apply(p, net_cfg, in_a, c_a)
    if affine:
        log_s, t = net_out.chunk(2, dim=-1)
        out_b = (in_b - t) * torch.exp(-log_s)
        # the logdet is summed in f32 whatever the compute dtype
        logdet = torch.sum(-log_s.float())
    else:
        out_b = in_b + net_out
        logdet = x.new_zeros((), dtype=torch.float32)
    return torch.cat([in_a, out_b], -1), logdet


def _coupling_reverse(p, net_cfg, y, c, affine, use_fused=False):
    out_a, out_b = y.chunk(2, dim=-1)
    c_a, _ = c.chunk(2, dim=-1)
    net_out = coupling_net_apply(p, net_cfg, out_a, c_a, use_fused=use_fused)
    if affine:
        log_s, t = net_out.chunk(2, dim=-1)
        in_b = out_b * torch.exp(log_s) + t
    else:
        in_b = out_b - net_out
    return torch.cat([out_a, in_b], -1)


def flowavenet_upsample(params, c, cfg: FlowavenetConfig):
    return upsample_apply(params["upsample_conv"], c, cfg.upsample_scales)


def flowavenet_reverse(params, cfg: FlowavenetConfig, z, c,
                       compute_dtype=None, use_fused=False):
    """Invert the flow: z: (B, T, 1) noise -> waveform (B, T, 1) f32
    (reference model.py:259-282). c is (B, Tc, cin) mel frames, or already
    upsampled when its length equals z's. ``compute_dtype=torch.bfloat16``
    casts the parameters, z and c in (``cast_params``; a tree loaded at
    bf16 is used as it is), so the upsampler, the priors, the couplings and
    the ActNorms run in bf16; None or f32 runs in f32.

    ``use_fused`` (batch 1 only; a larger batch raises) runs every flow's
    coupling resblock chain through the fused non-causal chain, in every
    block (the JAX package fuses only blocks whose conditioning is at most
    1024 wide, a limit of its kernel's on-chip memory that the streaming
    kernel here does not have; at bf16 its unfused blocks sum skip in bf16,
    these in f32)."""
    check_compute_dtype(compute_dtype)
    if compute_dtype == torch.bfloat16:
        params = cast_params(params, compute_dtype)
        z, c = z.to(compute_dtype), c.to(compute_dtype)
    if use_fused and z.shape[0] != 1:
        raise ValueError("use_fused is the batch-1 path, got batch "
                         f"{z.shape[0]}")
    if c.shape[1] != z.shape[1]:
        c = flowavenet_upsample(params, c, cfg)
    x = z
    z_list = []
    # squeeze all the way down, collecting split z's
    for i in range(cfg.n_block):
        x, c = _squeeze(x), _squeeze(c)
        if cfg.split_at(i):
            x, zz = x.chunk(2, dim=-1)
            z_list.append(zz)

    chans = _block_channels(cfg)
    for i in range(cfg.n_block - 1, -1, -1):
        block = params["blocks"][i]
        in_ch, cin_ch = chans[i]
        sq, sqc = in_ch * 2, cin_ch * 2
        net_cfg = _flow_net_cfg(cfg, sq, sqc)
        if cfg.split_at(i):
            mean, log_sd = coupling_net_apply(
                block["prior"], _prior_net_cfg(sq, sqc), x, c).chunk(2, dim=-1)
            eps = z_list[(i + 1) // cfg.block_per_split - 1]
            x = torch.cat([x, mean + torch.exp(log_sd) * eps], -1)
        for flow in reversed(block["flows"]):
            x, c = _change_order(x, c)
            x = _coupling_reverse(flow["coupling"], net_cfg, x, c, cfg.affine,
                                  use_fused=use_fused)
            x = actnorm_reverse(flow["actnorm"], x)
        x, c = _unsqueeze(x), _unsqueeze(c)
    return x.float()


def flowavenet_forward(params, cfg: FlowavenetConfig, x, c,
                       compute_dtype=None):
    """x: (B, T, 1); c: (B, Tc, cin) -> (log_p, logdet) per dim, f32 0-d
    tensors (reference model.py:245-257). ``params`` is the JAX-layout
    tensor tree; its weight norms are resolved here, in autograd.

    ``compute_dtype=torch.bfloat16`` is the JAX package's mixed-precision
    MLE: the tree (cast first, then resolved), x and c in bf16, so the
    upsampler, the couplings and the priors run in bf16, while the
    log-density math stays f32: the ActNorm logdet comes from the UNCAST
    f32 scales at the squeezed length of each block, the coupling logdet
    sums f32-cast ``log_s``, and the Gaussian log-probs cast their inputs up
    first."""
    from vqvae_speech_tpu_torch.convert import resolve_flowavenet

    check_compute_dtype(compute_dtype)
    cast = compute_dtype == torch.bfloat16
    B, T = x.shape[0], x.shape[1]
    fparams = resolve_flowavenet(params, cfg, compute_dtype if cast else None)
    if cast:
        x, c = x.to(compute_dtype), c.to(compute_dtype)
    c = flowavenet_upsample(fparams, c, cfg)
    out = x
    logdet_sum = torch.zeros((), device=x.device)
    log_p_sum = torch.zeros((), device=x.device)
    for i, block in enumerate(fparams["blocks"]):
        in_ch, cin_ch = _block_channels(cfg)[i]
        sq, sqc = in_ch * 2, cin_ch * 2
        net_cfg = _flow_net_cfg(cfg, sq, sqc)
        out, c = _squeeze(out), _squeeze(c)
        # the ActNorm logdet: a function of the f32 master scales and the
        # SQUEEZED length at this depth (reference model.py:64-79, 245-257)
        T_sq = out.shape[1]
        for flow32 in params["blocks"][i]["flows"]:
            logdet_sum = logdet_sum + B * T_sq * torch.sum(
                torch.log(torch.abs(flow32["actnorm"]["scale"]))).float()
        for flow in block["flows"]:
            out = flow["actnorm"]["scale"] * (out + flow["actnorm"]["loc"])
            out, det_c = _coupling_forward(flow["coupling"], net_cfg, out, c,
                                           cfg.affine)
            out, c = _change_order(out, c)
            logdet_sum = logdet_sum + det_c
        if cfg.split_at(i):
            out, z = out.chunk(2, dim=-1)
            mean, log_sd = coupling_net_apply(
                block["prior"], _prior_net_cfg(sq, sqc), out, c).chunk(2, dim=-1)
            z32, mean32, log_sd32 = z.float(), mean.float(), log_sd.float()
            log_p_sum = log_p_sum + torch.sum(
                -0.5 * math.log(2 * math.pi) - log_sd32
                - 0.5 * torch.square(z32 - mean32) / torch.exp(2 * log_sd32))
    out32 = out.float()
    log_p_sum = log_p_sum + 0.5 * torch.sum(
        -math.log(2.0 * math.pi) - torch.square(out32))
    return log_p_sum / (B * T), logdet_sum / (B * T)


def actnorm_initialize(params, cfg: FlowavenetConfig, x, c):
    """Data-dependent ActNorm init (PARITY #30): run the forward once in f32,
    replacing each ActNorm's ``loc`` / ``scale`` with the batch statistics of
    its input (the reference's initialize-on-first-forward,
    model.py:45-62). ``params`` is the JAX-layout tensor tree; returns a new
    tree that shares every leaf but the ActNorms (new tensors on x's
    device)."""
    from vqvae_speech_tpu_torch.convert import resolve_flowavenet

    with torch.no_grad():
        fparams = resolve_flowavenet(params, cfg)
        c_up = flowavenet_upsample(fparams, c, cfg)
        out = x
        blocks = []
        for i, block in enumerate(fparams["blocks"]):
            in_ch, cin_ch = _block_channels(cfg)[i]
            sq, sqc = in_ch * 2, cin_ch * 2
            net_cfg = _flow_net_cfg(cfg, sq, sqc)
            out, c_up = _squeeze(out), _squeeze(c_up)
            flows = []
            for src, flow in zip(params["blocks"][i]["flows"],
                                 block["flows"]):
                actnorm = _data_dependent_actnorm(out)
                flows.append(dict(src, actnorm=actnorm))
                out, _ = actnorm_forward(actnorm, out)
                out, _ = _coupling_forward(flow["coupling"], net_cfg, out,
                                           c_up, cfg.affine)
                out, c_up = _change_order(out, c_up)
            if cfg.split_at(i):
                out, _ = out.chunk(2, dim=-1)
            blocks.append(dict(params["blocks"][i], flows=flows))
    return dict(params, blocks=blocks)
