"""FloWaveNet: the flow-based parallel vocoder's one-pass synthesis.

Counterpart of the reverse half of ``vqvae_speech_tpu/models/flowavenet/
model.py`` (reference src/flow_wavenet/model.py:35-289 and
src/flow_wavenet/modules.py):

* AffineCoupling: a non-causal WaveNet with a zero-init output conv maps
  (in_a, c_a) -> (log_s, t); reverse: ``in_b = out_b * exp(log_s) + t``,
* ActNorm reverse ``y / scale - loc``, change_order half-swap between flows,
* Block: time-squeeze x2 -> n_flow flows -> optional multi-scale split with
  a WaveNet Gaussian prior,
* ``flowavenet_reverse`` inverts everything for single-pass synthesis,
* ConvTranspose2d (3, 2s) LC upsampling (scales [16, 16] = hop 256).

Activations keep the JAX package's channels-last (B, T, C) layout, so
squeeze and unsqueeze are the same reshapes. Parameters are the tensor
trees of ``convert.load_flowavenet_params``. The MLE forward
(``flowavenet_forward``) and ``actnorm_initialize`` are not ported yet.
"""
from dataclasses import dataclass
from typing import Sequence

import torch

from vqvae_speech_tpu_torch.models.clarinet.modules import (
    conv_apply,
    resblock_apply,
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
    return (x @ p["w"][0] + p["b"]) * torch.exp(p["scale"] * 3.0)


def coupling_net_apply(params, cfg: CouplingNetConfig, x, c, use_fused=False):
    """x: (B, T, in) -> (B, T, out). ``use_fused`` (batch 1, non-causal)
    runs each ``num_layers``-deep resblock chain by
    ``ops.fused_resblock.fused_block_chain_nc`` over ``params["chains"]``:
    on a CUDA tensor one call of the hand-written chain kernel a chain.
    The front conv, the final 1x1 and the zero conv stay plain PyTorch."""
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
        skip = skip[None]
    else:
        skip = 0.0
        for i, p in enumerate(params["res_blocks"]):
            h, s = resblock_apply(p, h, c, cfg.kernel_size, cfg.dilation(i),
                                  cfg.causal)
            skip = skip + s
    out = torch.relu(skip)
    out = torch.relu(conv_apply(params["final_conv_1"], out, 1))
    return _zero_conv_apply(params["final_zero_conv"], out)


def actnorm_reverse(p, y):
    return y / p["scale"] - p["loc"]


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
    """Invert the flow: z: (B, T, 1) noise -> waveform (B, T, 1)
    (reference model.py:259-282), in f32. c is (B, Tc, cin) mel frames, or
    already upsampled when its length equals z's.

    ``use_fused`` (batch 1 only; a larger batch raises) runs every flow's
    coupling resblock chain through the fused non-causal chain, in every
    block (the JAX package fuses only blocks whose conditioning is at most
    1024 wide, a limit of its kernel's on-chip memory that the streaming
    kernel here does not have)."""
    if compute_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: only the f32 flow is ported "
            "to PyTorch yet")
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
