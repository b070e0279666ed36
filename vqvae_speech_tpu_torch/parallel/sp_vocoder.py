"""Sequence-parallel (time-sharded) ClariNet teacher over a mesh axis.

Counterpart of ``vqvae_speech_tpu/parallel/sp_vocoder.py`` (SURVEY.md
section 5: time sharding, which the reference cannot express). The
teacher's core is a chain of CAUSAL dilated convs, which shard over time:

* T splits contiguously over the axis; each rank holds (B, T/n, C),
* each dilated conv needs the previous rank's last ``d * (k - 1)``
  samples, its halo (one for a resblock's filter and gate convs, which
  read the same input); rank 0 receives zeros, which is exactly the causal
  left pad, so the sharded forward equals the global one,
* the 1x1 convs, the gates and the skip sums are local.

The halo moves with an all-gather of every rank's tail over the axis, on
every backend: gloo's send/recv take CPU tensors only, and one path for
gloo and NCCL is one path to test. Point-to-point ops have no autograd, so
``_Halo`` is an autograd function: its backward all-gathers the halos'
gradients and adds each to the tail of the rank it came from, which is
what the JAX package's ``ppermute`` transposes to.

``sp_teacher_loss`` pairs ``y_hat[t]`` with ``x[t + 1]``; the pair across
each rank's last sample takes the next rank's first sample, and the mean
is over the global B * (T - 1) pairs.
"""
import math

import torch
import torch.distributed as dist

from vqvae_speech_tpu_torch.models.clarinet.loss import gaussian_loss
from vqvae_speech_tpu_torch.models.clarinet.modules import (
    conv_apply,
    scaled,
    sigmoid,
)
from vqvae_speech_tpu_torch.parallel.mesh import axis_rank, axis_size

_SQRT_HALF = math.sqrt(0.5)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


class _Halo(torch.autograd.Function):
    """The previous rank's ``tail`` (zeros on rank 0); the backward hands
    the halo's gradient back to the previous rank's tail."""

    @staticmethod
    def forward(ctx, tail, group):
        ctx.group = group
        r = dist.get_rank(group)
        tails = _gather(tail, group)
        return tails[r - 1] if r else torch.zeros_like(tail)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        grads = _gather(grad, ctx.group)
        last = r == dist.get_world_size(ctx.group) - 1
        return (torch.zeros_like(grad) if last else grads[r + 1]), None


class _SumOverRanks(torch.autograd.Function):
    """The sum of every rank's value, on every rank; the backward passes
    the gradient through to this rank's own term, so that a loss built on
    the sum differentiates, on each rank, to that rank's share, and the
    shares summed over the ranks are the whole gradient."""

    @staticmethod
    def forward(ctx, value, group):
        out = value.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _with_halo(x, kernel_size, dilation, group):
    """A time-sharded (B, T_local, C) block with the previous rank's last
    ``dilation * (kernel_size - 1)`` samples in front: what a VALID conv
    turns into the global causal conv's block."""
    halo = dilation * (kernel_size - 1)
    if halo > x.shape[1]:
        raise ValueError(
            f"halo {halo} exceeds the local block of {x.shape[1]} samples; "
            f"use fewer shards or longer sequences")
    if halo == 0:
        return x
    return torch.cat([_Halo.apply(x[:, x.shape[1] - halo:], group), x], dim=1)


def _sp_resblock(p, x, c, kernel_size, dilation, group):
    # one halo for both dilated convs, which read the same input
    xx = _with_halo(x, kernel_size, dilation, group)
    h_f = conv_apply(p["filter_conv"], xx, kernel_size, dilation,
                     mode="VALID")
    h_g = conv_apply(p["gate_conv"], xx, kernel_size, dilation, mode="VALID")
    if c is not None:
        h_f = h_f + conv_apply(p["filter_conv_c"], c, 1)
        h_g = h_g + conv_apply(p["gate_conv_c"], c, 1)
    out = torch.tanh(h_f) * sigmoid(h_g)
    res = conv_apply(p["res_conv"], out, 1)
    skip = conv_apply(p["skip_conv"], out, 1)
    return scaled(x + res, _SQRT_HALF), skip


def sp_gaussian_wavenet_core(params, cfg, x, c_up, mesh, axis: str = "data"):
    """The ClariNet teacher's core (``models.clarinet.gaussian_wavenet_core``)
    on this rank's time block: x (B, T_local, 1) and c_up (B, T_local, cin)
    are the rank's contiguous blocks of the global (B, T, ...) in ``axis``
    order; ``params`` the resolved tree (``convert.resolve_gaussian_wavenet``),
    the same on every rank. Returns the (B, T_local, out_channels) block of
    the global output. Raises ValueError when a halo exceeds T_local."""
    group = mesh.get_group(axis)
    h = torch.relu(conv_apply(params["front_conv"],
                              _with_halo(x, cfg.front_channels, 1, group),
                              cfg.front_channels, mode="VALID"))
    skip = 0.0
    for i, p in enumerate(params["res_blocks"]):
        h, s = _sp_resblock(p, h, c_up, cfg.kernel_size, cfg.dilation(i),
                            group)
        skip = skip + s
    out = torch.relu(skip)
    out = torch.relu(conv_apply(params["final_conv_1"], out, 1))
    return conv_apply(params["final_conv_2"], out, 1)


def sp_teacher_loss(params, cfg, x, c_up, mesh, axis: str = "data"):
    """The teacher's Gaussian NLL of the next sample (``train/vocoder.py``)
    over the time-sharded core: the mean over the global B * (T - 1) pairs,
    the same value on every rank. Its gradient on each rank is that rank's
    share; the sum of the shares over the ranks (an all-reduce of the
    gradients) is the global loss's gradient."""
    group = mesh.get_group(axis)
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    y_hat = sp_gaussian_wavenet_core(params, cfg, x, c_up, mesh, axis)
    # the first sample of every rank: rank r's last pair takes rank r+1's
    heads = _gather(x[:, :1].detach(), group)
    target = x[:, 1:] if r == n - 1 else torch.cat([x[:, 1:], heads[r + 1]],
                                                   dim=1)
    pairs = y_hat[:, :target.shape[1]]
    local = gaussian_loss(pairs, target).sum()
    count = x.shape[0] * (x.shape[1] * n - 1)
    return _SumOverRanks.apply(local, group) / count
