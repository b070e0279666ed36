"""Codebook repulsion, usage EMA and dead-code reset: the 2-D demos'
quantizer variants and the codebook-revival extension.

Counterpart of ``vqvae_speech_tpu/models/vq_repulsion.py`` (the reference's
old/vqvae_2d_direct_fixed.py:56-109 ``VQWithRepulsion`` and
old/vqvae_2d_improved.py:57-170 ``ImprovedVectorQuantizerEMA``):

* ``codebook_repulsion``: a pairwise repulsive force between codes closer
  than ``min_distance``, all forces applied at once (the JAX package's
  vectorized form of the reference's sequential loops), plus the "improved"
  variant's outward-from-center force;
* ``usage_ema_update``: the per-code usage EMA;
* ``reset_dead_codes``: codes whose usage EMA fell below a threshold are
  re-seeded from random input rows, every dead code k taking row
  ``perm[rank(k)]`` of ONE permutation of the input rows.
"""
from typing import NamedTuple, Optional

import torch


def codebook_repulsion(codebook: torch.Tensor, strength: float,
                       min_distance: float, outward_strength: float = 0.0,
                       eps: float = 1e-8) -> torch.Tensor:
    """Push codes apart; returns the displaced codebook (K, D)."""
    diff = codebook[:, None, :] - codebook[None, :, :]       # i - j
    dist = diff.square().sum(-1).clamp_min(0.0).sqrt()
    near = (dist > 0.0) & (dist < min_distance)              # (K, K)
    direction = diff / (dist + eps)[..., None]
    magnitude = strength * (min_distance - dist) / min_distance
    force = torch.where(near[..., None], direction * magnitude[..., None],
                        0.0).sum(1)
    if outward_strength:
        center = codebook.mean(0, keepdim=True)
        out_dir = codebook - center
        norm = out_dir.square().sum(-1, keepdim=True).clamp_min(0.0).sqrt()
        force = force + torch.where(norm > 0, out_dir / (norm + eps),
                                    0.0) * outward_strength
    return codebook + force


def usage_ema_update(usage: torch.Tensor, counts: torch.Tensor,
                     decay: float) -> torch.Tensor:
    """usage EMA over per-batch code counts (K,)."""
    return usage * decay + (1.0 - decay) * counts


class ResetResult(NamedTuple):
    codebook: torch.Tensor
    ema_w: torch.Tensor
    cluster_size: torch.Tensor
    usage: torch.Tensor
    num_reset: torch.Tensor


def reset_dead_codes(codebook, ema_w, cluster_size, usage, flat_input,
                     threshold: float = 0.01, usage_init: float = 0.1,
                     cluster_init: float = 1.0, *,
                     perm: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> ResetResult:
    """Re-seed codes with usage EMA below ``threshold`` from random rows of
    ``flat_input`` (N, D). Returns new tensors; nothing is changed in place.

    ``perm`` (N,) is the permutation of the input rows when given (tests feed
    the JAX package's: ``jax.random.permutation`` cannot be reproduced);
    otherwise it is drawn on the CPU from ``generator``.
    """
    n = flat_input.shape[0]
    dead = usage < threshold                                   # (K,)
    if perm is None:
        perm = torch.randperm(n, generator=generator)
    perm = perm.to(flat_input.device, torch.long)
    rank = torch.cumsum(dead.to(torch.int64), 0) - 1           # (K,)
    rows = flat_input[perm[rank.clamp(0, n - 1) % n]]          # (K, D)
    dead_col = dead[:, None]
    return ResetResult(
        codebook=torch.where(dead_col, rows.to(codebook.dtype), codebook),
        ema_w=torch.where(dead_col, rows.to(ema_w.dtype), ema_w),
        cluster_size=torch.where(
            dead, torch.full_like(cluster_size, cluster_init), cluster_size),
        usage=torch.where(dead, torch.full_like(usage, usage_init), usage),
        num_reset=dead.sum(),
    )
