"""Dead-code reset for the codebook-revival extension.

Counterpart of ``vqvae_speech_tpu/models/vq_repulsion.py::reset_dead_codes``
(the reference's old/vqvae_2d_improved.py:146-170): codes whose usage EMA fell
below a threshold are re-seeded from random input rows, every dead code k
taking row ``perm[rank(k)]`` of ONE permutation of the input rows. The
module's repulsion forces belong to the 2-D demos and are not ported here.
"""
from typing import NamedTuple, Optional

import torch


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
