"""Codebook-revival extension of the train step (default OFF).

Counterpart of ``vqvae_speech_tpu/train/revival.py``: tracks a usage EMA of
per-code assignment fractions and re-seeds codes whose usage falls below a
threshold from random pre-VQ latent rows of the current batch. Adam moments of
re-seeded rows are left untouched (gradient variant), as in the reference's
demo.
"""
from typing import Optional

import torch

from vqvae_speech_tpu_torch.models.vq_repulsion import reset_dead_codes


def revival_settings(config: dict):
    """(enabled, usage_decay, threshold) from the config knobs."""
    enabled = bool(config.get("codebook_revival", False))
    decay = float(config.get("revival_usage_decay", 0.99))
    threshold = config.get("revival_threshold")
    if enabled and threshold is None:
        # usage is a fraction (uniform = 1/K): default to 10% of uniform
        threshold = 0.1 / config["num_embeddings"]
    return enabled, decay, threshold


@torch.no_grad()
def apply_revival(model, counts: torch.Tensor, flat: torch.Tensor,
                  rev_decay: float, rev_threshold: float, *,
                  perm: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """One post-update revival pass on a ConvVQVAE built with
    ``codebook_revival``; returns the number of re-seeded codes (a 0-d f32
    tensor, the step's ``revived_codes`` metric).

    ``counts`` (K,) are this batch's per-code assignment counts and ``flat``
    (N, D) its reference-flattened pre-VQ latent rows, both detached. The
    usage EMA and the EMA variant's buffers are replaced by new tensors; the
    gradient variant's codebook parameter is overwritten in place.
    """
    vq = model.vq
    K = vq.codebook.shape[0]
    frac = counts / counts.sum().clamp(min=1.0)
    usage = model.revival_usage * rev_decay + (1.0 - rev_decay) * frac
    if vq.ema:
        rr = reset_dead_codes(
            vq.codebook, vq.ema_w, vq.ema_cluster_size, usage, flat,
            threshold=rev_threshold, usage_init=1.0 / K, perm=perm,
            generator=generator)
        vq.codebook, vq.ema_w = rr.codebook, rr.ema_w
        vq.ema_cluster_size = rr.cluster_size
    else:
        cb = vq.codebook.detach()
        rr = reset_dead_codes(
            cb, cb, torch.zeros(K, dtype=cb.dtype, device=cb.device), usage,
            flat.to(cb.dtype), threshold=rev_threshold, usage_init=1.0 / K,
            perm=perm, generator=generator)
        vq.codebook.copy_(rr.codebook)
    model.revival_usage = rr.usage
    return rr.num_reset.to(torch.float32)
