"""Balanced VQ-EMA: usage-tracked codebook with dead-code revival.

Counterpart of ``vqvae_speech_tpu/models/vq_balanced.py`` (the reference's
standalone BalancedVQVAE demo, vqvae_balanced.py:11-102): the standard
last-dim flatten (NOT the composite model's (C, T, B) order), EMA codebook
updates, per-code usage counts, and re-initialization of under-used codes
near high-usage codes, every dead code drawing a donor uniformly from the
top-k high-usage codes and perturbing it with N(0, 0.5) noise.

The search, its counts and ``dw = onehot^T z`` come from ``ops.vq.vq_search``:
the hand-written CUDA kernel for CUDA tensors (the JAX package computes the
same function in plain jnp here), the plain chain for CPU tensors. The state
is a dict of tensors with the JAX package's names; ``balanced_vq_apply``
returns a new one and changes nothing in place.

Draws: ``jax.random`` streams cannot be reproduced, so the revival's donor
picks and noise are fed (``revival_draws``) or drawn from a
``torch.Generator`` (``revival_generator``).
"""
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.ops.vq import vq_search


class RevivalDraws(NamedTuple):
    """One revival's draws: ``slots`` (K,) integers in [0, k_top), each dead
    code's pick among the top-k donors (``jax.random.randint``), and
    ``noise`` (K, D) unit normals (``jax.random.normal``)."""
    slots: torch.Tensor
    noise: torch.Tensor


class BalancedVQOutput:
    """The JAX package's fields; ``encodings`` (N, K) one-hot is built when
    first read."""

    def __init__(self, vq_loss, quantized, perplexity, indices, new_state):
        self.vq_loss = vq_loss
        self.quantized = quantized      # inputs' shape, straight-through
        self.perplexity = perplexity
        self.indices = indices          # (N,) int32
        self.new_state = new_state
        self._encodings = None

    @property
    def encodings(self) -> torch.Tensor:
        if self._encodings is None:
            K = self.new_state["codebook"].shape[0]
            self._encodings = F.one_hot(self.indices.long(), K).to(
                self.quantized.dtype)
        return self._encodings


def balanced_vq_init(num_embeddings: int, embedding_dim: int, *, device,
                     generator: Optional[torch.Generator] = None,
                     dtype=torch.float32) -> dict:
    """Codebook U(-1/K, 1/K), zero EMA statistics and usage counts."""
    bound = 1.0 / num_embeddings
    codebook = torch.empty(num_embeddings, embedding_dim, dtype=dtype).uniform_(
        -bound, bound, generator=generator)
    return {
        "codebook": codebook.to(device),
        "ema_cluster_size": torch.zeros(num_embeddings, dtype=dtype,
                                        device=device),
        "ema_w": torch.zeros(num_embeddings, embedding_dim, dtype=dtype,
                             device=device),
        "usage_count": torch.zeros(num_embeddings, dtype=dtype, device=device),
    }


def revival_top_k(K: int) -> int:
    """How many high-usage codes a revival draws its donors from."""
    return min(3, K // 2)


def draw_revival(K: int, D: int, generator: torch.Generator) -> RevivalDraws:
    """One revival's draws from ``generator`` (on the CPU)."""
    slots = torch.randint(0, revival_top_k(K), (K,), generator=generator)
    return RevivalDraws(slots, torch.randn(K, D, generator=generator))


def balanced_vq_apply(state: dict, inputs: torch.Tensor, *,
                      commitment_cost: float = 0.25, decay: float = 0.99,
                      epsilon: float = 1e-5, training: bool = True,
                      revival_draws: Optional[RevivalDraws] = None,
                      revival_generator: Optional[torch.Generator] = None,
                      usage_threshold_frac: float = 0.1,
                      min_total_usage: float = 100.0,
                      revival_noise: float = 0.5) -> BalancedVQOutput:
    """inputs: (..., D). Returns BalancedVQOutput with the updated state.

    In training, dead codes are revived when draws are given
    (``revival_draws``) or can be drawn (``revival_generator``), as the JAX
    function revives them when it is given a ``revival_key``."""
    codebook = state["codebook"]
    K, D = codebook.shape
    shape = inputs.shape
    flat = inputs.reshape(-1, D)

    res = vq_search(flat, codebook)
    quantized = res.quantized.reshape(shape)

    e_latent = torch.mean((quantized.detach() - inputs) ** 2)
    q_latent = torch.mean((quantized - inputs.detach()) ** 2)
    vq_loss = q_latent + commitment_cost * e_latent

    new_state = state
    if training:
        with torch.no_grad():
            counts, dw = res.counts, res.dw
            usage = state["usage_count"] + counts
            cluster = (decay * state["ema_cluster_size"]
                       + (1 - decay) * counts)
            ema_w = decay * state["ema_w"] + (1 - decay) * dw
            n = cluster.sum()
            cluster = (cluster + epsilon) / (n + K * epsilon) * n
            codebook = ema_w / cluster[:, None]

            if revival_draws is None and revival_generator is not None:
                revival_draws = draw_revival(K, D, revival_generator)
            if revival_draws is not None:
                # vectorized dead-code revival (reference lines 75-91)
                threshold = usage.mean() * usage_threshold_frac
                dead = (usage < threshold) & (usage.sum() > min_total_usage)
                # jax.lax.top_k: the largest first, the lower index first
                # among equals (a stable descending sort)
                donors = torch.sort(usage, descending=True, stable=True
                                    ).indices[:revival_top_k(K)]
                pick = donors[revival_draws.slots.to(usage.device).long()]
                noise = revival_draws.noise.to(codebook.device,
                                               codebook.dtype)
                revived = codebook[pick] + revival_noise * noise
                codebook = torch.where(dead[:, None], revived, codebook)
                cluster = torch.where(dead, cluster[pick] / 2.0, cluster)
                ema_w = torch.where(dead[:, None],
                                    codebook * cluster[:, None], ema_w)
                usage = torch.where(dead, usage[pick] / 2.0, usage)

        new_state = {
            "codebook": codebook,
            "ema_cluster_size": cluster,
            "ema_w": ema_w,
            "usage_count": usage,
        }

    quantized_st = inputs + (quantized - inputs).detach()
    avg = res.counts / flat.shape[0]
    perplexity = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
    return BalancedVQOutput(vq_loss, quantized_st, perplexity, res.indices,
                            new_state)
