"""Vector quantizers (gradient and EMA variants).

Counterpart of ``vqvae_speech_tpu/models/vq.py`` (reference
src/models/vector_quantizer.py and vector_quantizer_ema.py):

* codebook search with the (C, T, B)-order flatten (PARITY #1), through
  ``ops.vq.vq_search`` — the fused CUDA kernel for CUDA tensors,
* straight-through estimator ``z + (q - z).detach()``,
* gradient variant: q-latent + beta-commitment losses, codebook a parameter,
* EMA variant (``decay > 0``): in training, the Laplace-smoothed cluster-size
  EMA and the dw EMA are applied BEFORE the quantized output is produced, and
  the quantized rows come from the UPDATED codebook (PARITY #2); the codebook
  and EMA statistics are buffers, updated in place,
* perplexity = exp(entropy of code usage), from the kernel's counts / N.

Input is (B, C, T); the returned VQOutput keeps the JAX package's layouts:
quantized (B, T, C), encodings and distances (B, T', K), indices (N, 1).
"""
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_speech_tpu_torch.ops.vq import (
    reference_flatten,
    reference_unflatten,
    vq_distances,
    vq_search,
)


class VQOutput(NamedTuple):
    vq_loss: torch.Tensor       # scalar loss to add to the objective
    quantized: torch.Tensor     # (B, T, C) straight-through quantized latents
    perplexity: torch.Tensor    # scalar exp-entropy of code usage
    encodings: torch.Tensor     # (B, T', K) one-hot in reference layout
    distances: torch.Tensor     # (B, T', K) distances, pre-update codebook
    indices: torch.Tensor       # (N, 1) int32 flat indices (reference layout)
    losses: dict                # per-term scalars
    new_state: Optional[dict]   # EMA state after this call (None: gradient)


class VectorQuantizer(nn.Module):
    """EMA variant iff ``decay > 0``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float, decay: float = 0.0,
                 epsilon: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        K, D = num_embeddings, embedding_dim
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.epsilon = epsilon
        self.ema = decay > 0.0
        if self.ema:
            self.register_buffer("codebook",
                                 torch.randn(K, D, generator=generator))
            self.register_buffer("ema_cluster_size", torch.zeros(K))
            self.register_buffer("ema_w", torch.randn(K, D, generator=generator))
        else:
            self.codebook = nn.Parameter(
                torch.empty(K, D).uniform_(-1.0 / K, 1.0 / K,
                                           generator=generator))

    def _ema_update(self, counts: torch.Tensor, dw: torch.Tensor) -> None:
        K = self.codebook.shape[0]
        decay, eps = self.decay, self.epsilon
        cluster = self.ema_cluster_size * decay + (1 - decay) * counts
        n = cluster.sum()
        cluster = (cluster + eps) / (n + K * eps) * n
        ema_w = self.ema_w * decay + (1 - decay) * dw
        self.ema_cluster_size.copy_(cluster)
        self.ema_w.copy_(ema_w)
        self.codebook.copy_(ema_w / cluster[:, None])

    def forward(self, z_bct: torch.Tensor) -> VQOutput:
        B, C, T = z_bct.shape
        K, D = self.codebook.shape
        pre_update_codebook = self.codebook.detach().clone() if self.ema \
            else self.codebook
        flat = reference_flatten(z_bct, D)
        res = vq_search(flat, self.codebook)
        onehot = F.one_hot(res.indices.long(), K).to(flat.dtype)

        new_state = None
        if self.ema:
            if self.training:
                with torch.no_grad():
                    self._ema_update(res.counts, res.dw)
            new_state = {"codebook": self.codebook,
                         "ema_cluster_size": self.ema_cluster_size,
                         "ema_w": self.ema_w}
            # quantize with the (possibly updated) codebook; a row gather is
            # exactly onehot @ codebook
            quant_flat = self.codebook[res.indices.long()]
        else:
            quant_flat = res.quantized.to(flat.dtype)
        quantized = reference_unflatten(quant_flat, B, C, T)   # (B, C, T)

        e_latent = torch.mean((quantized.detach() - z_bct) ** 2)
        commitment = self.commitment_cost * e_latent
        if self.ema:
            vq_loss = commitment
            losses = {"vq_loss": vq_loss}
        else:
            q_latent = torch.mean((quantized - z_bct.detach()) ** 2)
            vq_loss = q_latent + commitment
            losses = {"e_latent_loss": e_latent, "q_latent_loss": q_latent,
                      "commitment_loss": commitment, "vq_loss": vq_loss}

        quantized_st = z_bct + (quantized - z_bct).detach()

        avg_probs = res.counts.to(flat.dtype) / flat.shape[0]
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))

        distances = vq_distances(flat, pre_update_codebook).reshape(B, T, -1)
        return VQOutput(
            vq_loss=vq_loss,
            quantized=quantized_st.transpose(1, 2),
            perplexity=perplexity,
            encodings=onehot.reshape(B, T, -1),
            distances=distances,
            indices=res.indices[:, None],
            losses=losses,
            new_state=new_state,
        )
