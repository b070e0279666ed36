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
  and EMA statistics are buffers, and an update REPLACES them with new
  tensors, so a ``new_state`` handed out by one call is not changed by the
  next (the JAX package returns fresh arrays),
* perplexity = exp(entropy of code usage), from the kernel's counts / N.

Input is (B, C, T); the returned VQOutput keeps the JAX package's layouts:
quantized (B, T, C), encodings and distances (B, T', K), indices (N, 1).
A forward builds no (N, K) tensor of its own: ``encodings`` and ``distances``
are computed when first read (eager PyTorch drops no dead code, and a train
step reads neither).
"""
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvae_speech_tpu_torch.ops.vq import (
    reference_flatten,
    reference_unflatten,
    vq_distances,
    vq_search,
)


class VQOutput:
    """What one quantizer call returns; the JAX package's field names.

    ``encodings`` (B, T', K) one-hot and ``distances`` (B, T', K), the latter
    against the codebook the search saw (pre-update, PARITY #2), are built on
    first read from the call's own latents and codebook and then kept. The
    codebook is not cloned, so ``distances`` must be read before anything
    writes into it in place (an optimizer step on the gradient variant's
    parameter, a revival): a first read after such a write raises.
    """

    def __init__(self, *, vq_loss, quantized, perplexity, indices, losses,
                 new_state, counts, flat, codebook, batch_time):
        self.vq_loss = vq_loss          # scalar loss to add to the objective
        self.quantized = quantized      # (B, T, C) straight-through latents
        self.perplexity = perplexity    # scalar exp-entropy of code usage
        self.indices = indices          # (N, 1) int32 flat indices
        self.losses = losses            # per-term scalars
        self.new_state = new_state      # EMA state after this call, or None
        self.counts = counts            # (K,) rows per code in this call
        self._flat = flat
        self._codebook = codebook
        self._codebook_version = codebook._version
        self._batch_time = batch_time
        self._encodings = self._distances = None

    @property
    def encodings(self) -> torch.Tensor:
        if self._encodings is None:
            onehot = F.one_hot(self.indices[:, 0].long(),
                               self._codebook.shape[0])
            self._encodings = onehot.to(self._flat.dtype).reshape(
                *self._batch_time, -1)
        return self._encodings

    @property
    def distances(self) -> torch.Tensor:
        if self._distances is None:
            if self._codebook._version != self._codebook_version:
                raise RuntimeError(
                    "VQOutput.distances was first read after the codebook "
                    "this call searched was changed in place (an optimizer "
                    "step or a revival); read it before the update")
            self._distances = vq_distances(
                self._flat, self._codebook).reshape(*self._batch_time, -1)
        return self._distances


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

    def ema_state(self) -> dict:
        """The EMA variant's buffers, as the JAX package's ``state["vq"]``."""
        return {"codebook": self.codebook,
                "ema_cluster_size": self.ema_cluster_size,
                "ema_w": self.ema_w}

    def _ema_update(self, counts: torch.Tensor, dw: torch.Tensor) -> None:
        """New buffers in place of the old ones: tensors handed out earlier
        (a ``new_state``, a pending ``distances``) keep their values."""
        K = self.codebook.shape[0]
        decay, eps = self.decay, self.epsilon
        cluster = self.ema_cluster_size * decay + (1 - decay) * counts
        n = cluster.sum()
        cluster = (cluster + eps) / (n + K * eps) * n
        ema_w = self.ema_w * decay + (1 - decay) * dw
        self.ema_cluster_size = cluster
        self.ema_w = ema_w
        self.codebook = ema_w / cluster[:, None]

    def forward(self, z_bct: torch.Tensor) -> VQOutput:
        B, C, T = z_bct.shape
        D = self.codebook.shape[1]
        searched_codebook = self.codebook.detach()
        flat = reference_flatten(z_bct, D)
        res = vq_search(flat, self.codebook)

        new_state = None
        if self.ema:
            if self.training:
                with torch.no_grad():
                    self._ema_update(res.counts, res.dw)
            new_state = self.ema_state()
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

        return VQOutput(
            vq_loss=vq_loss,
            quantized=quantized_st.transpose(1, 2),
            perplexity=perplexity,
            indices=res.indices[:, None],
            losses=losses,
            new_state=new_state,
            counts=res.counts,
            flat=flat.detach(),
            codebook=searched_codebook,
            batch_time=(B, T),
        )
