"""Adaptive VQ-EMA: automatic codebook sizing via usage pruning + merging.

Counterpart of ``vqvae_speech_tpu/models/vq_adaptive.py`` (the reference's
adaptive demo family, old/vqvae_adaptive.py:16-259):

* an active-code mask over a fixed K_max codebook,
* EMA usage tracking; codes under ``min_usage_threshold`` of total usage are
  pruned every ``prune_interval`` steps,
* active code pairs closer than ``merge_distance_threshold`` are merged into
  the higher-usage member (usage-weighted average),
* stability = active count unchanged for ``stable_epochs_required`` passes.

The state is a dict of tensors with the JAX package's names; every function
returns a new one and changes nothing in place. The JAX package masks
inactive codes out of its argmin with +inf distances; here the search runs
through ``ops.vq.vq_search`` (the hand-written CUDA kernel for CUDA tensors)
on the active codes' rows, gathered in ascending index order, and its
indices are mapped back: the same argmin with the same first-index tie rule,
and counts and ``dw`` scattered back to the full K. The prune and merge pass
is plain torch, its one scatter made deterministic (see
``adaptive_prune_and_merge``).
"""
import math
from typing import NamedTuple, Optional

import torch

from vqvae_speech_tpu_torch.ops.vq import vq_search


class AdaptiveVQOutput(NamedTuple):
    vq_loss: torch.Tensor
    quantized: torch.Tensor
    perplexity: torch.Tensor
    indices: torch.Tensor
    new_state: dict


def adaptive_vq_init(max_embeddings: int, embedding_dim: int,
                     initial_num_embeddings: Optional[int] = None, *, device,
                     generator: Optional[torch.Generator] = None,
                     dtype=torch.float32) -> dict:
    """All K_max slots allocated; only the first ``initial_num_embeddings``
    start active (default-20 policy, reference line 37). The codebook and
    ``ema_w`` start equal, as the JAX function draws both from one key."""
    n0 = initial_num_embeddings or min(20, max_embeddings)
    codebook = torch.randn(max_embeddings, embedding_dim, generator=generator,
                           dtype=dtype).to(device)
    return {
        "codebook": codebook,
        "ema_cluster_size": torch.zeros(max_embeddings, dtype=dtype,
                                        device=device),
        "ema_w": codebook.clone(),
        "ema_usage": torch.zeros(max_embeddings, dtype=dtype, device=device),
        "active": torch.arange(max_embeddings, device=device) < n0,
        "stable_steps": torch.zeros((), dtype=torch.int32, device=device),
        "last_active_count": torch.tensor(n0, dtype=torch.int32,
                                          device=device),
    }


def suggest_initial_codes(data_size: int, max_embeddings: int = 30) -> int:
    """sqrt-of-data-size heuristic (reference lines 244-259)."""
    return min(max_embeddings, max(5, int(math.sqrt(data_size))))


def adaptive_vq_apply(state: dict, inputs: torch.Tensor, *,
                      commitment_cost: float = 0.25, decay: float = 0.99,
                      epsilon: float = 1e-5,
                      training: bool = True) -> AdaptiveVQOutput:
    """inputs: (..., D) -> AdaptiveVQOutput. Inactive codes are never
    selected; EMA updates only touch active rows."""
    codebook = state["codebook"]
    active = state["active"]
    K, D = codebook.shape
    shape = inputs.shape
    flat = inputs.reshape(-1, D)

    # the active codes in ascending order: the first-index tie rule of the
    # masked argmin holds on the gathered rows
    active_idx = active.nonzero().flatten()
    res = vq_search(flat, codebook[active_idx])
    idx = active_idx[res.indices.long()]
    quantized = res.quantized.reshape(shape)

    e_latent = torch.mean((quantized.detach() - inputs) ** 2)
    commitment = commitment_cost * torch.mean(
        (quantized - inputs.detach()) ** 2)
    vq_loss = commitment + e_latent

    counts = torch.zeros(K, dtype=flat.dtype, device=flat.device)
    counts[active_idx] = res.counts
    new_state = state
    if training:
        with torch.no_grad():
            dw = torch.zeros(K, D, dtype=flat.dtype, device=flat.device)
            dw[active_idx] = res.dw
            batch_usage = counts / flat.shape[0]
            usage = state["ema_usage"] * decay + (1 - decay) * batch_usage
            cluster = torch.where(
                active,
                state["ema_cluster_size"] * decay + (1 - decay) * counts,
                state["ema_cluster_size"])
            ema_w = torch.where(active[:, None],
                                state["ema_w"] * decay + (1 - decay) * dw,
                                state["ema_w"])
            n = torch.where(active, cluster, 0.0).sum()
            n_active = active.sum()
            smoothed = (cluster + epsilon) / (n + n_active * epsilon) * n
            codebook = torch.where(active[:, None],
                                   ema_w / smoothed[:, None], codebook)
        new_state = dict(state, codebook=codebook, ema_cluster_size=cluster,
                         ema_w=ema_w, ema_usage=usage)

    quantized_st = inputs + (quantized - inputs).detach()
    avg = counts / flat.shape[0]
    perplexity = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
    return AdaptiveVQOutput(vq_loss, quantized_st, perplexity,
                            idx.to(torch.int32), new_state)


@torch.no_grad()
def adaptive_prune_and_merge(state: dict, min_usage_threshold: float = 0.01,
                             merge_distance_threshold: float = 0.5) -> dict:
    """Vectorized prune + merge pass (call every ``prune_interval`` steps).

    Prune: active codes with usage share below the threshold.
    Merge: for each active pair (i, j) with ||e_i - e_j|| below the
    threshold, the lower-usage member is pruned and the survivor becomes the
    usage-weighted average (reference lines 154-231): each code merges
    toward its nearest higher-usage close neighbor, one donor a winner a
    pass. Where several absorbed codes share a winner, the JAX function's
    scatter keeps one of them (XLA on the CPU: the highest index); this pass
    keeps the highest index by a max-reduction, the same on any device.
    """
    codebook = state["codebook"]
    active = state["active"]
    usage = state["ema_usage"]
    K = codebook.shape[0]
    ar = torch.arange(K, device=codebook.device)

    share = usage / (usage.sum() + 1e-10)
    to_prune = (share < min_usage_threshold) & active

    # pairwise distances among active codes
    sq = (codebook.square().sum(1, keepdim=True) + codebook.square().sum(1)
          - 2.0 * codebook @ codebook.t())
    dist = sq.clamp_min(0.0).sqrt()
    pair_active = active[:, None] & active[None, :]
    eye = torch.eye(K, dtype=torch.bool, device=codebook.device)
    close = (dist < merge_distance_threshold) & pair_active & ~eye

    # j loses to i when close and usage_i > usage_j (ties broken by index)
    usage_gt = (usage[:, None] > usage[None, :]) | (
        (usage[:, None] == usage[None, :]) & (ar[:, None] < ar[None, :]))
    loses = close & usage_gt.t()          # loses[j, i]: j absorbed into i
    absorbed = loses.any(1)               # j is absorbed by someone
    # winner for each absorbed j: the closest dominating neighbor
    winner = torch.where(loses, dist, torch.inf).argmin(1)

    # usage-weighted average into the winner; one donor a winner a pass
    # (the highest index), other donors resolve over later passes
    slot = torch.where(absorbed, winner, K)   # K: no winner (dropped)
    donor_of = torch.full((K + 1,), -1, dtype=torch.long,
                          device=codebook.device).scatter_reduce(
        0, slot, ar, "amax", include_self=True)[:K]
    has_donor = donor_of >= 0
    donor_idx = donor_of.clamp(0, K - 1)
    total = usage + torch.where(has_donor, usage[donor_idx], 0.0)
    w_self = torch.where(has_donor, usage / total.clamp_min(1e-10), 1.0)
    w_donor = torch.where(has_donor,
                          usage[donor_idx] / total.clamp_min(1e-10), 0.0)
    codebook = (w_self[:, None] * codebook
                + w_donor[:, None] * codebook[donor_idx])
    usage = torch.where(has_donor, total, usage)

    new_active = active & ~(to_prune | absorbed)
    # never go below one active code
    if not bool(new_active.any()):
        new_active = ar == 0
    usage = torch.where(new_active, usage, 0.0)

    count = new_active.sum().to(torch.int32)
    stable = torch.where(count == state["last_active_count"],
                         state["stable_steps"] + 1,
                         torch.zeros_like(state["stable_steps"]))
    return dict(state, codebook=codebook, ema_usage=usage,
                active=new_active, stable_steps=stable,
                last_active_count=count)


def active_codes_count(state) -> int:
    return int(state["active"].sum())


def is_stable(state, stable_passes_required: int = 2) -> bool:
    return int(state["stable_steps"]) >= stable_passes_required
