"""Codebook search with the codebook's rows sharded over the ``model`` axis.

Counterpart of ``vqvae_speech_tpu/parallel/sharded_vq.py`` (an extension the
reference does not have; SURVEY.md section 2.10): for a large codebook each
rank of the ``model`` axis holds K/m rows, computes the distances and the
argmin against them, and the winners are combined with one all-gather of
(min distance, global index) pairs over the axis. The N x K distance work
divides over the ranks.

Plain PyTorch, as the JAX version is plain jnp: it returns each row's
minimum distance, which the search kernel (``ops.vq.vq_search``) does not.
"""
import torch
import torch.distributed as dist

from vqvae_speech_tpu_torch.parallel.mesh import axis_rank, axis_size


def place_sharded_codebook(codebook: torch.Tensor, mesh,
                           axis: str = "model") -> torch.Tensor:
    """This rank's contiguous block of K/m rows of the (K, D) codebook; K
    must divide by the axis size m."""
    m, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    K = codebook.shape[0]
    if K % m:
        raise ValueError(f"a codebook of {K} rows does not divide over the "
                         f"{axis} axis of {m} ranks")
    per = K // m
    return codebook[r * per:(r + 1) * per]


def sharded_vq_search(flat: torch.Tensor, codebook_shard: torch.Tensor, mesh,
                      axis: str = "model"):
    """flat (N, D), the same on every rank of ``axis``; ``codebook_shard``
    this rank's (K/m, D) rows (``place_sharded_codebook``; the whole
    codebook with ``mesh=None``). Returns (indices
    (N,) int32 global code ids, min_distances (N,)), the same on every rank.
    A tie between shards goes to the lower shard, a tie within one to the
    lower row: ``argmin``'s first occurrence, as over the whole codebook."""
    m, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    d = (torch.sum(flat * flat, dim=1, keepdim=True)
         + torch.sum(codebook_shard * codebook_shard, dim=1)
         - 2.0 * flat @ codebook_shard.t())
    local_idx = torch.argmin(d, dim=1)
    local_min = torch.gather(d, 1, local_idx[:, None])[:, 0]
    global_idx = local_idx + r * codebook_shard.shape[0]
    if mesh is None:
        return global_idx.to(torch.int32), local_min
    group = mesh.get_group(axis)
    mins = [torch.empty_like(local_min) for _ in range(m)]
    idxs = [torch.empty_like(global_idx) for _ in range(m)]
    dist.all_gather(mins, local_min, group=group)
    dist.all_gather(idxs, global_idx, group=group)
    mins, idxs = torch.stack(mins), torch.stack(idxs)       # (m, N)
    best = torch.argmin(mins, dim=0, keepdim=True)          # (1, N)
    return (torch.gather(idxs, 0, best)[0].to(torch.int32),
            torch.gather(mins, 0, best)[0])
