"""Pairwise L2 distances on tensors (eval path).

Counterpart of ``vqvae_speech_tpu/ops/pairwise.py``: the reference computes
eval-mode pairwise distances with Python loops over
``itertools.combinations`` / ``product`` of tensor rows
(reference src/models/vector_quantizer.py:109-127); here each is one
broadcasted expression on the tensors' device. Orders match itertools:
``combinations`` is the upper triangle row-major (i < j), ``product`` the
row-major cartesian product.
"""
import torch


def cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) euclidean distances (product order when
    raveled)."""
    sq = (x.square().sum(1, keepdim=True) + y.square().sum(1)
          - 2.0 * x @ y.t())
    return sq.clamp_min(0.0).sqrt()


def pdist(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N*(N-1)/2,) condensed euclidean distances in
    itertools.combinations order (upper triangle, row-major)."""
    n = x.shape[0]
    rows, cols = torch.triu_indices(n, n, offset=1, device=x.device)
    return cdist(x, x)[rows, cols]
