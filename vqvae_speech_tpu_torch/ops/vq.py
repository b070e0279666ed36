"""Vector-quantization codebook search: hand-written CUDA kernel + plain path.

Counterpart of ``vqvae_speech_tpu/ops/vq.py``. Per call it computes

    distances = ||z||^2 + ||e||^2 - 2 z @ e^T        (N, K)
    indices   = argmin(distances, axis=1)            (N,)  int32
    quantized = onehot(indices) @ e                  (N, D)
    counts    = sum(onehot, axis=0)                  (K,)
    dw        = onehot^T @ z                         (K, D)

``vq_search_torch`` is the plain PyTorch chain (the counterpart of
``vq_search_xla``). ``vq_search`` dispatches on the device of its input: a
CUDA tensor always goes to the fused kernel ``csrc/vq_search.cu`` (the port
of the Pallas ``_vq_kernel``), a CPU tensor to the plain chain. It is
differentiable through ``VQSearchFunction``, whose backward is the JAX
package's ``_vq_vjp_bwd``: the argmin is piecewise constant, so
``g_codebook = onehot^T @ g_quantized`` and ``g_flat = onehot @ g_dw``, both
rebuilt from the saved indices. That backward is plain array code in the JAX
package too (no kernel); here each product is computed only when its incoming
gradient exists and its input wants one, and ``onehot @ g_dw`` is the row
gather ``g_dw[indices]`` (the same values: one term a row).

**Flatten semantics.** The reference flattens its (B, C, T) input with
``permute(1, 2, 0).contiguous().view(-1, D)`` (PARITY #1): rows of the
flattened matrix are D consecutive elements of the (C, T, B) buffer, not
per-timestep channel vectors. ``reference_flatten`` is that literal
expression on the port's native (B, C, T) layout.
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.ops._kernels import vq_search_cuda


def reference_flatten(z_bct: torch.Tensor, embedding_dim: int = None):
    """(B, C, T) -> (N, D), the reference's (C, T, B)-order flatten."""
    D = z_bct.shape[1] if embedding_dim is None else embedding_dim
    return z_bct.permute(1, 2, 0).reshape(-1, D)


def reference_unflatten(flat: torch.Tensor, B: int, C: int, T: int):
    """(N, D) -> (B, C, T), inverse of reference_flatten."""
    return flat.reshape(C, T, B).permute(2, 0, 1)


class VQSearchResult(NamedTuple):
    indices: torch.Tensor    # (N,) int32 nearest-code ids
    quantized: torch.Tensor  # (N, D) codebook rows
    counts: torch.Tensor     # (K,) one-hot column sums
    dw: torch.Tensor         # (K, D) onehot^T @ z (EMA numerator update)


def vq_distances(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared-L2 distances (reference formula)."""
    return (flat.square().sum(1, keepdim=True) + codebook.square().sum(1)
            - 2.0 * flat @ codebook.t())


def vq_search_torch(flat: torch.Tensor, codebook: torch.Tensor) -> VQSearchResult:
    """Plain PyTorch search (counterpart of ``vq_search_xla``)."""
    idx = torch.argmin(vq_distances(flat, codebook), dim=1)
    onehot = F.one_hot(idx, codebook.shape[0]).to(flat.dtype)
    return VQSearchResult(idx.to(torch.int32), onehot @ codebook,
                          onehot.sum(0), onehot.t() @ flat)


class VQSearchFunction(torch.autograd.Function):
    """Device-dispatched forward with the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, flat, codebook):
        if flat.is_cuda:
            res = VQSearchResult(*vq_search_cuda(flat.contiguous(),
                                                 codebook.contiguous()))
        elif flat.device.type == "cpu":
            res = vq_search_torch(flat, codebook)
        else:
            raise ValueError(f"vq_search: no path for device {flat.device}")
        ctx.save_for_backward(res.indices)
        ctx.num_embeddings = codebook.shape[0]
        ctx.mark_non_differentiable(res.indices, res.counts)
        # an output nobody differentiated arrives in backward as None, not
        # as a tensor of zeros
        ctx.set_materialize_grads(False)
        return tuple(res)

    @staticmethod
    def backward(ctx, g_idx, g_q, g_counts, g_dw):
        (idx,) = ctx.saved_tensors
        g_flat = g_codebook = None
        # dw = onehot^T @ flat and quantized = onehot @ codebook, argmin fixed
        if g_dw is not None and ctx.needs_input_grad[0]:
            g_flat = g_dw[idx.long()]
        if g_q is not None and ctx.needs_input_grad[1]:
            onehot = F.one_hot(idx.long(), ctx.num_embeddings).to(g_q.dtype)
            g_codebook = onehot.t() @ g_q
        return g_flat, g_codebook


def vq_search(flat: torch.Tensor, codebook: torch.Tensor) -> VQSearchResult:
    """Fused CUDA kernel for CUDA tensors, plain chain for CPU tensors.

    There is no size threshold and no fallback: a CUDA input that the kernel
    refuses (dtype, shape) raises.
    """
    return VQSearchResult(*VQSearchFunction.apply(flat, codebook))
