"""The hand-written CUDA codebook search (csrc/vq_search.cu) against its
plain PyTorch version, on the same CUDA tensors.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_vq_kernel.py

(``--noconftest`` because tests/conftest.py configures JAX). The CUDA cases
skip without a CUDA device.

Tolerances: an index may differ from the plain search only at a near-tie,
where the two distances are within 1e-5 * (||z||^2 + 1) (the two sum in
another f32 order); quantized rows are exact copies; counts exact; dw within
rtol 1e-4 / atol 1e-4, the JAX package's own bound (tests/test_vq.py).
"""
import numpy as np
import pytest
import torch

from vqvae_speech_tpu_torch.ops import vq_search, vq_search_torch
from vqvae_speech_tpu_torch.ops._kernels import vq_search_cuda
from vqvae_speech_tpu_torch.ops.vq import vq_distances


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(N, K, D, seed, device):
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((N, D)).astype(np.float32)
    cb = rng.standard_normal((K, D)).astype(np.float32)
    return (torch.from_numpy(flat).to(device), torch.from_numpy(cb).to(device))


def _assert_matches_plain(flat, cb):
    got, want = vq_search(flat, cb), vq_search_torch(flat, cb)
    torch.cuda.synchronize()
    assert got.indices.dtype == torch.int32 and got.indices.is_cuda
    diff = (got.indices != want.indices).nonzero().flatten()
    d = vq_distances(flat[diff], cb)
    gap = (d.gather(1, got.indices[diff, None].long())
           - d.gather(1, want.indices[diff, None].long())).abs()
    assert bool((gap <= 1e-5 * (flat[diff].square().sum(1, keepdim=True) + 1))
                .all())
    torch.testing.assert_close(got.quantized, cb[got.indices.long()],
                               rtol=0, atol=0)
    if len(diff) == 0:
        torch.testing.assert_close(got.counts, want.counts, rtol=0, atol=0)
        torch.testing.assert_close(got.dw, want.dw, rtol=1e-4, atol=1e-4)
    return len(diff)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,D", [
    (1, 44, 64),         # one row, a tile that is mostly padding
    (1536, 44, 64),      # the server's flagship launch
    (24576, 44, 64),     # bench.py's batch 1024 x 24 rows
    (1536, 1000, 64),    # codebook larger than a block's shared memory
    (77, 5, 16),         # K below the 8 warps; N not a multiple of 32
    (300, 3, 200),       # D not a multiple of 32 (stats column slices)
    (40, 11, 1024),      # > 48 KB of dynamic shared memory
])
def test_kernel_matches_plain(cuda, N, K, D):
    flat, cb = _inputs(N, K, D, seed=N + K + D, device=cuda)
    assert _assert_matches_plain(flat, cb) == 0


@pytest.mark.cuda
def test_exact_tie_takes_the_first_index(cuda):
    """Duplicate codebook rows give bit-equal distances: argmin's first
    index wins, across the kernel's warp partition too."""
    flat, cb = _inputs(256, 44, 64, seed=1, device=cuda)
    cb[37] = cb[2]
    cb[9] = cb[2]
    flat[:64] = cb[2] + 1e-3 * flat[:64]
    got = vq_search(flat, cb)
    assert bool((got.indices[:64] == 2).all())
    assert _assert_matches_plain(flat, cb) == 0


@pytest.mark.cuda
def test_backward_on_cuda_matches_plain_autograd(cuda):
    flat, cb = _inputs(600, 29, 16, seed=7, device=cuda)
    grads = []
    for search in (vq_search, vq_search_torch):
        f = flat.clone().requires_grad_()
        c = cb.clone().requires_grad_()
        res = search(f, c)
        (res.quantized.square().sum() + 0.5 * (res.dw * res.dw).sum()).backward()
        grads.append((f.grad, c.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_launch_counter_and_no_fallback(cuda):
    flat, cb = _inputs(64, 44, 64, seed=2, device=cuda)
    before = vq_search_cuda.launches
    vq_search(flat, cb)
    assert vq_search_cuda.launches == before + 1
    vq_search_torch(flat, cb)
    assert vq_search_cuda.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        vq_search(flat.half(), cb.half())


def test_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the CPU path is the
    dispatching vq_search's plain chain."""
    flat, cb = _inputs(8, 4, 16, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        vq_search_cuda(flat, cb)
    got, want = vq_search(flat, cb), vq_search_torch(flat, cb)
    torch.testing.assert_close(got.indices, want.indices, rtol=0, atol=0)
