"""The hand-written CUDA chain kernels (csrc/fused_resblock.cu) against
their plain PyTorch versions, on the same CUDA tensors.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_resblock_kernel.py

(``--noconftest`` because tests/conftest.py configures JAX). The CUDA cases
skip without a CUDA device.

Tolerance: rtol 1e-4, atol 1e-4 on x and skip at unit-scale inputs: sums of
up to k*C + cin = 1024 f32 terms a layer, in another order than cuBLAS adds
them, through up to 6 layers.
"""
import math

import numpy as np
import pytest
import torch

from vqvae_speech_tpu_torch.ops import _kernels
from vqvae_speech_tpu_torch.ops import fused_resblock as fused

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def chain_inputs(L, k, T, C, G, S, cin, seed, device):
    """Unit-scale x and c_up; weights scaled by 1/sqrt(fan-in), as a
    weight-normed init gives them."""
    rng = np.random.default_rng(seed)

    def f(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    fan = 1 / math.sqrt(k * C + cin)
    stacked = dict(
        wf=f((L, k, C, G), fan), wg=f((L, k, C, G), fan),
        wfc=f((L, cin, G), fan), wgc=f((L, cin, G), fan),
        wres=f((L, G, C), 1 / math.sqrt(G)),
        wskip=f((L, G, S), 1 / math.sqrt(G)),
        bf=f((L, G), 0.1), bg=f((L, G), 0.1), bres=f((L, C), 0.1),
        bskip=f((L, S), 0.1))
    return f((T, C)), f((T, cin)), stacked


def assert_matches(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_cuda
        torch.testing.assert_close(g, w, **TOL)


CAUSAL = [
    # L, k, T, C, G, S, cin
    (6, 3, 4096, 128, 256, 128, 80),   # the IAF student's chain
    (6, 3, 20480, 128, 256, 128, 80),  # its longest bucket: the row-tiled path
    (6, 3, 1001, 128, 256, 128, 80),   # odd T
    (3, 2, 77, 16, 32, 16, 8),         # k = 2, the CPU tests' widths
    (4, 3, 20, 16, 32, 16, 8),         # shorter than its reach (lags to 54)
    (2, 1, 130, 20, 36, 12, 5),        # k = 1; widths off the tile sizes
    (3, 5, 300, 24, 72, 40, 19),       # k = 5, dilations 1, 5, 25
    (1, 3, 64, 8, 8, 4, 1),            # one layer: no ping-pong
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,T,C,G,S,cin", CAUSAL)
def test_causal_kernels_match_plain(cuda, L, k, T, C, G, S, cin):
    x, c, stacked = chain_inputs(L, k, T, C, G, S, cin, seed=L + k + T,
                                 device=cuda)
    want = fused.fused_block_chain_torch(x, c, stacked, L, k)
    assert_matches(fused.fused_block_chain_tiled(x, c, stacked, L, k), want)
    assert_matches(fused.fused_block_chain(x, c, stacked, L, k), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dilations,k,T,C,G,S,cin", [
    ((1, 2), 3, 10240, 256, 256, 256, 80),     # FloWaveNet block 0
    ((1, 2), 3, 1280, 256, 256, 256, 640),     # block 3
    ((1, 2), 3, 83, 16, 32, 16, 8),
    ((1, 2, 4, 8), 3, 160, 16, 32, 16, 8),     # the deep-dilation case
    ((4, 1, 16), 3, 50, 16, 32, 16, 8),
    ((1, 2), 5, 131, 12, 20, 8, 3),
    ((3,), 3, 2, 8, 8, 8, 2),                  # taps wholly outside [0, T)
])
def test_nc_kernel_matches_plain(cuda, dilations, k, T, C, G, S, cin):
    L = len(dilations)
    x, c, stacked = chain_inputs(L, k, T, C, G, S, cin, seed=T + k,
                                 device=cuda)
    want = fused.fused_block_chain_nc_torch(x, c, stacked, L, k, dilations)
    assert_matches(
        fused.fused_block_chain_nc(x, c, stacked, L, k, dilations), want)


@pytest.mark.cuda
@pytest.mark.parametrize("block", range(8))
def test_nc_kernel_matches_plain_at_the_flow_block_shapes(cuda, block):
    """FloWaveNet's eight coupling shapes (T = 10240 / 2**i rows against
    conditioning 80 * 2**i wide) at a quarter of the channel width, each on
    the path its row count gives it."""
    T, cin = 10240 >> block, 80 << block
    x, c, stacked = chain_inputs(2, 3, T, 64, 64, 64, cin, seed=block,
                                 device=cuda)
    want = fused.fused_block_chain_nc_torch(x, c, stacked, 2, 3, (1, 2))
    got = fused.fused_block_chain_nc(x, c, stacked, 2, 3, (1, 2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert _kernels._fused_chain_launch.last_split == (-(-T // 64) <= 2 * sms)
    assert_matches(got, want)
    again = fused.fused_block_chain_nc(x, c, stacked, 2, 3, (1, 2))
    torch.cuda.synchronize()
    for u, v in zip(got, again):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rows", "split"])
@pytest.mark.parametrize("T", [1, 63, 64, 80, 81, 129])
def test_both_decompositions_match_plain(cuda, T, path):
    """Either side of the small-T switch, forced: within TOL of the plain
    chains and bit-equal run to run, at rows off every tile size and a
    conditioning width that is no multiple of a 16-row slice."""
    x, c, stacked = chain_inputs(3, 3, T, 24, 72, 40, 19, seed=T, device=cuda)
    runs = [_kernels.fused_block_chain_nc_cuda(x, c, stacked, (1, 2, 4),
                                               path=path) for _ in range(2)]
    assert _kernels._fused_chain_launch.last_split == (path == "split")
    assert_matches(runs[0], fused.fused_block_chain_nc_torch(
        x, c, stacked, 3, 3, (1, 2, 4)))
    for u, v in zip(*runs):
        assert torch.equal(u, v)
    causal = fused.fused_block_chain_torch(x, c, stacked, 3, 3)
    assert_matches(_kernels.fused_block_chain_tiled_cuda(x, c, stacked,
                                                         path=path), causal)
    assert_matches(_kernels.fused_block_chain_cuda(x, c, stacked, path=path),
                   causal)


@pytest.mark.cuda
def test_split_path_at_the_last_flow_block_width(cuda):
    """Flow block 7 at full width (T=80, cin=10240) and a ragged T beside
    it: the pre-pass splits its 10240-deep reduction over many blocks."""
    for T in (80, 81):
        x, c, stacked = chain_inputs(2, 3, T, 256, 256, 256, 10240, seed=T,
                                     device=cuda)
        got = fused.fused_block_chain_nc(x, c, stacked, 2, 3, (1, 2))
        assert _kernels._fused_chain_launch.last_split
        assert_matches(got, fused.fused_block_chain_nc_torch(
            x, c, stacked, 2, 3, (1, 2)))


@pytest.mark.cuda
def test_kernels_are_deterministic_and_count_launches(cuda):
    x, c, stacked = chain_inputs(6, 3, 2049, 128, 256, 128, 80, seed=1,
                                 device=cuda)
    wrappers = (_kernels.fused_block_chain_tiled_cuda,
                _kernels.fused_block_chain_cuda,
                _kernels.fused_block_chain_nc_cuda)
    before = [w.launches for w in wrappers]
    a = fused.fused_block_chain_tiled(x, c, stacked)
    b = fused.fused_block_chain_tiled(x, c, stacked)
    assert [w.launches for w in wrappers] == [before[0] + 2, before[1],
                                              before[2]]
    fused.fused_block_chain(x, c, stacked)
    nc = [fused.fused_block_chain_nc(x, c, stacked, 6, 3, (1, 2, 4, 8, 1, 2))
          for _ in range(2)]
    fused.fused_block_chain_tiled_torch(x, c, stacked)
    assert [w.launches for w in wrappers] == [before[0] + 2, before[1] + 1,
                                              before[2] + 2]
    torch.cuda.synchronize()
    for u, v in zip(a + nc[0], b + nc[1]):
        assert torch.equal(u, v)
    # the inputs are left as they were (x ping-pongs through scratch)
    x2, _, _ = chain_inputs(6, 3, 2049, 128, 256, 128, 80, seed=1,
                            device=cuda)
    assert torch.equal(x, x2)


def _offset_view(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    x, c, stacked = chain_inputs(2, 3, 40, 16, 32, 16, 8, seed=0, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused.fused_block_chain_tiled(x.double(), c, stacked, 2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_block_chain_tiled(x.t().contiguous().t(), c, stacked, 2, 3)
    with pytest.raises(ValueError, match="shape"):
        fused.fused_block_chain_tiled(x, c[:-1], stacked, 2, 3)
    with pytest.raises(ValueError, match="wf must be 16-byte"):
        fused.fused_block_chain_tiled(
            x, c, dict(stacked, wf=_offset_view(stacked["wf"])), 2, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_block_chain_nc(x, c.cpu(), stacked, 2, 3, (1, 2))
    with pytest.raises(ValueError, match="path must be one of"):
        _kernels.fused_block_chain_nc_cuda(x, c, stacked, (1, 2), path="tiles")
    with pytest.raises(ValueError, match="positive dilations"):
        fused.fused_block_chain_nc(x, c, stacked, 2, 3, (1, 0))
    with pytest.raises(ValueError, match="multiples of 4"):
        fused.fused_block_chain(
            *chain_inputs(2, 3, 40, 18, 32, 16, 8, seed=0, device=cuda), 2, 3)
    with pytest.raises(ValueError, match="shared memory"):
        fused.fused_block_chain(
            *chain_inputs(1, 1, 8, 8, 4096, 8, 8, seed=0, device=cuda), 1, 1)
    # the conditioning is read one float at a time: any contiguous view
    want = fused.fused_block_chain_torch(x, c, stacked, 2, 3)
    assert_matches(fused.fused_block_chain(x, _offset_view(c), stacked, 2, 3),
                   want)


def test_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only; the CPU path is the
    dispatching functions' plain chain, which launches nothing."""
    x, c, stacked = chain_inputs(2, 3, 40, 16, 32, 16, 8, seed=0, device="cpu")
    for wrapper in (_kernels.fused_block_chain_tiled_cuda,
                    _kernels.fused_block_chain_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(x, c, stacked)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.fused_block_chain_nc_cuda(x, c, stacked, (1, 2))
    before = (_kernels.fused_block_chain_tiled_cuda.launches,
              _kernels.fused_block_chain_cuda.launches,
              _kernels.fused_block_chain_nc_cuda.launches)
    got = fused.fused_block_chain_tiled(x, c, stacked, 2, 3)
    want = fused.fused_block_chain_tiled_torch(x, c, stacked, 2, 3)
    fused.fused_block_chain(x, c, stacked, 2, 3)
    fused.fused_block_chain_nc(x, c, stacked, 2, 3, (1, 2))
    assert before == (_kernels.fused_block_chain_tiled_cuda.launches,
                      _kernels.fused_block_chain_cuda.launches,
                      _kernels.fused_block_chain_nc_cuda.launches)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
