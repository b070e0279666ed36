"""The hand-written CUDA chain kernels (csrc/fused_resblock.cu) against
their plain PyTorch versions, on the same CUDA tensors.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_resblock_kernel.py

(``--noconftest`` because tests/conftest.py configures JAX). The CUDA cases
skip without a CUDA device.

Tolerance: rtol 1e-4, atol 1e-4 on x and skip at unit-scale inputs: sums of
up to k*C + cin = 1024 f32 terms a layer, in another order than cuBLAS adds
them, through up to 6 layers. The kernels multiply on the tensor cores in
error-compensated TF32 (three TF32 products a f32 product, the accumulator
promoted to rounded f32 sums every two 32-float chunks), which measures
within a few 1e-6 of the plain chains.

The bf16 forms (x, c_up and weights bf16, biases and skip f32; one bf16
wgmma product a product) are held to the plain bf16 chain within
chip_smoke.BF16_SPREAD_MULTIPLE times the spread between two summation
orders of that plain chain, its f32 sums and the same sums correctly
rounded (chip_smoke.bf16_chain_check): x is rounded to bf16 after each
layer, so a different order of f32 sums flips some elements by an ulp and
the flips propagate, and no fixed tolerance separates that from a
defect.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

from vqvae_speech_tpu_torch.ops import _kernels
from vqvae_speech_tpu_torch.ops import fused_resblock as fused

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from chip_smoke import _bf16_chain, bf16_chain_check  # noqa: E402

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
    # G = 64 is one column tile: the split path below half a block an SM
    assert _kernels._fused_chain_launch.last_split == (2 * -(-T // 128) < sms)
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
    with pytest.raises(ValueError, match="1 <= k <= 8"):
        fused.fused_block_chain(
            *chain_inputs(1, 9, 8, 8, 8, 8, 8, seed=0, device=cuda), 1, 9)
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


# ---- the tensor-core main loop and the prepared weights ----

RAGGED = dict(C=20, G=136, S=12, cin=19)     # off every tile of the kernel


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(64, 128, 32), (128, 128, 64),
                                   (200, 136, 100), (77, 12, 19),
                                   (4096, 512, 464), (1, 8, 8)])
def test_main_loop_matches_matmul(cuda, M, N, K):
    """One bare product through the wgmma main loop against torch.matmul in
    f32 (TF32 off): the operand layouts and the descriptor are right."""
    rng = np.random.default_rng(M + N + K)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.standard_normal((K, N)) / math.sqrt(K))
                         .astype(np.float32)).to(cuda)
    b_t = torch.nn.functional.pad(b.t().contiguous(), (0, -K % 8))
    hi, lo = (t.contiguous() for t in fused.split_tf32(b_t))
    got = _kernels.tf32x3_matmul_cuda(a, hi, lo)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, a @ b, rtol=1e-5, atol=1e-5)
    # one TF32 product (the lo part dropped) is visibly worse at depth
    if K >= 64:
        coarse = _kernels.tf32x3_matmul_cuda(fused.split_tf32(a)[0], hi,
                                             torch.zeros_like(lo))
        exact = a.double() @ b.double()
        assert ((coarse.double() - exact).abs().max()
                > 10 * (got.double() - exact).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,widths", [
    (6, 3, dict(C=128, G=256, S=128, cin=80)), (3, 2, RAGGED),
    (2, 1, RAGGED), (2, 3, dict(C=256, G=256, S=256, cin=640))])
def test_prepared_weights_match_the_plain_layout(cuda, L, k, widths):
    """The kernel's transposing split pass against the same layout built
    with tensor operations, bit for bit."""
    _, _, stacked = chain_inputs(L, k, 8, widths["C"], widths["G"],
                                 widths["S"], widths["cin"], seed=L, device=cuda)
    prepared = fused.prepare_block_chain(stacked)
    want = fused.prepared_chain_weights_torch(stacked)
    torch.cuda.synchronize()
    assert torch.equal(prepared.wgate, want["wgate"])
    assert torch.equal(prepared.wproj, want["wproj"])
    assert prepared.nbytes == 4 * (want["wgate"].numel()
                                   + want["wproj"].numel())
    assert fused.prepare_block_chain(prepared) is prepared


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rows", "split"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 5119])
def test_tensor_core_loop_at_ragged_shapes(cuda, T, k, path):
    """Rows off the 64- and 128-row tiles and widths off every column tile
    and chunk (C=20, G=136, S=12, cin=19, an unaligned conditioning row),
    causal and non-causal, on both decompositions."""
    x, c, stacked = chain_inputs(3, k, T, seed=T + k, device=cuda, **RAGGED)
    prepared = fused.prepare_block_chain(stacked)
    causal = fused.fused_block_chain_torch(x, c, stacked, 3, k)
    assert_matches(_kernels.fused_block_chain_tiled_cuda(x, c, prepared,
                                                         path=path), causal)
    assert _kernels._fused_chain_launch.last_split == (path == "split")
    assert_matches(_kernels.fused_block_chain_cuda(x, c, prepared, path=path),
                   causal)
    assert_matches(
        _kernels.fused_block_chain_nc_cuda(x, c, prepared, (1, 2, 4),
                                           path=path),
        fused.fused_block_chain_nc_torch(x, c, stacked, 3, k, (1, 2, 4)))


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,T,widths,dilations", [
    (6, 3, 20480, dict(C=128, G=256, S=128, cin=80), None),
    (2, 3, 1280, dict(C=256, G=256, S=256, cin=640), (1, 2)),
    (3, 2, 129, RAGGED, (1, 2, 4))])
def test_prepared_chain_equals_bare_call_and_repeats(cuda, L, k, T, widths,
                                                     dilations):
    """A chain bound once gives the bare-``stacked`` call's bits, and 20
    runs agree bit for bit."""
    x, c, stacked = chain_inputs(L, k, T, seed=T, device=cuda, **widths)
    prepared = fused.prepare_block_chain(stacked)
    if dilations is None:
        def run(w):
            return fused.fused_block_chain_tiled(x, c, w, L, k)
    else:
        def run(w):
            return fused.fused_block_chain_nc(x, c, w, L, k, dilations)
    bare = run(stacked)
    runs = [run(prepared) for _ in range(20)]
    torch.cuda.synchronize()
    for got in runs:
        for g, b in zip(got, bare):
            assert torch.equal(g, b)


@pytest.mark.cuda
def test_chains_run_on_a_side_stream(cuda):
    x, c, stacked = chain_inputs(6, 3, 4096, 128, 256, 128, 80, seed=3,
                                 device=cuda)
    prepared = fused.prepare_block_chain(stacked)
    want = fused.fused_block_chain_tiled(x, c, prepared, 6, 3)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        bound = fused.prepare_block_chain(stacked)     # prepared on the stream
        got = fused.fused_block_chain_tiled(x, c, bound, 6, 3)
        nc = fused.fused_block_chain_nc(x, c, bound, 6, 3, (1, 2, 4, 8, 1, 2))
    side.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert_matches(nc, fused.fused_block_chain_nc_torch(
        x, c, stacked, 6, 3, (1, 2, 4, 8, 1, 2)))


# ---- the bf16 forms ----


def bf16_inputs(L, k, T, C, G, S, cin, seed, device):
    """chain_inputs with x, c_up and the weights rounded to bf16 (the
    biases stay f32), as stack_block_weights(compute_dtype=bf16) gives
    them."""
    return _bf16_chain(*chain_inputs(L, k, T, C, G, S, cin, seed, device))


def check_bf16(name, got, x, c, stacked, L, k, dilations=None):
    """got against the plain bf16 chain within the spread of two orders."""
    causal = dilations is None
    want = fused.fused_block_chain_bf16_torch(x, c, stacked, L, k, dilations,
                                              causal=causal)
    other = fused.fused_block_chain_bf16_torch(x, c, stacked, L, k, dilations,
                                               causal=causal, exact=True)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    bf16_chain_check(name, got, want, other)


BF16_CASES = [
    # L, k, T, C, G, S, cin, dilations (None: causal, k**l)
    (6, 3, 20480, 128, 256, 128, 80, None),   # the student chain, row-tiled
    (6, 3, 5119, 128, 256, 128, 80, None),    # odd T
    (6, 3, 4096, 128, 256, 128, 80, None),
    (2, 3, 10240, 256, 256, 256, 80, (1, 2)),     # flow block 0
    (2, 3, 1280, 256, 256, 256, 640, (1, 2)),     # block 3, split path
    (2, 3, 81, 256, 256, 256, 10240, (1, 2)),     # block 7, ragged T
    (3, 2, 77, 16, 32, 16, 8, None),
    (4, 3, 20, 16, 32, 16, 8, None),          # shorter than its reach
    (3, 5, 300, 24, 72, 40, 19, None),        # k = 5, ragged widths
    (4, 3, 160, 16, 32, 16, 8, (1, 2, 4, 8)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,T,C,G,S,cin,dilations", BF16_CASES)
def test_bf16_kernels_match_plain_within_the_spread(cuda, L, k, T, C, G, S,
                                                    cin, dilations):
    x, c, stacked = bf16_inputs(L, k, T, C, G, S, cin, seed=T + k,
                                device=cuda)
    if dilations is None:
        for run in (fused.fused_block_chain_tiled, fused.fused_block_chain):
            check_bf16(f"{run.__name__} T={T}", run(x, c, stacked, L, k),
                       x, c, stacked, L, k)
    else:
        check_bf16(f"nc T={T}", fused.fused_block_chain_nc(
            x, c, stacked, L, k, dilations), x, c, stacked, L, k, dilations)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rows", "split"])
@pytest.mark.parametrize("T", [1, 63, 129, 5119])
def test_bf16_kernels_at_ragged_shapes_on_both_paths(cuda, T, path):
    """Rows off every tile; C=20 and G=136 rows not 16-byte multiples in
    bf16 and cin=19 (their rows copied an element at a time); both
    decompositions; bit-equal run to run."""
    x, c, stacked = bf16_inputs(3, 3, T, seed=T, device=cuda, **RAGGED)
    prepared = fused.prepare_block_chain(stacked)
    runs = [_kernels.fused_block_chain_tiled_bf16_cuda(x, c, prepared,
                                                       path=path)
            for _ in range(2)]
    assert _kernels._fused_chain_launch.last_split == (path == "split")
    check_bf16(f"tiled {path} T={T}", runs[0], x, c, stacked, 3, 3)
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)
    check_bf16(f"chain {path} T={T}",
               _kernels.fused_block_chain_bf16_cuda(x, c, prepared, path=path),
               x, c, stacked, 3, 3)
    check_bf16(f"nc {path} T={T}",
               _kernels.fused_block_chain_nc_bf16_cuda(x, c, prepared,
                                                       (1, 2, 4), path=path),
               x, c, stacked, 3, 3, (1, 2, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(64, 128, 64), (200, 136, 104),
                                   (4096, 512, 464), (1, 8, 8), (77, 12, 24)])
def test_bf16_main_loop_matches_matmul(cuda, M, N, K):
    """One bare bf16 product through the main loop against torch.matmul of
    the same values in f32 (TF32 off): bf16 products are exact in f32, so
    only the summation order differs."""
    rng = np.random.default_rng(M + N + K)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(cuda).bfloat16()
    b = torch.from_numpy((rng.standard_normal((N, K)) / math.sqrt(K))
                         .astype(np.float32)).to(cuda).bfloat16()
    got = _kernels.bf16_matmul_cuda(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, a.float() @ b.float().t(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,widths", [
    (6, 3, dict(C=128, G=256, S=128, cin=80)), (3, 2, RAGGED),
    (2, 3, dict(C=256, G=256, S=256, cin=640))])
def test_bf16_prepared_weights_match_the_plain_layout(cuda, L, k, widths):
    _, _, stacked = bf16_inputs(L, k, 8, widths["C"], widths["G"],
                                widths["S"], widths["cin"], seed=L,
                                device=cuda)
    prepared = fused.prepare_block_chain(stacked)
    want = fused.prepared_chain_weights_torch(stacked)
    torch.cuda.synchronize()
    assert prepared.dtype == torch.bfloat16
    assert torch.equal(prepared.wgate, want["wgate"])
    assert torch.equal(prepared.wproj, want["wproj"])
    assert prepared.nbytes == 2 * (want["wgate"].numel()
                                   + want["wproj"].numel())


@pytest.mark.cuda
def test_bf16_kernels_count_launches_and_refuse_mixed_dtypes(cuda):
    x, c, stacked = bf16_inputs(6, 3, 2049, 128, 256, 128, 80, seed=1,
                                device=cuda)
    bf16 = (_kernels.fused_block_chain_tiled_bf16_cuda,
            _kernels.fused_block_chain_bf16_cuda,
            _kernels.fused_block_chain_nc_bf16_cuda)
    f32 = (_kernels.fused_block_chain_tiled_cuda,
           _kernels.fused_block_chain_cuda,
           _kernels.fused_block_chain_nc_cuda)
    before = [w.launches for w in bf16 + f32]
    a = fused.fused_block_chain_tiled(x, c, stacked)
    b = fused.fused_block_chain_tiled(x, c, stacked)
    fused.fused_block_chain(x, c, stacked)
    fused.fused_block_chain_nc(x, c, stacked, 6, 3, (1, 2, 4, 8, 1, 2))
    assert [w.launches for w in bf16 + f32] == [
        before[0] + 2, before[1] + 1, before[2] + 1, *before[3:]]
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    f32_weights = {n: w.float() for n, w in stacked.items()}
    with pytest.raises(ValueError, match="one dtype"):
        fused.fused_block_chain_tiled(x, c, f32_weights)
    with pytest.raises(ValueError, match="one dtype"):
        fused.fused_block_chain_tiled(x, c.float(), stacked)
    with pytest.raises(ValueError, match="bfloat16 weights"):
        _kernels.fused_block_chain_tiled_bf16_cuda(x.float(), c.float(),
                                                   f32_weights)
    with pytest.raises(ValueError, match="float32 weights"):
        _kernels.fused_block_chain_tiled_cuda(x, c, stacked)


# ---- the bf16 kernels' two decompositions (one cooperative launch a layer
# on the row-tiled path, one a chain on the split path) ----

BF16_WIDTHS = {
    # the "deep dilations" shape: 16-byte rows, every source through TMA
    "deep": dict(L=4, C=16, G=32, S=16, cin=8),
    # rows of 40 and 38 bytes: x and c_up copied by the producer's threads
    "ragged": dict(L=3, **RAGGED),
}


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(BF16_WIDTHS))
@pytest.mark.parametrize("path", ["auto", "rows", "split"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 80, 81, 129, 5119])
def test_bf16_decompositions_at_every_tile_edge(cuda, T, k, path, widths):
    """The causal and the non-causal bf16 chain on each decomposition at row
    counts around the 128-row tile, held by bf16_chain_check; bit-equal run
    to run; one wrapper launch a chain and last_split as the path says."""
    w = dict(BF16_WIDTHS[widths])
    L = w.pop("L")
    x, c, stacked = bf16_inputs(L, k, T, seed=T * 7 + k, device=cuda, **w)
    prepared = fused.prepare_block_chain(stacked)
    dil = tuple(2 ** i for i in range(L))
    for wrapper, dilations in (
            (_kernels.fused_block_chain_tiled_bf16_cuda, None),
            (_kernels.fused_block_chain_nc_bf16_cuda, dil)):
        extra = () if dilations is None else (dilations,)
        before = wrapper.launches
        runs = [wrapper(x, c, prepared, *extra, path=path) for _ in range(2)]
        assert wrapper.launches == before + 2
        if path != "auto":
            assert _kernels._fused_chain_launch.last_split == (path == "split")
        check_bf16(f"{wrapper.__name__} {path} T={T} k={k}", runs[0], x, c,
                   stacked, L, k, dilations)
        for u, v in zip(*runs):
            assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rows", "split"])
def test_bf16_chains_run_on_a_side_stream(cuda, path):
    x, c, stacked = bf16_inputs(2, 3, 1280, 256, 256, 256, 640, seed=5,
                                device=cuda)
    prepared = fused.prepare_block_chain(stacked)
    want = _kernels.fused_block_chain_nc_bf16_cuda(x, c, prepared, (1, 2),
                                                   path=path)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        bound = fused.prepare_block_chain(stacked)
        got = _kernels.fused_block_chain_nc_bf16_cuda(x, c, bound, (1, 2),
                                                      path=path)
    side.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_bf16_kernels_refuse_what_they_cannot_take(cuda):
    x, c, stacked = bf16_inputs(2, 3, 80, 16, 32, 16, 8, seed=2, device=cuda)
    prepared = fused.prepare_block_chain(stacked)
    wrapper = _kernels.fused_block_chain_nc_bf16_cuda
    with pytest.raises(ValueError, match="path"):
        wrapper(x, c, prepared, (1, 2), path="fused")
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(x.t().contiguous().t(), c, prepared, (1, 2))
    with pytest.raises(ValueError, match="bfloat16"):
        wrapper(x, c.float(), prepared, (1, 2))
    with pytest.raises(ValueError, match="positive dilations"):
        wrapper(x, c, prepared, (1, 0))
    with pytest.raises(ValueError, match="k <= 8"):
        fused.prepare_block_chain(bf16_inputs(1, 9, 8, 8, 8, 8, 8, seed=0,
                                              device=cuda)[2])
    with pytest.raises(ValueError, match="16-byte aligned"):
        wrapper(_offset_view(x), c, prepared, (1, 2))


def test_scratch_plan_names_the_form():
    """The scratch and path query passes the weights' form to the library
    (the bf16 kernels size their scratch and choose their path by their own
    rule) and is asked once a (T, path): checked on the CPU against a
    stand-in for the library."""
    import ctypes

    calls = []

    def plan(T, C, G, cin, L, k, path, bf16, floats, split):
        calls.append((T, C, G, cin, L, k, path, bf16))
        floats._obj.value = 1000 + bf16
        split._obj.value = path == 2
        return 0

    class Lib:
        fused_chain_scratch_floats = staticmethod(plan)

    lib = type("Bound", (), {})()
    for name in ("fused_chain_scratch_floats", "fused_chain_prepare_f32",
                 "fused_chain_prepare_bf16", "fused_chain_matmul_f32",
                 "fused_chain_matmul_bf16", "fused_chain_f32",
                 "fused_chain_tiled_f32", "fused_chain_nc_f32",
                 "fused_chain_bf16", "fused_chain_tiled_bf16",
                 "fused_chain_nc_bf16"):
        setattr(lib, name, type("Fn", (), {})())
    _kernels._bind_fused_resblock(lib)
    assert lib.fused_chain_scratch_floats.argtypes == (
        [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_size_t),
                              ctypes.POINTER(ctypes.c_int)])
    for dtype, form in ((torch.bfloat16, 1), (torch.float32, 0)):
        chain = _kernels.PreparedFusedChain.__new__(_kernels.PreparedFusedChain)
        chain.dims = dict(L=2, k=3, C=16, G=32, S=16, cin=8)
        chain.dtype, chain._lib, chain._plans = dtype, Lib(), {}
        del calls[:]
        assert chain._plan("name", 80, 2) == (1000 + form, True)
        assert chain._plan("name", 80, 2) == (1000 + form, True)
        assert chain._plan("name", 80, 1) == (1000 + form, False)
        assert calls == [(80, 16, 32, 8, 2, 3, 2, form),
                         (80, 16, 32, 8, 2, 3, 1, form)]
