"""The hand-written CUDA decode-step kernel (csrc/wavenet_step.cu) against
its plain PyTorch version, on the same CUDA tensors.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_wavenet_kernel.py

(``--noconftest`` because tests/conftest.py configures JAX). The CUDA cases
skip without a CUDA device.

Tolerance: rtol 1e-4 (the JAX package's own bound for its kernel,
tests/test_wavenet_step.py) and atol 1e-4 on x, skip and x_all: up to
k*C = 2304 f32 terms per sum, added in another order than cuBLAS adds them.
"""
import math

import numpy as np
import pytest
import torch

from vqvae_speech_tpu_torch.ops import (
    glu_stack_step,
    glu_stack_step_torch,
    prepare_glu_stack_step,
)
from vqvae_speech_tpu_torch.ops._kernels import (
    PreparedWaveNetStep,
    wavenet_step_cuda,
)

WEIGHTS = ("wtap", "bias", "wskip", "bskip", "wout", "bout")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def stack_inputs(L, k, B, C, G, S, seed, device):
    """Unit-scale x0, taps and cond; weights scaled by 1/sqrt(fan-in), as a
    weight-normed init gives them."""
    rng = np.random.default_rng(seed)

    def f(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    return dict(
        x0=f((B, C)), taps=f((L, k - 1, B, C)), cond=f((L, B, G)),
        wtap=f((L, k, C, G), 1 / math.sqrt(k * C)), bias=f((L, G), 0.1),
        wskip=f((L, G // 2, S), 1 / math.sqrt(G // 2)), bskip=f((L, S), 0.1),
        wout=f((L, G // 2, C), 1 / math.sqrt(G // 2)), bout=f((L, C), 0.1))


def assert_kernel_matches_plain(args, legacy):
    got = glu_stack_step(legacy=legacy, **args)
    want = glu_stack_step_torch(legacy=legacy, **args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_cuda
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    return max((g - w).abs().max().item() for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,B,C,G,S,legacy", [
    (20, 3, 1, 768, 768, 256, True),     # vctk_wavenet, one stream
    (20, 3, 8, 768, 768, 256, True),     # vctk_wavenet, the server's batch
    (20, 3, 8, 768, 768, 256, False),
    (20, 2, 2, 768, 768, 256, True),     # k = 2
    (4, 3, 1, 16, 32, 8, False),         # the JAX test's widths
    (6, 2, 2, 16, 32, 8, True),
    (3, 3, 5, 20, 136, 12, True),        # ragged tiles, B not a power of 2
    (2, 1, 3, 64, 64, 64, True),         # k = 1: no history taps
    (3, 3, 32, 128, 256, 132, False),    # the largest batch
])
def test_kernel_matches_plain(cuda, L, k, B, C, G, S, legacy):
    args = stack_inputs(L, k, B, C, G, S, seed=L + k + B, device=cuda)
    assert_kernel_matches_plain(args, legacy)


@pytest.mark.cuda
@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 2, 3, 8, 17, 32])
@pytest.mark.parametrize("C,G,S", [
    (64, 128, 64),     # whole tiles
    (20, 136, 12),     # narrow and ragged: 68 pairs, slices of uneven rows
])
def test_kernel_batches_taps_and_legacy(cuda, C, G, S, B, k, legacy):
    args = stack_inputs(3, k, B, C, G, S, seed=B * 7 + k, device=cuda)
    assert_kernel_matches_plain(args, legacy)


@pytest.mark.cuda
@pytest.mark.parametrize("L,k,B,C,G,S", [
    (20, 3, 8, 768, 768, 256),    # the server's shape
    (20, 3, 32, 768, 768, 256),   # the largest batch
    (5, 3, 3, 20, 136, 12),       # narrow and ragged
])
def test_kernel_is_bit_equal_over_twenty_runs(cuda, L, k, B, C, G, S):
    """Blocks read what other blocks wrote in the same launch; a stale read
    would show as a run that differs."""
    args = stack_inputs(L, k, B, C, G, S, seed=11, device=cuda)
    step = prepare_glu_stack_step(*(args[n] for n in WEIGHTS), batch=B,
                                  legacy=True)
    first = [t.clone() for t in step(args["x0"], args["taps"], args["cond"])]
    for _ in range(19):
        again = step(args["x0"], args["taps"], args["cond"])
        torch.cuda.synchronize()
        for u, v in zip(first, again):
            assert torch.equal(u, v)


@pytest.mark.cuda
def test_prepared_step_equals_glu_stack_step_and_reuses_its_buffers(cuda):
    args = stack_inputs(6, 3, 5, 128, 256, 132, seed=2, device=cuda)
    other = stack_inputs(6, 3, 5, 128, 256, 132, seed=3, device=cuda)
    step = prepare_glu_stack_step(*(args[n] for n in WEIGHTS), batch=5,
                                  legacy=True)
    assert isinstance(step, PreparedWaveNetStep)
    before = wavenet_step_cuda.launches
    got = step(args["x0"], args["taps"], args["cond"])
    assert wavenet_step_cuda.launches == before + 1
    want = glu_stack_step(legacy=True, **args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the next call overwrites the same three buffers
    ptrs = [t.data_ptr() for t in got]
    again = step(other["x0"], other["taps"], other["cond"])
    assert [t.data_ptr() for t in again] == ptrs
    want = glu_stack_step(legacy=True, **dict(
        args, x0=other["x0"], taps=other["taps"], cond=other["cond"]))
    for g, w in zip(again, want):
        assert torch.equal(g, w)
    info = step.describe()
    assert 1 <= info["blocks"] <= torch.cuda.get_device_properties(
        cuda).multi_processor_count * 2
    with pytest.raises(ValueError, match="shape"):
        step(args["x0"][:4].contiguous(), args["taps"], args["cond"])
    with pytest.raises(ValueError, match="float32"):
        step(args["x0"].double(), args["taps"], args["cond"])


@pytest.mark.cuda
def test_kernel_runs_on_a_side_stream(cuda):
    args = stack_inputs(4, 3, 2, 64, 128, 64, seed=4, device=cuda)
    want = glu_stack_step_torch(legacy=False, **args)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = glu_stack_step(legacy=False, **args)
    side.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_is_deterministic_and_counts_launches(cuda):
    args = stack_inputs(20, 3, 8, 768, 768, 256, seed=3, device=cuda)
    before = wavenet_step_cuda.launches
    a = glu_stack_step(legacy=True, **args)
    b = glu_stack_step(legacy=True, **args)
    assert wavenet_step_cuda.launches == before + 2
    glu_stack_step_torch(legacy=True, **args)
    assert wavenet_step_cuda.launches == before + 2
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    args = stack_inputs(2, 3, 33, 16, 32, 8, seed=0, device=cuda)
    with pytest.raises(ValueError, match="batch 33"):
        glu_stack_step(**args)
    args = stack_inputs(2, 3, 2, 16, 32, 8, seed=0, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        glu_stack_step(**dict(args, cond=args["cond"].double()))
    with pytest.raises(ValueError, match="contiguous"):
        glu_stack_step(**dict(args, wtap=args["wtap"].transpose(2, 3)))
    with pytest.raises(ValueError, match="shape"):
        glu_stack_step(**dict(args, bias=args["bias"][:, :-8].contiguous()))
    with pytest.raises(ValueError, match="G % 8"):
        glu_stack_step(**stack_inputs(2, 3, 2, 16, 36, 8, seed=0, device=cuda))


def _offset_view(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its storage, so
    its data pointer is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
def test_kernel_alignment_applies_to_weights_only(cuda):
    """Only wtap, wskip and wout are read as float4; every other input may
    be any contiguous view."""
    args = stack_inputs(3, 3, 2, 16, 32, 8, seed=5, device=cuda)
    scalar = ("x0", "taps", "cond", "bias", "bskip", "bout")
    shifted = dict(args, **{n: _offset_view(args[n]) for n in scalar})
    assert all(shifted[n].data_ptr() % 16 for n in scalar)
    assert_kernel_matches_plain(shifted, legacy=True)
    for name in ("wtap", "wskip", "wout"):
        with pytest.raises(ValueError, match=f"{name} must be 16-byte"):
            glu_stack_step(**dict(args, **{name: _offset_view(args[name])}))


def test_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the CPU path is the
    dispatching glu_stack_step's plain chain, which launches nothing."""
    args = stack_inputs(2, 3, 2, 16, 32, 8, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        wavenet_step_cuda(**args)
    before = wavenet_step_cuda.launches
    got = glu_stack_step(legacy=True, **args)
    want = glu_stack_step_torch(legacy=True, **args)
    assert wavenet_step_cuda.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
