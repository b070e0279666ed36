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
    (3, 3, 32, 128, 256, 132, False),    # the largest batch a launch
    (20, 3, 33, 768, 768, 256, True),    # groups of 32 and 1
    (20, 3, 64, 768, 768, 256, True),    # two full groups
    (20, 3, 100, 768, 768, 256, True),   # 32, 32, 32 and 4
    (3, 3, 70, 20, 136, 12, False),      # ragged tiles in groups
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
    (20, 3, 32, 768, 768, 256),   # the largest batch a launch
    (20, 3, 64, 768, 768, 256),   # two launches a step
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
@pytest.mark.parametrize("B,launches", [(32, 1), (33, 2), (64, 2), (100, 4)])
def test_kernel_launches_once_a_group_of_32(cuda, B, launches):
    """A batch over 32 runs as groups of 32, one launch each, and each
    group's streams equal the same streams run as a batch of their own: the
    groups read the batch through its stride, nothing is copied."""
    args = stack_inputs(4, 3, B, 64, 128, 64, seed=B, device=cuda)
    step = prepare_glu_stack_step(*(args[n] for n in WEIGHTS), batch=B,
                                  legacy=True)
    assert step.launches_per_step == launches
    before = wavenet_step_cuda.launches
    got = [t.clone() for t in step(args["x0"], args["taps"], args["cond"])]
    assert wavenet_step_cuda.launches == before + launches
    for b0 in range(0, B, 32):
        rows = slice(b0, min(B, b0 + 32))
        alone = glu_stack_step(
            args["x0"][rows].contiguous(),
            args["taps"][:, :, rows].contiguous(),
            args["cond"][:, rows].contiguous(),
            *(args[n] for n in WEIGHTS), legacy=True)
        assert torch.equal(got[0][rows], alone[0])
        assert torch.equal(got[1][rows], alone[1])
        assert torch.equal(got[2][:, rows], alone[2])


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    args = stack_inputs(2, 3, 0, 16, 32, 8, seed=0, device=cuda)
    with pytest.raises(ValueError, match="batch 0"):
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


def _chunk_model(device, slots, seed=0):
    """A speaker- and locally conditioned WaveNet at the kernel's widths
    (L=6, k=3, C=G=128, S=64, 256 bins), numpy-seeded, and two requests'
    conditioning (frames, 16) with speaker ids."""
    from vqvae_speech_tpu_torch.convert import (
        load_wavenet_params,
        numpy_wavenet_params,
    )
    from vqvae_speech_tpu_torch.models.wavenet import WaveNet, WaveNetConfig

    cfg = WaveNetConfig(out_channels=256, layers=6, stacks=2,
                        residual_channels=128, gate_channels=128,
                        skip_out_channels=64, kernel_size=3, cin_channels=16,
                        gin_channels=8, n_speakers=4,
                        upsample_conditional_features=True,
                        upsample_scales=(4, 4))
    module = load_wavenet_params(WaveNet(cfg), numpy_wavenet_params(
        cfg, seed)).to(device).eval()
    rng = np.random.default_rng(seed)
    conds = [rng.standard_normal((n, 16)).astype(np.float32)
             for n in (12, 7, 10)[:slots]]
    return module, cfg, conds


@pytest.mark.cuda
def test_decode_chunk_kernel_matches_plain_chain(cuda):
    """Two chunks of 96 steps at 3 slots through the kernel (one launch a
    step) and through the plain chain on the same CUDA weights, the third
    request admitted at the second chunk into a slot with history: the
    logits within 1e-3 (the bucketed smoke's teacher-forced bound) up to
    the first bin where the streams part, which must be a near-tie of the
    plain chain's logits (top two within 2e-3)."""
    from vqvae_speech_tpu_torch.models.wavenet.chunked import (
        admit_slot,
        decode_chunk,
        init_decode_slots,
        slot_conditioning,
    )

    module, cfg, conds = _chunk_model(cuda, 3)
    runs = {}
    for name in ("kernel", "plain"):
        prep, state = init_decode_slots(module, cfg, 3, 12 * 16,
                                        use_fused_stack=True)
        if name == "plain":
            w = [prep[n] for n in WEIGHTS]
            prep["stack_step"] = lambda x0, taps, cond: glu_stack_step_torch(
                x0, taps, cond, *w, legacy=cfg.legacy)
        before = wavenet_step_cuda.launches
        em, outs = [], []
        for chunk, admit in enumerate(((0, 1), (2,))):
            for slot in admit:
                c = np.zeros((12, 16), np.float32)
                c[:len(conds[slot])] = conds[slot]
                rows = slot_conditioning(module, cfg, torch.from_numpy(c),
                                         slot, 12 * 16)
                admit_slot(prep, state, slot, rows)
            state, e, o = decode_chunk(prep, state, cfg, 96, sample=False,
                                       return_logits=True)
            em.append(e)
            outs.append(o)
        launches = wavenet_step_cuda.launches - before
        assert launches == (192 if name == "kernel" else 0)
        runs[name] = (torch.cat(em, 1).cpu().numpy(),
                      torch.cat(outs, 1).cpu().numpy())
    (got, got_logits), (want, want_logits) = runs["kernel"], runs["plain"]
    for slot in range(3):
        diff = np.flatnonzero(got[slot] != want[slot])
        flip = diff[0] if len(diff) else got.shape[1]
        if len(diff):
            top2 = np.sort(want_logits[slot, flip])[-2:]
            assert top2[1] - top2[0] <= 2e-3, (slot, flip, top2)
        np.testing.assert_allclose(got_logits[slot, :flip],
                                   want_logits[slot, :flip], rtol=0,
                                   atol=1e-3)


@pytest.mark.cuda
def test_continuous_server_takes_what_the_kernel_takes(cuda):
    """At f32 the server's slots are the kernel's batch, and the kernel takes
    any: 33 slots run it on every step, two launches a step (groups of 32
    and 1), and the request's greedy wave is bit-equal to the one 32 slots
    decode (its slot is in a group of 32 either way, so the sums are made in
    the same order); the int8 decode (layer by layer) launches nothing."""
    from vqvae_speech_tpu_torch.convert import numpy_wavenet_params
    from vqvae_speech_tpu_torch.serve import ContinuousSynthesisServer

    module, cfg, conds = _chunk_model("cpu", 1)
    tree = numpy_wavenet_params(cfg, 0)
    waves = {}
    for slots in (33, 32):
        server = ContinuousSynthesisServer(tree, cfg, slots=slots,
                                           chunk_size=8, max_frames=12,
                                           device="cuda")
        before = wavenet_step_cuda.launches
        waves[slots] = server.run(conds)[0].wave
        steps = server.stats["launches"] * 8
        assert wavenet_step_cuda.launches - before == steps * (
            2 if slots == 33 else 1)
    assert waves[33].shape == (192,)
    np.testing.assert_array_equal(waves[33], waves[32])
    server = ContinuousSynthesisServer(tree, cfg, slots=33, chunk_size=8,
                                       max_frames=12, weight_quant="int8",
                                       device="cuda")
    before = wavenet_step_cuda.launches
    wave = server.run(conds)[0].wave
    assert wavenet_step_cuda.launches == before and wave.shape == (192,)


@pytest.mark.cuda
def test_bucketed_server_at_max_batch_64_runs_the_kernel(cuda):
    """A bucketed launch of 64 streams runs K2 on every step, two launches a
    step (groups of 32); the requests' greedy waves are bit-equal to the
    same requests at max_batch 32 (their rows are in a group of 32 either
    way)."""
    from vqvae_speech_tpu_torch.convert import numpy_wavenet_params
    from vqvae_speech_tpu_torch.serve import BucketedSynthesisServer

    _, cfg, conds = _chunk_model("cpu", 3)
    tree = numpy_wavenet_params(cfg, 0)
    waves = {}
    for max_batch in (64, 32):
        server = BucketedSynthesisServer(tree, cfg, frame_buckets=(12,),
                                         max_batch=max_batch, device="cuda")
        wavenet_step_cuda.launches = 0
        waves[max_batch] = [r.wave for r in server.synthesize(conds)]
        steps = server.stats["launches"] * 12 * 16
        assert wavenet_step_cuda.launches == steps * (max_batch // 32)
    for a, b in zip(waves[64], waves[32]):
        np.testing.assert_array_equal(a, b)
