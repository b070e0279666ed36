#!/usr/bin/env python3
"""Drive the PyTorch port (vqvae_speech_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds both hand-written kernels from source, one nvcc each, in
   parallel: the fused VQ codebook search (csrc/vq_search.cu) and the fused
   WaveNet decode-step layer stack (csrc/wavenet_step.cu).
2. VQ kernel phase: holds vq_search against its plain PyTorch version on
   the same CUDA tensors at the serving and benchmark shapes, and times both.
3. Encode slice phase: serves mixed-length VCTK requests through all three
   buckets of BucketedEncodeServer at the flagship vq44-mfcc39 width, with
   random weights from numpy_params(seed=0); checks that the kernel ran,
   that the codes equal the plain search on the server's own latents and the
   JAX package's codes in tests/data/torch_port_flagship_codes.npz, and that
   the eval forward gives finite reconstructions; reports requests/s and
   frames/s.
4. Decode-step kernel phase: holds glu_stack_step against its plain
   PyTorch chain at the vctk_wavenet width (20 layers, k=3, C=G=768,
   S=256) for batch 1 and 8 with and without the legacy skip scaling, and
   at k=2; times both and reports the kernel's weight-streaming GB/s.
5. Synthesis slice phase: WaveNetVQVAE at the vctk_wavenet width
   (numpy_wavenet_vqvae_params(seed=0)) turns ten VCTK waves into local
   conditioning (the VQ kernel runs here), and BucketedSynthesisServer
   decodes them greedily through two frame buckets, one decode-step kernel
   launch per sample step. Checks the launch counts, the teacher-forced
   consistency of one launch's logits and bins with the plain batch
   forward, the codes and teacher-forced logits against the JAX package's
   (tests/data/torch_port_wavenet_golden.npz), and the decoded audio;
   reports samples/s, the real-time factor, ms per step and the device's
   idle share from torch.profiler.

Exits non-zero on any failure, and without a CUDA device. The last two lines
of output are a JSON object of per-kernel results and the JSON status line.
Imports nothing of JAX.
"""
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# configurations/vctk_features.yaml with the "baseline" overrides of
# configurations/experiments_vq44-mfcc39.json (written out: the GPU machine
# has no PyYAML). Served without a feature normalizer.
FLAGSHIP_CONFIG = dict(
    input_features_type="mfcc",
    input_features_filters=13,
    augment_input_features=True,
    output_features_type="mfcc",
    output_features_filters=13,
    augment_output_features=True,
    sampling_rate=16000,
    num_hiddens=768,
    num_residual_layers=2,
    residual_channels=768,
    embedding_dim=64,
    num_embeddings=44,
    commitment_cost=0.25,
    decay=0.0,
    use_kaiming_normal=False,
    use_jitter=False,
    jitter_probability=0.12,
    use_speaker_conditioning=False,
    codebook_revival=False,
)
SEED = 0
MAX_BATCH = 64
WAVE_DIR = os.path.join(REPO_ROOT, "quality_parity", "raw", "VCTK-Corpus",
                        "wav48", "p300")
# four requests per bucket of (7680, 15360, 30720)
REQUEST_LENGTHS = (7680, 5000, 3001, 640, 15360, 12345, 9600, 7681,
                   30720, 25000, 20000, 16000)
GOLDEN = os.path.join(REPO_ROOT, "tests", "data",
                      "torch_port_flagship_codes.npz")
# (N, K) at D=64: N=1536, 3072 and 6144 are the server's launches (64 waves
# x 24, 48 and 96 latent rows at the 7680, 15360 and 30720 buckets), 24576
# is bench.py's batch 1024 x 24 rows, K=1000 the largest codebook of
# configurations/experiments_mfcc39-codebook_sizes.json; N=12 and 24 at
# K=29 are the synthesis slice's local_conditioning (one item of 12 or 24
# latent frames against the vctk_wavenet codebook)
KERNEL_SHAPES = ((1, 44), (1000, 44), (1536, 44), (3072, 44), (6144, 44),
                 (24576, 44), (1536, 1000), (12, 29), (24, 29))
TIMED_SHAPE = (1536, 44)
# a differing index is a near-tie when its distance is within this of the
# winner's: 1e-5 * (||z||^2 + 1) between the kernel and the plain search on
# the same tensors (f32 summation order); 1e-4 * (||z||^2 + 1) against the
# JAX codes, whose latents came from XLA's CPU convolutions
NEAR_TIE_SAME_INPUT = 1e-5
NEAR_TIE_GOLDEN = 1e-4

# configurations/vctk_wavenet.yaml, the keys the WaveNet-VQ-VAE reads
# (written out: the GPU machine has no PyYAML)
WAVENET_CONFIG = dict(
    input_features_type="mfcc",
    input_features_filters=13,
    augment_input_features=True,
    sampling_rate=16000,
    num_hiddens=768,
    num_residual_layers=2,
    residual_channels=768,
    embedding_dim=64,
    num_embeddings=29,
    commitment_cost=0.25,
    decay=0.0,
    use_kaiming_normal=False,
    use_jitter=False,
    jitter_probability=0.12,
    quantize=256,
    n_loop=2,
    n_layers=20,
    filter_size=3,
    gate_channels=768,
    skip_out_channels=256,
    global_condition_dim=128,
    local_condition_dim=768,
    num_speakers=128,
)
# VCTK p300_000..009, speaker ids 0..9; 3000-4000 samples give <= 11 local
# conditioning frames (bucket 12, 4608 steps), 5000-7680 up to 23 (bucket
# 23, 8832 steps)
SYNTH_LENGTHS = (3840, 7680, 3000, 5000, 4000, 6400, 7680, 3840, 5000, 6400)
SYNTH_BUCKETS = (12, 23)
SYNTH_MAX_BATCH = 8
WAVENET_GOLDEN = os.path.join(REPO_ROOT, "tests", "data",
                              "torch_port_wavenet_golden.npz")
TEACHER_FORCED_SAMPLES = 256  # request 0's samples in the golden logits
STEP_SHAPES = ((1, 3, True), (1, 3, False), (8, 3, True), (8, 3, False),
               (2, 2, True))  # (B, k, legacy) at L=20, C=G=768, S=256
TIMED_STEP = (8, 3, True)     # the server's batch
# an emitted bin may differ from the teacher-forced forward's argmax when
# the top two logits lie within this of each other
NEAR_TIE_LOGITS = 2e-3


def smoke_requests():
    """The smoke's requests: VCTK p300_000..009 (16 kHz, silence-trimmed and
    peak-normalized by the port's loader), tiled and cropped to
    REQUEST_LENGTHS."""
    from vqvae_speech_tpu_torch.data.audio import load_and_preprocess

    waves = []
    for i, n in enumerate(REQUEST_LENGTHS):
        w, _ = load_and_preprocess(
            os.path.join(WAVE_DIR, f"p300_{i % 10:03d}.wav"), 16000)
        waves.append(np.tile(w, -(-n // len(w)))[:n].astype(np.float32))
    return waves


def synthesis_requests():
    """The synthesis slice's requests: VCTK p300_000..009 (loaded as
    smoke_requests loads them), tiled and cropped to SYNTH_LENGTHS, with
    speaker ids 0..9."""
    from vqvae_speech_tpu_torch.data.audio import load_and_preprocess

    waves = []
    for i, n in enumerate(SYNTH_LENGTHS):
        w, _ = load_and_preprocess(
            os.path.join(WAVE_DIR, f"p300_{i:03d}.wav"), 16000)
        waves.append(np.tile(w, -(-n // len(w)))[:n].astype(np.float32))
    return waves, list(range(len(waves)))


def wavenet_features(wave, device):
    """One wave -> (1, T_feat, 39) MFCC + deltas on ``device``."""
    import torch
    from vqvae_speech_tpu_torch.ops import speech_features

    cfg = WAVENET_CONFIG
    return speech_features(
        cfg["input_features_type"],
        torch.from_numpy(np.asarray(wave, np.float32))[None].to(device),
        cfg["sampling_rate"], cfg["input_features_filters"],
        cfg["augment_input_features"])


def teacher_forced_inputs(emitted, n_bins):
    """[onehot(127), onehot(emitted[:, :-1])]: the inputs a greedy decode
    fed itself, for the batch forward."""
    import torch
    import torch.nn.functional as F

    x = F.one_hot(emitted.long(), n_bins).float()
    first = torch.zeros_like(x[:, :1])
    first[..., 127] = 1.0
    return torch.cat([first, x[:, :-1]], dim=1)


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _per_launch_ms(fn, launches=100, warmup=3):
    """Mean ms of ``launches`` back-to-back calls between one CUDA-event
    pair."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def _near_ties(flat, codebook, got_idx, want_idx, rel_tol):
    """Rows where got and want differ; raises unless each is a near-tie on
    these latents. Returns the number of differing rows."""
    import torch
    from vqvae_speech_tpu_torch.ops.vq import vq_distances

    diff = (got_idx != want_idx).nonzero().flatten()
    if len(diff):
        d = vq_distances(flat[diff], codebook)
        gap = (d.gather(1, got_idx[diff, None].long())
               - d.gather(1, want_idx[diff, None].long())).abs()
        tol = rel_tol * (flat[diff].square().sum(1, keepdim=True) + 1)
        if not bool((gap <= tol).all()):
            raise AssertionError(
                f"{len(diff)} rows differ, max gap {gap.max().item():.3e} "
                f"exceeds the near-tie bound {rel_tol} * (||z||^2 + 1)")
    return int(len(diff))


def kernel_phase():
    """The kernel against vq_search_torch on the same CUDA tensors."""
    import torch
    from vqvae_speech_tpu_torch.ops import vq_search, vq_search_torch

    rng = np.random.default_rng(SEED)
    max_err, timed = 0.0, None
    for N, K in KERNEL_SHAPES:
        flat = torch.from_numpy(rng.standard_normal((N, 64))
                                .astype(np.float32)).cuda()
        cb = torch.from_numpy(rng.standard_normal((K, 64))
                              .astype(np.float32)).cuda()
        got, want = vq_search(flat, cb), vq_search_torch(flat, cb)
        torch.cuda.synchronize()
        n_diff = _near_ties(flat, cb, got.indices, want.indices,
                            NEAR_TIE_SAME_INPUT)
        # the plain chain's outputs for the kernel's own indices (equal to
        # `want` when no row differs): q exact, counts exact, dw rtol/atol 1e-4
        onehot = torch.nn.functional.one_hot(got.indices.long(), K).float()
        torch.testing.assert_close(got.quantized, onehot @ cb, rtol=0, atol=0)
        torch.testing.assert_close(got.counts, onehot.sum(0), rtol=0, atol=0)
        plain_dw = onehot.t() @ flat
        torch.testing.assert_close(got.dw, plain_dw, rtol=1e-4, atol=1e-4)
        err = (got.dw - plain_dw).abs().max().item()
        max_err = max(max_err, err)
        ms = _median_ms(lambda: vq_search(flat, cb))
        plain_ms = _median_ms(lambda: vq_search_torch(flat, cb))
        if (N, K) == TIMED_SHAPE:
            timed = (ms, plain_ms)
        print(f"kernel vq_search N={N} K={K} D=64: near-tie rows {n_diff}, "
              f"max_abs_err {err:.3e}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (median of 50, CUDA events)")
    return max_err, timed


def slice_phase(gpu):
    """Serve the flagship requests through the port's encode server."""
    import torch
    from vqvae_speech_tpu_torch.convert import numpy_params
    from vqvae_speech_tpu_torch.ops import _kernels, vq_search_torch
    from vqvae_speech_tpu_torch.serve import BucketedEncodeServer

    params, state = numpy_params(FLAGSHIP_CONFIG, seed=SEED)
    server = BucketedEncodeServer(params, state, FLAGSHIP_CONFIG,
                                  max_batch=MAX_BATCH, device="cuda")
    requests = smoke_requests()

    _kernels.vq_search_cuda.launches = 0
    results = server.encode(requests)
    launches = _kernels.vq_search_cuda.launches
    if launches == 0:
        raise AssertionError("the server never launched the vq_search kernel")
    buckets = sorted({r.bucket for r in results})
    if buckets != [7680, 15360, 30720]:
        raise AssertionError(f"requests filled buckets {buckets}")
    print(f"slice: {len(requests)} requests through buckets {buckets}, "
          f"{server.stats['launches']} server launches, "
          f"vq_search kernel launches {launches}")

    golden = np.load(GOLDEN)
    codebook = server.model.vq.codebook.detach()
    D = codebook.shape[1]
    n_plain = n_golden = 0
    for bucket in buckets:
        rows = [i for i, r in enumerate(results) if r.bucket == bucket]
        with torch.inference_mode():
            z = server.model.latents(server.features(
                server.padded_batch([requests[i] for i in rows], bucket)))
        flat = z[:len(rows)].contiguous().view(-1, D)
        served = torch.from_numpy(
            np.concatenate([results[i].codes for i in rows])).cuda()
        plain = vq_search_torch(flat, codebook).indices
        n_plain += _near_ties(flat, codebook, served, plain,
                              NEAR_TIE_SAME_INPUT)
        jax_codes = torch.from_numpy(np.concatenate(
            [golden[f"codes_{i:02d}"] for i in rows])).cuda()
        if jax_codes.shape != served.shape:
            raise AssertionError(f"golden codes {tuple(jax_codes.shape)} vs "
                                 f"served {tuple(served.shape)}")
        n_golden += _near_ties(flat, codebook, served, jax_codes,
                               NEAR_TIE_GOLDEN)
    n_codes = sum(r.codes.size for r in results)
    print(f"slice: {n_codes} codes; near-tie rows vs plain search on the "
          f"server's latents {n_plain}, vs JAX golden codes {n_golden}")

    with torch.inference_mode():
        feats = server.features(server.padded_batch(requests[:4], 7680))
        out = server.model(feats)
    shape = tuple(out.reconstructed_x.shape)
    if shape != (MAX_BATCH, feats.shape[1], 39):
        raise AssertionError(f"reconstruction shape {shape}")
    if not bool(torch.isfinite(out.reconstructed_x).all()):
        raise AssertionError("non-finite reconstruction")
    print(f"slice: eval forward reconstruction {shape}, all finite")

    # throughput: each bucket's batch filled to max_batch (192 requests)
    load = [w for w in requests for _ in range(MAX_BATCH // 4)]
    frames = sum(r.n_frames for r in server.encode(load))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.encode(load)
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    print(f"slice: {len(load)} requests in {sec * 1e3:.2f} ms (median of 5): "
          f"{len(load) / sec:.1f} requests/s, {frames / sec:.0f} frames/s "
          f"[{gpu}]")
    return launches


def step_kernel_phase(gpu):
    """glu_stack_step (the kernel) against glu_stack_step_torch on the same
    CUDA tensors: the prepared weights of numpy_wavenet_params(seed=0) at
    the vctk_wavenet width, unit-scale x0, taps and cond. Tolerance rtol
    1e-4 (the JAX test's bound for its kernel) and atol 1e-4 (sums of up to
    2304 f32 terms in another order)."""
    import dataclasses

    import torch
    from vqvae_speech_tpu_torch.convert import (
        load_wavenet_params,
        numpy_wavenet_params,
    )
    from vqvae_speech_tpu_torch.models.wavenet import (
        WaveNet,
        prepare_decode_weights,
    )
    from vqvae_speech_tpu_torch.models.wavenet_decoder import (
        wavenet_config_from,
    )
    from vqvae_speech_tpu_torch.ops import glu_stack_step, glu_stack_step_torch

    cfg = wavenet_config_from(WAVENET_CONFIG, WAVENET_CONFIG["num_speakers"])
    rng = np.random.default_rng(SEED)
    weights = {}
    max_err, timed = 0.0, None
    with torch.inference_mode():
        for B, k, legacy in STEP_SHAPES:
            if k not in weights:
                kcfg = dataclasses.replace(cfg, kernel_size=k)
                module = load_wavenet_params(
                    WaveNet(kcfg), numpy_wavenet_params(kcfg, SEED)).cuda()
                w = prepare_decode_weights(module, kcfg)
                weights[k] = {n: w[n] for n in ("wtap", "bias", "wskip",
                                                "bskip", "wout", "bout")}
                del module
            w = weights[k]
            L, _, C, G = w["wtap"].shape

            def unit(*shape):
                return torch.from_numpy(rng.standard_normal(shape)
                                        .astype(np.float32)).cuda()

            args = dict(x0=unit(B, C), taps=unit(L, k - 1, B, C),
                        cond=unit(L, B, G), **w)
            got = glu_stack_step(legacy=legacy, **args)
            want = glu_stack_step_torch(legacy=legacy, **args)
            torch.cuda.synchronize()
            err = 0.0
            for g, p in zip(got, want):
                torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4)
                err = max(err, (g - p).abs().max().item())
            max_err = max(max_err, err)
            ms = _per_launch_ms(lambda: glu_stack_step(legacy=legacy, **args))
            plain_ms = _per_launch_ms(
                lambda: glu_stack_step_torch(legacy=legacy, **args))
            weight_bytes = 4 * sum(w[n].numel() for n in ("wtap", "wskip",
                                                           "wout"))
            gbps = weight_bytes / (ms * 1e-3) / 1e9
            if (B, k, legacy) == TIMED_STEP:
                timed = (ms, plain_ms)
            print(f"kernel glu_stack_step L={L} k={k} B={B} C={C} G={G} "
                  f"S={w['wskip'].shape[2]} legacy={legacy}: max_abs_err "
                  f"{err:.3e}; kernel {ms:.4f} ms/step ({gbps:.0f} GB/s of "
                  f"{weight_bytes / 1e6:.1f} MB weights), plain "
                  f"{plain_ms:.4f} ms/step (mean of 100 back-to-back "
                  f"launches, CUDA events) [{gpu}]")
    return max_err, timed


def synthesis_phase(gpu):
    """WaveNet-VQ-VAE synthesis serving at the vctk_wavenet width."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vqvae_speech_tpu_torch.convert import (
        load_wavenet_vqvae_params,
        numpy_wavenet_vqvae_params,
    )
    from vqvae_speech_tpu_torch.models import WaveNetVQVAE
    from vqvae_speech_tpu_torch.ops import (
        _kernels,
        mu_law_decode,
        mu_law_encode,
        vq_search,
        vq_search_torch,
    )
    from vqvae_speech_tpu_torch.serve import BucketedSynthesisServer

    t0 = time.perf_counter()
    n_spk = WAVENET_CONFIG["num_speakers"]
    params, state, wcfg = numpy_wavenet_vqvae_params(WAVENET_CONFIG, n_spk,
                                                     seed=SEED)
    model = load_wavenet_vqvae_params(WaveNetVQVAE(WAVENET_CONFIG, n_spk),
                                      params, state).cuda().eval()
    server = BucketedSynthesisServer(
        params["decoder"]["wavenet"], wcfg, frame_buckets=SYNTH_BUCKETS,
        max_batch=SYNTH_MAX_BATCH, device="cuda")
    waves, speakers = synthesis_requests()
    factor = server.stats["upsample_factor"]
    print(f"synthesis: set-up {time.perf_counter() - t0:.2f} s (random "
          f"vctk_wavenet weights, {len(waves)} requests)")

    # the main path: waves -> features -> codes (VQ kernel) -> local
    # conditioning -> greedy AR synthesis (decode-step kernel every step)
    _kernels.vq_search_cuda.launches = 0
    _kernels.wavenet_step_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [wavenet_features(w, "cuda") for w in waves]
    lcs, codes = [], []
    for f in feats:
        lc, c = model.local_conditioning(f)
        lcs.append(lc[0])
        codes.append(c[0])
    results = server.synthesize(lcs, speaker_ids=speakers)
    torch.cuda.synchronize()
    main_sec = time.perf_counter() - t0
    vq_launches = _kernels.vq_search_cuda.launches
    step_launches = _kernels.wavenet_step_cuda.launches

    per_bucket = {b: [i for i, r in enumerate(results) if r.bucket == b]
                  for b in SYNTH_BUCKETS}
    if sorted({r.bucket for r in results}) != list(SYNTH_BUCKETS):
        raise AssertionError(f"requests filled buckets "
                             f"{sorted({r.bucket for r in results})}")
    for lc, r in zip(lcs, results):
        if r.wave.shape != (lc.shape[0] * factor,):
            raise AssertionError(f"wave {r.wave.shape} for {lc.shape[0]} "
                                 "conditioning frames")
    steps = sum(-(-len(idx) // SYNTH_MAX_BATCH) * b * factor
                for b, idx in per_bucket.items())
    if step_launches != steps:
        raise AssertionError(f"decode-step kernel launched {step_launches} "
                             f"times for {steps} decoded steps")
    if vq_launches == 0:
        raise AssertionError("the VQ kernel never ran on the synthesis path")
    print(f"synthesis: {len(waves)} requests, LC frames "
          f"{[lc.shape[0] for lc in lcs]}, buckets "
          f"{ {b: len(i) for b, i in per_bucket.items()} }, "
          f"{server.stats['launches']} launches, {steps} decoded steps; "
          f"kernel launches: wavenet_step {step_launches}, vq_search "
          f"{vq_launches}; main path {main_sec:.2f} s")

    # teacher-forced consistency: the bucket-23 launch against the plain
    # batch forward (cuDNN convolutions, TF32 off) on its own emitted stream
    bucket = SYNTH_BUCKETS[-1]
    idx = per_bucket[bucket]
    c, g = server.padded_batch([lcs[i] for i in idx],
                               [speakers[i] for i in idx], bucket)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, emitted = server.generate_batch(c, g)
    torch.cuda.synchronize()
    gen_sec = time.perf_counter() - t0
    for row, i in enumerate(idx):
        again = emitted[row, :len(results[i].wave)].cpu().numpy()
        if not np.array_equal(again, results[i].wave):
            raise AssertionError(f"request {i}: generate_batch and synthesize "
                                 "disagree")
    with torch.inference_mode():
        forward = server.model(
            teacher_forced_inputs(emitted, wcfg.out_channels), c, g)
    tf_err = (forward - outs).abs().max().item()
    if not tf_err <= 1e-3:
        raise AssertionError(f"decode logits vs teacher-forced forward: max "
                             f"abs diff {tf_err:.3e} > 1e-3")
    top = forward.max(-1).values
    chosen = forward.gather(-1, emitted[..., None].long())[..., 0]
    ties = forward.argmax(-1) != emitted
    gap = (top - chosen)[ties]
    if len(gap) and not bool((gap <= NEAR_TIE_LOGITS).all()):
        raise AssertionError(f"emitted bins off the forward's argmax by up to "
                             f"{gap.max().item():.3e} > {NEAR_TIE_LOGITS}")
    print(f"synthesis: teacher-forced forward on one {emitted.shape[1]}-step "
          f"launch of {emitted.shape[0]} streams: max abs logit diff "
          f"{tf_err:.3e} (limit 1e-3); near-ties {int(ties.sum())} of "
          f"{emitted.numel()} bins (gap <= {NEAR_TIE_LOGITS})")

    # the path's codes and the kernel's quantized rows against the plain
    # search on the same latents, then the JAX package's codes and
    # teacher-forced logits
    golden = np.load(WAVENET_GOLDEN)
    codebook = model.vq.codebook.detach()
    D = codebook.shape[1]
    n_plain = n_golden = 0
    with torch.inference_mode():
        for i, f in enumerate(feats):
            flat = model.latents(f).contiguous().view(-1, D)
            plain = vq_search_torch(flat, codebook)
            n_plain += _near_ties(flat, codebook, codes[i], plain.indices,
                                  NEAR_TIE_SAME_INPUT)
            got = vq_search(flat, codebook)
            n_plain += _near_ties(flat, codebook, got.indices, plain.indices,
                                  NEAR_TIE_SAME_INPUT)
            same = got.indices == plain.indices
            torch.testing.assert_close(got.quantized[same],
                                       plain.quantized[same], rtol=0, atol=0)
            torch.testing.assert_close(
                got.quantized, codebook[got.indices.long()], rtol=0, atol=0)
            want = torch.from_numpy(golden[f"codes_{i:02d}"]).cuda()
            if want.shape != codes[i].shape:
                raise AssertionError(f"golden codes {tuple(want.shape)} vs "
                                     f"{tuple(codes[i].shape)}")
            n_golden += _near_ties(flat, codebook, codes[i], want,
                                   NEAR_TIE_GOLDEN)
        bins = mu_law_encode(torch.from_numpy(
            waves[0][:TEACHER_FORCED_SAMPLES]), wcfg.out_channels)
        if not np.array_equal(bins.numpy(), golden["teacher_forced_bins"]):
            raise AssertionError("mu-law bins differ from the JAX package's")
        x_dec = torch.nn.functional.one_hot(
            bins.long(), wcfg.out_channels).float()[None].cuda()
        logits = model(feats[0], x_dec,
                       torch.tensor([speakers[0]]).cuda()).reconstructed_x
    golden_err = np.abs(logits[0].cpu().numpy()
                        - golden["teacher_forced_logits"]).max()
    if not golden_err <= 1e-3:
        raise AssertionError(f"teacher-forced logits vs JAX: max abs diff "
                             f"{golden_err:.3e} > 1e-3")
    print(f"synthesis: codes and the kernel's search vs the plain search on "
          f"the same latents: near-tie rows {n_plain}, quantized rows exact; "
          f"golden codes near-tie rows {n_golden}; teacher-forced "
          f"logits of request 0 ({TEACHER_FORCED_SAMPLES} samples) vs JAX: "
          f"max abs diff {golden_err:.3e} (limit 1e-3)")

    for r in results:
        audio = mu_law_decode(torch.from_numpy(r.wave), wcfg.out_channels)
        if not (bool(torch.isfinite(audio).all())
                and float(audio.abs().max()) <= 1.0):
            raise AssertionError("decoded audio not finite or outside [-1, 1]")
    print(f"synthesis: {sum(len(r.wave) for r in results)} samples decoded "
          "to finite audio in [-1, 1]")

    rate = WAVENET_CONFIG["sampling_rate"]
    for bucket, idx in per_bucket.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = server.synthesize([lcs[i] for i in idx],
                                [speakers[i] for i in idx])
        sec = time.perf_counter() - t0
        T = bucket * factor
        real = sum(len(r.wave) for r in out)
        print(f"synthesis bucket {bucket} ({T} steps, {len(idx)} requests in "
              f"{SYNTH_MAX_BATCH} streams): synthesize {sec:.3f} s, "
              f"{sec / T * 1e3:.4f} ms/step, {real / sec:.0f} samples/s "
              f"delivered, {SYNTH_MAX_BATCH * T / sec:.0f} samples/s decoded, "
              f"{T / sec:.0f} samples/s per stream, real-time factor "
              f"{sec / (T / rate):.3f} at {rate} Hz [{gpu}]")
    print(f"synthesis: generate_batch of {emitted.shape[1]} steps "
          f"{gen_sec:.3f} s, {gen_sec / emitted.shape[1] * 1e3:.4f} ms/step "
          f"[{gpu}]")

    # device busy and idle share over one synthesize (bucket 12)
    bucket = SYNTH_BUCKETS[0]
    idx = per_bucket[bucket]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.synthesize([lcs[i] for i in idx], [speakers[i] for i in idx])
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    stats = prof.key_averages()
    busy_us = {e.key: e.self_device_time_total for e in stats
               if e.self_device_time_total > 0}
    total_us = sum(busy_us.values())
    kernel_us = sum(v for k, v in busy_us.items() if "glu_" in k)
    if total_us > 0:
        print(f"synthesis profile (bucket {bucket}, torch.profiler CUDA "
              f"activity): window {window:.3f} s, device busy "
              f"{total_us / 1e6:.3f} s, idle share "
              f"{1 - total_us / 1e6 / window:.3f}; decode-step kernels "
              f"{kernel_us / total_us:.3f} of device time [{gpu}]")
        for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / 1e3:10.2f} ms  {name[:100]}")
    else:
        print("synthesis profile: the profiler showed no device time; idle "
              "share not measured")
    return step_launches, vq_launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU")
    gpu = _nvidia_smi()
    print(gpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    from vqvae_speech_tpu_torch.ops import _kernels

    def timed_build(name):
        t = time.perf_counter()
        report = _kernels.build(name, force=True)
        return time.perf_counter() - t, report

    names = ("vq_search", "wavenet_step")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(timed_build, names)))
    for name, (sec, report) in builds.items():
        print(f"built csrc/{name}.cu in {sec:.2f} s (nvcc, in parallel)")
        for line in report.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print("  " + line.strip())

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.2f} s")
        return out

    vq_err, (vq_ms, vq_plain_ms) = phase(kernel_phase)
    encode_vq_launches = phase(slice_phase, gpu)
    step_err, (step_ms, step_plain_ms) = phase(step_kernel_phase, gpu)
    step_launches, synth_vq_launches = phase(synthesis_phase, gpu)
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "vqvae_speech_tpu"))
    if jax_side:
        raise AssertionError(f"the run imported JAX-side modules {jax_side}")

    print(json.dumps({"kernels": [{
        "name": "vq_search",
        "route": "cuda",
        "source": "vqvae_speech_tpu_torch/csrc/vq_search.cu",
        "replaces": "vqvae_speech_tpu/ops/vq.py:91",
        "launches": encode_vq_launches + synth_vq_launches,
        "max_abs_err": vq_err,
        "ms": vq_ms,
        "plain_ms": vq_plain_ms,
    }, {
        "name": "wavenet_step",
        "route": "cuda",
        "source": "vqvae_speech_tpu_torch/csrc/wavenet_step.cu",
        "replaces": "vqvae_speech_tpu/ops/wavenet_step.py:35",
        "launches": step_launches,
        "max_abs_err": step_err,
        "ms": step_ms,
        "plain_ms": step_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
