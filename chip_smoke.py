#!/usr/bin/env python3
"""Drive the PyTorch port (vqvae_speech_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the three hand-written kernel sources, one nvcc each, in
   parallel: the fused VQ codebook search (csrc/vq_search.cu), the fused
   WaveNet decode-step layer stack (csrc/wavenet_step.cu) and the fused
   gated-resblock chains (csrc/fused_resblock.cu).
2. VQ kernel phase: holds vq_search against its plain PyTorch version on
   the same CUDA tensors at the serving, training and benchmark shapes, runs
   each twice and requires bit-equal outputs, counts the device kernels one
   search launches (torch.profiler: one, two above the one-launch rule), and
   times both.
3. Encode slice phase: serves mixed-length VCTK requests through all three
   buckets of BucketedEncodeServer at the flagship vq44-mfcc39 width, with
   random weights from numpy_params(seed=0); checks that the kernel ran,
   that the codes equal the plain search on the server's own latents and the
   JAX package's codes in tests/data/torch_port_flagship_codes.npz, and that
   the eval forward gives finite reconstructions; reports requests/s and
   frames/s, and the VQ kernel's device time a launch from torch.profiler.
   Train phase (runs right after it): the flagship jitter12 experiment's train
   step (make_train_step: forward, MSE + VQ loss, backward, amsgrad, EMA
   state) at full width and batch 64 on MFCC features of VCTK crops, 5
   warm-up and 50 timed steps on one fixed batch, for the gradient and the
   EMA quantizer. Checks one kernel launch a step, finite losses and a
   falling reconstruction loss, the kernel's forward and the search's backward against the plain
   search with autograd on the step's own latents, and one whole step on
   the card against the same step on the CPU; reports ms a step, steps/s
   and, from torch.profiler, the device's idle share and the shares of the
   VQ kernel, the convolutions forward and backward and the optimizer.
   Experiment phase (right after it): the flagship's training loop through
   the port's CLI (python -m vqvae_speech_tpu_torch.main) in a temporary
   directory with configurations/ and data/vctk/raw linked in: export of
   the tracked VCTK subset (400 wavs, 320 / 80 split) to the feature store,
   its normalizer, then the jitter12 experiment of
   configurations/experiments_vq44-mfcc39.json at full width and batch 2
   with num_epochs cut to 2, and a resume to epoch 3 after raising
   num_epochs in the frozen config. Checks the store's shapes and counts,
   the checkpoints, the optimizer count, finite losses and a falling mean
   reconstruction loss. In process, on the same store, one epoch through
   Experiment.build_trainer(device="cuda"): the trainer turns cuDNN's TF32
   off (the configuration's f32), one VQ kernel launch a step,
   every prefetched batch bit-equal to the loader's, seconds an epoch,
   steps/s, ms a step beside the bare step's, the device's idle share from
   torch.profiler; then the epoch-3 checkpoint and the normalizer in
   BucketedEncodeServer encode the val split, codes against the plain
   search on the server's own latents.
4. Decode-step kernel phase: holds glu_stack_step against its plain
   PyTorch chain at the vctk_wavenet width (20 layers, k=3, C=G=768,
   S=256) for batch 1, 8 and 32 with and without the legacy skip scaling,
   at k=2, and at a narrow width whose tiles and slices are ragged; runs
   each twice and requires bit-equal outputs; times the prepared step (the
   decode loop's form) and the plain chain, reports the kernel's
   weight-streaming GB/s and counts the device kernels one step launches
   (torch.profiler).
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

6. Chain kernel phase: holds the three fused-chain entry points against
   their plain PyTorch chains on the same CUDA tensors: the causal tiled
   chain at the IAF student's width for T=20480 and an odd T, the whole-T
   causal chain at T=4096, the non-causal chain at all eight FloWaveNet
   block shapes, at a T off every tile size and at a deep-dilation case;
   runs each twice and requires bit-equal outputs; holds the kernel's
   prepared weights (transposed, split into TF32 hi and lo parts) against
   the same layout built with tensor operations, and one bare product of
   its tensor-core main loop against torch.matmul in f32; times the kernel
   on weights prepared once (as the shapes route it, and forced onto each
   of its two decompositions) and the plain chain, states the card's f32
   bound and the tensor cores' bound for each, what one TF32 product a f32
   product would have cost in error, and what cuBLAS takes for the
   student chain's products alone in f32 and in one-pass TF32.
7. Vocoder slice phase: the one-pass vocoders at paper width
   (numpy_student_params / numpy_flowavenet_params, seed 0) behind
   BucketedParallelSynthesisServer: eight VCTK requests -> normalized
   log-mel -> frame buckets 20, 40, 80 -> (a) the IAF student and (b) the
   FloWaveNet reverse pass at max_batch 1 through the fused chains, (c)
   both at max_batch 8 on the plain path with the same noise (and, for
   the times only, at max_batch 1 on the plain path). Checks the
   launch counts, that every wave is finite and not constant, (a) and (b)
   against (c) request by request, and one short request a kind against
   the JAX package's wave (tests/data/torch_port_vocoder_golden.npz);
   drives the whole-T chain entry point on the student's own weights;
   reports samples/s and ms a request.

Exits non-zero on any failure, and without a CUDA device. The last two lines
of output are a JSON object of per-kernel results and the JSON status line.
Imports nothing of JAX.

    python3 chip_smoke.py --phases step_kernel,synthesis

runs only the named phases (kernel, slice, train, experiment, step_kernel,
synthesis, chain_kernel, vocoder), for work on one kernel or slice; such a
run prints neither of the two JSON lines.
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
# configurations/experiments_mfcc39-codebook_sizes.json; N=48 at K=44 is
# the training loop's (jitter12 at batch 2 x 24 latent rows, once a step);
# N=12 and 24 at K=29 are the synthesis slice's local_conditioning (one item
# of 12 or 24 latent frames against the vctk_wavenet codebook)
KERNEL_SHAPES = ((1, 44), (48, 44), (1000, 44), (1536, 44), (3072, 44),
                 (6144, 44), (24576, 44), (1536, 1000), (12, 29), (24, 29))
TIMED_SHAPE = (1536, 44)
# the train phase: the jitter12 experiment of
# configurations/experiments_vq44-mfcc39.json at the largest batch of
# experiments_vq44-mfcc39-batch_sizes.json (64 x 24 latent rows = 1536, the
# timed shape), learning rate of configurations/vctk_features.yaml
TRAIN_BATCH = 64
TRAIN_SAMPLES = 7680
TRAIN_WARMUP, TRAIN_STEPS = 5, 50
TRAIN_LEARNING_RATE = 2e-4
# the kernel's outputs and the search's backward against the plain search
# on the same latents: sums of at most 1536 f32 terms in another order,
# as a share of the tensor's largest magnitude (or of 1 if that is smaller:
# after 55 steps on one batch the gradient quantizer's latents have grown)
TRAIN_KERNEL_TOL = 1e-5
# one whole step on the card against the CPU's: relative on the loss,
# absolute on the updated codebook (one amsgrad step moves a weight by at
# most the learning rate)
TRAIN_LOSS_RTOL, TRAIN_CODEBOOK_ATOL = 1e-4, 1e-5
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
# (B, k, legacy, width): width None is vctk_wavenet's L=20, C=G=768, S=256
# with the weights of numpy_wavenet_params; NARROW_STEP is a width whose 68
# gate pairs, 20 + 12 projection columns and 60-row reduction leave every
# tile and slice ragged, with random weights
NARROW_STEP = dict(L=5, C=20, G=136, S=12)
STEP_SHAPES = ((1, 3, True, None), (1, 3, False, None), (8, 3, True, None),
               (8, 3, False, None), (2, 2, True, None), (32, 3, True, None),
               (3, 3, True, NARROW_STEP))
TIMED_STEP = (8, 3, True, None)     # the server's batch
# an emitted bin may differ from the teacher-forced forward's argmax when
# the top two logits lie within this of each other
NEAR_TIE_LOGITS = 2e-3

# One-pass vocoders at the paper widths (the dataclasses' defaults): the
# ClariNet IAF student (flows of 1, 1, 1 and 4 chains of 6 layers, C=128,
# G=256, S=128, 80 mels) behind its teacher's 16x16 upsampler, and FloWaveNet
# (8 blocks x 6 flows, 2-layer couplings of 256 channels). 22050 Hz, hop 256.
VOCODER_RATE = 22050
VOCODER_HOP = 256
VOCODER_TEMP = 0.8
VOCODER_BUCKETS = (8, 20, 40, 80)   # 8 holds the golden request alone
VOCODER_FRAMES = (20, 17, 40, 33, 80, 64, 80, 51)   # p300_000..007
VOCODER_GOLDEN = os.path.join(REPO_ROOT, "tests", "data",
                              "torch_port_vocoder_golden.npz")
GOLDEN_FRAMES = 8
# the fused chains against their plain versions on unit-scale inputs: sums
# of up to 1408 f32 terms a layer in another order, through up to 6 layers
CHAIN_TOL = dict(rtol=1e-4, atol=2e-4)
# (name, wrapper, L, k, dilations or None, T, C, G, S, cin); the first of
# each wrapper is the one timed for the kernels line
CHAIN_SHAPES = (
    ("student chain", "tiled", 6, 3, None, 20480, 128, 256, 128, 80),
    ("student chain, odd T", "tiled", 6, 3, None, 5119, 128, 256, 128, 80),
    ("whole-T chain", "chain", 6, 3, None, 4096, 128, 256, 128, 80),
    ("flow block 0", "nc", 2, 3, (1, 2), 10240, 256, 256, 256, 80),
    ("flow block 1", "nc", 2, 3, (1, 2), 5120, 256, 256, 256, 160),
    ("flow block 2", "nc", 2, 3, (1, 2), 2560, 256, 256, 256, 320),
    ("flow block 3", "nc", 2, 3, (1, 2), 1280, 256, 256, 256, 640),
    ("flow block 4", "nc", 2, 3, (1, 2), 640, 256, 256, 256, 1280),
    ("flow block 5", "nc", 2, 3, (1, 2), 320, 256, 256, 256, 2560),
    ("flow block 6", "nc", 2, 3, (1, 2), 160, 256, 256, 256, 5120),
    ("flow block 7", "nc", 2, 3, (1, 2), 80, 256, 256, 256, 10240),
    ("flow block 7, ragged T", "nc", 2, 3, (1, 2), 81, 256, 256, 256, 10240),
    ("deep dilations", "nc", 4, 3, (1, 2, 4, 8), 160, 16, 32, 16, 8),
)
# a fused server's wave against the plain server's and against the JAX
# package's golden wave (f32 conv stacks of up to ~150 layers in another
# summation order, through exp() of the flows' log-scales)
VOCODER_TOL = 1e-3
# NVIDIA's published peaks for the H100 SXM: f32 outside the tensor cores,
# dense TF32 on them, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


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


def vocoder_models():
    """{kind: (numpy params, config, server keyword arguments)} for the two
    one-pass vocoders at paper width, weights from numpy seeds."""
    from vqvae_speech_tpu_torch.convert import (
        numpy_flowavenet_params,
        numpy_gaussian_wavenet_params,
        numpy_student_params,
    )
    from vqvae_speech_tpu_torch.models.clarinet import (
        GaussianWaveNetConfig,
        StudentConfig,
    )
    from vqvae_speech_tpu_torch.models.flowavenet import FlowavenetConfig

    student, teacher, flow = (StudentConfig(), GaussianWaveNetConfig(),
                              FlowavenetConfig())
    return {
        "iaf_student": (numpy_student_params(student, SEED), student, dict(
            teacher_params=numpy_gaussian_wavenet_params(teacher, SEED + 1),
            teacher_cfg=teacher)),
        "flowavenet": (numpy_flowavenet_params(flow, SEED), flow, {}),
    }


def vocoder_golden_inputs():
    """The golden request: (mel (8, 80) in [0, 1], unit-normal z (2048, 1)),
    from a numpy seed."""
    rng = np.random.default_rng(SEED)
    mel = rng.random((GOLDEN_FRAMES, 80)).astype(np.float32)
    z = rng.standard_normal((GOLDEN_FRAMES * VOCODER_HOP, 1))
    return mel, z.astype(np.float32)


def vocoder_requests(device):
    """The vocoder slice's requests: VCTK p300_000..007 loaded at 22050 Hz by
    the port's loader (tiled to at least 81 hops), their normalized log-mel
    frames cropped to VOCODER_FRAMES: a list of (frames, 80) f32 arrays."""
    import torch
    from vqvae_speech_tpu_torch.data.audio import load_and_preprocess
    from vqvae_speech_tpu_torch.ops.mel import normalized_log_mel

    mels = []
    for i, n in enumerate(VOCODER_FRAMES):
        w, _ = load_and_preprocess(
            os.path.join(WAVE_DIR, f"p300_{i:03d}.wav"), VOCODER_RATE)
        need = (max(VOCODER_FRAMES) + 1) * VOCODER_HOP
        w = np.tile(w, -(-need // len(w)))[:need].astype(np.float32)
        mel = normalized_log_mel(torch.from_numpy(w).to(device),
                                 sr=VOCODER_RATE, hop_length=VOCODER_HOP)
        mels.append(mel[:n].cpu().numpy())
    return mels


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


def _tensor_core_instructions(_kernels):
    """A line saying how many warpgroup matrix instructions (HGMMA in SASS)
    the built chain library holds, by the toolkit's cuobjdump; raises if it
    holds none."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = os.path.join(_kernels.BUILD_DIR, "libfused_resblock.so")
    if not os.path.isfile(tool):
        return "SASS of csrc/fused_resblock.cu: cuobjdump not found, not checked"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    ops = [w for line in sass.splitlines() for w in line.split()
           if w.startswith("HGMMA")]
    if not ops:
        raise AssertionError("no HGMMA instruction in the chain kernels' SASS")
    return (f"SASS of csrc/fused_resblock.cu (cuobjdump -sass): {len(ops)} "
            f"warpgroup matrix instructions, {sorted(set(ops))}")


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


def _device_profile(fn, kernel=None, launches=None):
    """(host seconds of ``fn``, {kernel name: device microseconds}) from
    torch.profiler, through the port's guard against lost device events
    (utils/profiling.py), which raises rather than return a blank. Where
    ``kernel`` is given, a window counts only if it shows ``launches()``
    kernels whose name holds ``kernel``. ``fn`` may run more than once."""
    from vqvae_speech_tpu_torch.utils.profiling import device_events

    def check(events):
        return sum(e.count for e in events if kernel in e.key) == launches()

    window, events = device_events(fn, check=check if kernel else None)
    return window, {e.key: e.us for e in events}


def _median_seconds(fn, repeats=3):
    """Median host seconds of ``fn``, whose work ends in a device-to-host
    copy."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


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
    from vqvae_speech_tpu_torch.ops import _kernels, vq_search, vq_search_torch

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
        again = vq_search(flat, cb)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"vq_search N={N} K={K}: two runs on the "
                                 "same inputs differ")
        plan = _kernels.vq_search_plan(N, K, 64, flat.device)
        ran = _device_kernel_counts(lambda: vq_search(flat, cb))
        if sum(ran.values()) != plan["device_kernels"]:
            raise AssertionError(
                f"vq_search N={N} K={K}: the profiler saw {ran}, the plan "
                f"says {plan['device_kernels']} device kernels a search")
        ms = _median_ms(lambda: vq_search(flat, cb))
        plain_ms = _median_ms(lambda: vq_search_torch(flat, cb))
        if (N, K) == TIMED_SHAPE:
            timed = (ms, plain_ms)
        print(f"kernel vq_search N={N} K={K} D=64: near-tie rows {n_diff}, "
              f"max_abs_err {err:.3e}, two runs bit-equal, "
              f"{sum(ran.values())} device "
              f"kernel(s) a search ({plan['blocks']} blocks), kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 50, CUDA "
              "events)")
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
    sec = _median_seconds(lambda: server.encode(load), repeats=5)
    print(f"slice: {len(load)} requests in {sec * 1e3:.2f} ms (median of 5): "
          f"{len(load) / sec:.1f} requests/s, {frames / sec:.0f} frames/s "
          f"[{gpu}]")

    # the VQ kernel's own time on the device, without the host's launch cost
    def encode_once():
        _kernels.vq_search_cuda.launches = 0
        server.encode(load)

    _, busy_us = _device_profile(
        encode_once, "vq_", lambda: _kernels.vq_search_cuda.launches)
    n = _kernels.vq_search_cuda.launches
    vq_us = {k: v for k, v in busy_us.items() if "vq_" in k}
    if not vq_us or not n:
        raise AssertionError("slice: the profiler showed no vq_search kernel "
                             f"in an encode that launched it {n} times")
    print(f"slice: vq_search device time {sum(vq_us.values()) / n / 1e3:.4f} "
          f"ms a launch over {n} launches of one encode of {len(load)} "
          f"requests (torch.profiler; " + ", ".join(
              f"{k[k.index('vq_'):].split('(')[0]} {v / n:.1f} us"
              for k, v in vq_us.items())
          + f"), {sum(vq_us.values()) / sum(busy_us.values()):.4f} of the "
          f"device time [{gpu}]")
    return launches


def train_batch(device):
    """The train phase's fixed batch: TRAIN_BATCH crops of TRAIN_SAMPLES
    samples at seeded offsets of VCTK p300_000..009 (tiled where shorter) ->
    MFCC + deltas through the port's ops/dsp.py -> (64, 47, 39), standardised
    per coefficient over the batch (the experiments' ``normalize: true`` uses
    corpus statistics; the loader that computes them is a later slice)."""
    import torch
    from vqvae_speech_tpu_torch.data.audio import load_and_preprocess
    from vqvae_speech_tpu_torch.ops import speech_features

    cfg = FLAGSHIP_CONFIG
    rng = np.random.default_rng(SEED)
    crops = []
    for i in range(TRAIN_BATCH):
        w, _ = load_and_preprocess(
            os.path.join(WAVE_DIR, f"p300_{i % 10:03d}.wav"), 16000)
        w = np.tile(w, -(-2 * TRAIN_SAMPLES // len(w)))
        at = int(rng.integers(0, len(w) - TRAIN_SAMPLES))
        crops.append(w[at:at + TRAIN_SAMPLES].astype(np.float32))
    x = speech_features(
        cfg["input_features_type"],
        torch.from_numpy(np.stack(crops)).to(device), cfg["sampling_rate"],
        cfg["input_features_filters"], cfg["augment_input_features"])
    x = (x - x.mean((0, 1))) / x.std((0, 1))
    return {"input_features": x, "output_features": x}


def _train_setup(config, device):
    """(state, step) around a fresh ConvVQVAE from numpy_params(seed=0)."""
    from vqvae_speech_tpu_torch.convert import load_jax_params, numpy_params
    from vqvae_speech_tpu_torch.models import ConvVQVAE
    from vqvae_speech_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    model = load_jax_params(ConvVQVAE.from_config(config),
                            *numpy_params(config, seed=SEED))
    optimizer = make_optimizer(config["learning_rate"])
    return (create_train_state(model, optimizer, device=device, seed=SEED),
            make_train_step(config, optimizer))


def _search_against_plain(model, batch):
    """The kernel's forward and the search's backward against the plain
    search under autograd, on the model's own latents and codebook. Returns
    (near-tie rows, largest difference as a share of its tensor's scale)."""
    import torch
    import torch.nn.functional as F
    from vqvae_speech_tpu_torch.ops import (
        reference_flatten,
        vq_search,
        vq_search_torch,
    )

    with torch.no_grad():
        flat = reference_flatten(model.latents(batch["input_features"]),
                                 model.vq.codebook.shape[1]).contiguous()
    codebook = model.vq.codebook.detach().clone()
    K = codebook.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    w_q = torch.randn(flat.shape, device="cuda", generator=gen)
    w_dw = torch.randn(codebook.shape, device="cuda", generator=gen)

    f_k, c_k = flat.clone().requires_grad_(), codebook.clone().requires_grad_()
    got = vq_search(f_k, c_k)
    ((got.quantized * w_q).sum() + (got.dw * w_dw).sum()).backward()
    n_diff = _near_ties(flat, codebook, got.indices,
                        vq_search_torch(flat, codebook).indices,
                        NEAR_TIE_SAME_INPUT)
    # the plain chain on the kernel's own indices (the plain search's, when
    # no row differs), differentiated by autograd
    f_p, c_p = flat.clone().requires_grad_(), codebook.clone().requires_grad_()
    onehot = F.one_hot(got.indices.long(), K).float()
    quantized, counts, dw = onehot @ c_p, onehot.sum(0), onehot.t() @ f_p
    ((quantized * w_q).sum() + (dw * w_dw).sum()).backward()
    worst = 0.0
    for name, a, b in (("quantized", got.quantized, quantized),
                       ("counts", got.counts, counts), ("dw", got.dw, dw),
                       ("g_flat", f_k.grad, f_p.grad),
                       ("g_codebook", c_k.grad, c_p.grad)):
        scale = max(1.0, b.detach().abs().max().item())
        err = (a.detach() - b.detach()).abs().max().item() / scale
        if not err <= TRAIN_KERNEL_TOL:
            raise AssertionError(f"train: {name} of the kernel path is "
                                 f"{err:.3e} of its scale from the plain "
                                 "search's")
        worst = max(worst, err)
    return n_diff, worst


def train_phase(gpu):
    """The flagship train step on the card; returns (kernel launches, the VQ
    kernel's device ms a launch, the gradient VQ's ms a step)."""
    import torch
    from vqvae_speech_tpu_torch.nn import jitter_masks
    from vqvae_speech_tpu_torch.ops import _kernels

    base = dict(FLAGSHIP_CONFIG, use_jitter=True,
                learning_rate=TRAIN_LEARNING_RATE)
    batch = train_batch("cuda")
    shape = tuple(batch["input_features"].shape)
    if shape != (TRAIN_BATCH, 47, 39):
        raise AssertionError(f"train batch shape {shape}")
    total_launches, vq_device_ms, step_ms = 0, None, {}
    for name, config in (("gradient VQ", base),
                         ("EMA VQ", dict(base, decay=0.99))):
        state, step = _train_setup(config, "cuda")
        before = _kernels.vq_search_cuda.launches
        losses, recons = [], []
        for _ in range(TRAIN_WARMUP):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            recons.append(metrics["reconstruction_loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            recons.append(metrics["reconstruction_loss"])
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / TRAIN_STEPS
        step_ms[name] = sec * 1e3
        launches = _kernels.vq_search_cuda.launches - before
        total_launches += launches
        if launches != TRAIN_WARMUP + TRAIN_STEPS:
            raise AssertionError(
                f"train [{name}]: {launches} vq_search launches in "
                f"{TRAIN_WARMUP + TRAIN_STEPS} steps")
        losses, recons = torch.stack(losses).cpu(), torch.stack(recons).cpu()
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"train [{name}]: non-finite loss")
        # the reconstruction term is the one held to fall: on one repeated
        # batch at this width the gradient quantizer's latents outrun its
        # codebook (the reference's drift: the JAX step's VQ terms grow the
        # same way, tests/test_torch_train_step.py), which the total shows
        if not recons[-1] < recons[0]:
            raise AssertionError(
                f"train [{name}]: reconstruction loss {recons[0]:.4f} -> "
                f"{recons[-1]:.4f} did not fall")
        print(f"train [{name}]: batch {TRAIN_BATCH} x 47 frames, "
              f"{TRAIN_WARMUP} + {TRAIN_STEPS} steps, one vq_search launch a "
              f"step; reconstruction loss {recons[0]:.4f} -> "
              f"{recons[-1]:.4f}, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(largest {losses.max():.4f}), perplexity "
              f"{metrics['perplexity'].item():.2f}; {sec * 1e3:.3f} ms a "
              f"step, {1 / sec:.1f} steps/s (host clock around "
              f"{TRAIN_STEPS} steps ending in a sync) [{gpu}]")

        n_diff, worst = _search_against_plain(state.model, batch)
        print(f"train [{name}]: kernel forward and search backward on the "
              f"step's latents vs the plain search under autograd: near-tie "
              f"rows {n_diff}, quantized, counts, dw, g_flat, g_codebook "
              f"within {worst:.2e} of their scale (limit {TRAIN_KERNEL_TOL})")

        n_prof = 10
        before = _kernels.vq_search_cuda.launches
        window, busy_us = _device_profile(
            lambda: [step(state, batch) for _ in range(n_prof)],
            "vq_", lambda: n_prof)
        total_launches += _kernels.vq_search_cuda.launches - before
        total_us = sum(busy_us.values())

        def share(pick):
            return sum(v for k, v in busy_us.items()
                       if pick(k.lower())) / total_us

        def is_conv(k):
            return any(n in k for n in ("cudnn", "xmma", "conv",
                                        "implicit", "cutlass", "gemm"))

        def is_bwd(k):
            return any(n in k for n in ("wgrad", "dgrad", "bwd",
                                        "backward"))

        vq_us = sum(v for k, v in busy_us.items() if "vq_" in k)
        if not vq_us > 0:
            raise AssertionError(f"train [{name}]: the profiler showed no "
                                 "vq_search kernel in the steps")
        vq_device_ms = vq_us / n_prof / 1e3
        print(f"train [{name}] profile ({n_prof} steps, torch.profiler "
              f"CUDA activity): window {window / n_prof * 1e3:.3f} ms a "
              f"step, device busy {total_us / n_prof / 1e3:.3f} ms a "
              f"step, idle share {1 - total_us / 1e6 / window:.3f}; "
              f"vq_search {vq_device_ms:.5f} ms a step "
              f"({vq_us / total_us:.4f} of device time), convolution "
              f"kernels forward {share(lambda k: is_conv(k) and not is_bwd(k)):.3f}"
              f" and backward {share(lambda k: is_conv(k) and is_bwd(k)):.3f}"
              f" (by kernel name), optimizer (multi_tensor_apply) "
              f"{share(lambda k: 'multi_tensor' in k):.3f} [{gpu}]")
        for key, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / n_prof / 1e3:10.4f} ms a step  {key[:100]}")
        del state
        torch.cuda.empty_cache()

    # one whole step on the card against the same step on the CPU: same
    # weights, batch and jitter masks
    masks = jitter_masks(24, base["jitter_probability"],
                         generator=torch.Generator().manual_seed(SEED))
    results = {}
    for device in ("cuda", "cpu"):
        state, step = _train_setup(base, device)
        on_device = {k: v.to(device) for k, v in batch.items()}
        before = _kernels.vq_search_cuda.launches
        state, metrics = step(state, on_device, jitter_masks=masks)
        total_launches += _kernels.vq_search_cuda.launches - before
        results[device] = (metrics["loss"].item(),
                           state.model.vq.codebook.detach().cpu())
    (loss_gpu, cb_gpu), (loss_cpu, cb_cpu) = results["cuda"], results["cpu"]
    cb_err = (cb_gpu - cb_cpu).abs().max().item()
    if abs(loss_gpu - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu):
        raise AssertionError(f"train: one step's loss {loss_gpu} on the card "
                             f"vs {loss_cpu} on the CPU")
    if not cb_err <= TRAIN_CODEBOOK_ATOL:
        raise AssertionError(f"train: updated codebook {cb_err:.3e} from the "
                             "CPU step's")
    print(f"train: one step on the card vs the same step on the CPU (same "
          f"weights, batch, jitter masks): loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f}, updated codebook within {cb_err:.2e} (limits "
          f"{TRAIN_LOSS_RTOL} relative, {TRAIN_CODEBOOK_ATOL})")
    return total_launches, vq_device_ms, step_ms["gradient VQ"]


# the experiment phase: the flagship run of the CLI's default mode,
# configurations/experiments_vq44-mfcc39.json's "jitter12" experiment
# unchanged (768 hidden, K=44, D=64, batch 2, normalize, jitter 0.12, the
# gradient VQ, learning rate 2e-4 from configurations/vctk_features.yaml)
# except num_epochs, cut from 15 to 2, then raised to 3 in the frozen config
# for the resume; on the tracked VCTK subset (quality_parity/raw, 400 wavs,
# a 0.8 split: 320 train utterances, 160 steps an epoch at batch 2)
EXPERIMENTS_SPEC = os.path.join("configurations", "experiments_vq44-mfcc39.json")
EXPERIMENT = "jitter12"
EXPERIMENT_EPOCHS, RESUMED_EPOCHS = 2, 3
CORPUS_ROOT = os.path.join(REPO_ROOT, "quality_parity", "raw")
EXPERIMENT_BARE_STEPS = 50
SERVE_MAX_BATCH = 40
# the server's normalized MFCCs of the val waves against the exported ones
# normalized alike: the same f32 pipeline on the card at another batch size
# (40 waves a launch, 256 in the export), divided by the train std
SERVE_FEATURE_TOL = 1e-3


def _cli(work, *args):
    """One run of the port's CLI in ``work``; returns (seconds, stdout)."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "vqvae_speech_tpu_torch.main", *args],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"experiment: `main {' '.join(args)}` exited "
                             f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    return sec, out.stdout


def _epoch_losses(ckpt):
    recon = [e["reconstruction_loss"] for e in ckpt["train_res_recon_error"]]
    total = [e["loss"] for e in ckpt["train_res_recon_error"]]
    return np.asarray(recon), np.asarray(total)


def _experiment_workdir(work):
    """configurations/ (the base YAML linked, the experiments JSON with
    jitter12 alone and num_epochs cut) and data/vctk/raw linked to the
    tracked corpus, as the CLI expects them under its working directory."""
    with open(os.path.join(REPO_ROOT, EXPERIMENTS_SPEC)) as f:
        spec = json.load(f)
    spec["experiments"] = {EXPERIMENT: dict(spec["experiments"][EXPERIMENT],
                                            num_epochs=EXPERIMENT_EPOCHS)}
    os.makedirs(os.path.join(work, "configurations"))
    os.symlink(os.path.join(REPO_ROOT, "configurations", "vctk_features.yaml"),
               os.path.join(work, "configurations", "vctk_features.yaml"))
    with open(os.path.join(work, EXPERIMENTS_SPEC), "w") as f:
        json.dump(spec, f, indent=4)
    os.makedirs(os.path.join(work, "data", "vctk"))
    os.symlink(CORPUS_ROOT, os.path.join(work, "data", "vctk", "raw"))
    return spec


def experiment_phase(gpu):
    """The flagship's training loop through the port's CLI, resumed, then
    the loop in process and the trained checkpoint served; returns (the VQ
    kernel's launches on that path, the loop's ms a step without the
    checkpoint, the bare step's at batch 2)."""
    import shutil
    import tempfile

    import torch
    from vqvae_speech_tpu_torch.data import FeatureStore, load_normalizer
    from vqvae_speech_tpu_torch.data.export import export_to_features
    from vqvae_speech_tpu_torch.data.prefetch import prefetch_to_device
    from vqvae_speech_tpu_torch.data.vctk import VCTK
    from vqvae_speech_tpu_torch.ops import _kernels, vq_search_torch
    from vqvae_speech_tpu_torch.serve import BucketedEncodeServer
    from vqvae_speech_tpu_torch.train import (
        Experiment,
        find_checkpoints,
        freeze_configuration,
        load_checkpoint,
        load_configuration,
        update_configuration_from_experiments,
    )
    from vqvae_speech_tpu_torch.utils.profiling import device_events

    work = tempfile.mkdtemp(prefix="chip_smoke_experiment_")
    here = os.getcwd()
    try:
        spec = _experiment_workdir(work)
        export_sec, _ = _cli(work, "--export_to_features")
        stats_sec, _ = _cli(work, "--compute_dataset_stats")
        train_sec, train_out = _cli(work)
        os.chdir(work)
        base = update_configuration_from_experiments(
            EXPERIMENTS_SPEC, load_configuration(os.path.join(
                "configurations", "vctk_features.yaml")))
        features = os.path.join("data", "vctk", base["features_path"])
        store = FeatureStore(features)
        n = {}
        for split in ("train", "val"):
            data = store.open(split)
            n[split] = data["speaker_ids"].shape[0]
            for column, shape in (("input_features", (47, 39)),
                                  ("output_features", (47, 39)),
                                  ("preprocessed_audio", (7681,))):
                got = tuple(data[column].shape)
                if got != (n[split],) + shape:
                    raise AssertionError(f"experiment: {split}.{column} "
                                         f"shape {got}")
        if (n["train"], n["val"]) != (320, 80):
            raise AssertionError(f"experiment: {n} utterances exported of "
                                 "the 320 / 80 split")
        normalizer = load_normalizer(base["normalizer_path"])
        if normalizer["train_mean"].shape != (39,):
            raise AssertionError("experiment: normalizer of shape "
                                 f"{normalizer['train_mean'].shape}")
        exp_dir = spec["experiments_path"]
        steps = n["train"] // spec["experiments"][EXPERIMENT]["batch_size"]
        epochs = [e for e, _ in find_checkpoints(exp_dir, EXPERIMENT)]
        if epochs != list(range(1, EXPERIMENT_EPOCHS + 1)):
            raise AssertionError(f"experiment: checkpoints of epochs {epochs}")
        recon, total = zip(*(
            _epoch_losses(load_checkpoint(path))
            for _, path in find_checkpoints(exp_dir, EXPERIMENT)))
        if not all(np.isfinite(r).all() and np.isfinite(t).all() and
                   len(r) == steps for r, t in zip(recon, total)):
            raise AssertionError("experiment: non-finite losses or a loss "
                                 "list of another length than the epoch")
        if not recon[1].mean() < recon[0].mean():
            raise AssertionError(
                f"experiment: mean reconstruction loss {recon[0].mean():.4f} "
                f"in epoch 1, {recon[1].mean():.4f} in epoch 2")

        # the resume: num_epochs 3 in the frozen config, the CLI again
        frozen = os.path.join(exp_dir, f"{EXPERIMENT}_configuration.yaml")
        freeze_configuration(dict(load_configuration(frozen),
                                  num_epochs=RESUMED_EPOCHS), exp_dir,
                             EXPERIMENT)
        resume_sec, resume_out = _cli(work)
        found = find_checkpoints(exp_dir, EXPERIMENT)
        if [e for e, _ in found] != list(range(1, RESUMED_EPOCHS + 1)):
            raise AssertionError(f"experiment: after the resume, checkpoints "
                                 f"{[e for e, _ in found]}")
        last = load_checkpoint(found[-1][1])
        count = int(np.asarray(last["opt_state"][0][0]))
        if count != RESUMED_EPOCHS * steps:
            raise AssertionError(f"experiment: optimizer count {count} after "
                                 f"{RESUMED_EPOCHS} epochs of {steps} steps")
        if (f"Epoch {RESUMED_EPOCHS}: loss" not in resume_out
                or "Epoch 1: loss" in resume_out):
            raise AssertionError("experiment: the resumed run's log is not "
                                 f"epoch {RESUMED_EPOCHS}'s alone:\n"
                                 + resume_out[-2000:])
        r3, _ = _epoch_losses(last)
        print(f"experiment: CLI in a fresh directory: export {export_sec:.2f} "
              f"s ({n['train']} train + {n['val']} val utterances, (N, 47, "
              f"39) and (N, 7681)), stats {stats_sec:.2f} s, {EXPERIMENT} "
              f"{EXPERIMENT_EPOCHS} epochs {train_sec:.2f} s, resumed to "
              f"epoch {RESUMED_EPOCHS} {resume_sec:.2f} s (wall clock of "
              f"each process, start-up included); checkpoints 1-3, "
              f"optimizer count {count} = {RESUMED_EPOCHS} x {steps}; mean "
              f"reconstruction loss by epoch {recon[0].mean():.4f}, "
              f"{recon[1].mean():.4f}, {r3.mean():.4f}; mean loss "
              f"{total[0].mean():.4f}, {total[1].mean():.4f} [{gpu}]")
        print("  " + [line for line in train_out.splitlines()
                      if "Epoch 1: loss" in line][0].strip())

        # export in process: utterances/s without the process start
        corpus = VCTK(os.path.join("data", "vctk"),
                      ratio=base["train_val_split"])
        t0 = time.perf_counter()
        export_to_features(corpus, "exported_again", base, device="cuda")
        export_rate = len(corpus.audios) / (time.perf_counter() - t0)

        # the loop in process: a fresh run of one epoch on the same store
        exp = Experiment(EXPERIMENT, "in_process", "results", base,
                         dict(spec["experiments"][EXPERIMENT], num_epochs=1),
                         spec["seed"], device="cuda")
        # the trainer, not this script, sets the f32 numerics the CLI runs
        torch.backends.cudnn.allow_tf32 = True
        trainer = exp.build_trainer(device="cuda")
        if torch.backends.cudnn.allow_tf32:
            raise AssertionError("experiment: the trainer left cuDNN's TF32 "
                                 "on")
        torch.cuda.synchronize()
        _kernels.vq_search_cuda.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        epoch_sec = time.perf_counter() - t0
        launches = _kernels.vq_search_cuda.launches
        t0 = time.perf_counter()
        trainer.save(0)          # the epoch's checkpoint once more, timed
        save_sec = time.perf_counter() - t0
        if launches != steps:
            raise AssertionError(f"experiment: {launches} vq_search launches "
                                 f"in an epoch of {steps} steps")

        loader_a, loader_b = exp._build_loader(), exp._build_loader()
        busy = torch.randn(1024, 1024, device="cuda")
        n_batches = 0
        for got, want in zip(prefetch_to_device(iter(loader_a),
                                                device="cuda"),
                             iter(loader_b)):
            for _ in range(2):      # the consumer's stream stays busy
                busy = torch.tanh(busy @ busy * 1e-3)
            for key, value in want.items():
                if not torch.equal(got[key].cpu(), torch.from_numpy(value)):
                    raise AssertionError(f"experiment: prefetched batch "
                                         f"{n_batches} {key} differs from "
                                         "the loader's")
            n_batches += 1
        if n_batches != steps:
            raise AssertionError(f"experiment: {n_batches} prefetched batches")

        profiled = exp.build_trainer(device="cuda")
        profiled.save = lambda *args, **kwargs: None   # the loop alone

        def epoch():
            _kernels.vq_search_cuda.launches = 0
            profiled.train()

        def check(events):
            return sum(e.count for e in events if "vq_" in e.key) == \
                _kernels.vq_search_cuda.launches == steps

        window, events = device_events(epoch, check=check)
        busy_us = sum(e.us for e in events)
        batch = next(prefetch_to_device(iter(loader_a), device="cuda"))
        state, step = trainer.state, trainer._step
        for _ in range(5):
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXPERIMENT_BARE_STEPS):
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) / EXPERIMENT_BARE_STEPS * 1e3
        print(f"experiment: in process, {EXPERIMENT} epoch of {steps} steps "
              f"at batch 2 through Experiment.build_trainer(device='cuda'): "
              f"{epoch_sec:.3f} s with its checkpoint ({save_sec:.3f} s to "
              f"write alone), {steps / epoch_sec:.1f} steps/s; without the "
              f"checkpoint {(epoch_sec - save_sec) / steps * 1e3:.3f} ms a "
              f"step (loader, prefetch, step, one metrics copy); one vq_search "
              f"launch a step ({launches}); {n_batches} prefetched batches "
              f"bit-equal to the loader's under a busy stream; the bare step "
              f"on one prefetched batch {bare_ms:.3f} ms (batch 2, mean of "
              f"{EXPERIMENT_BARE_STEPS} steps ending in a sync); export in "
              f"process {export_rate:.1f} utterances/s [{gpu}]")
        print(f"experiment profile (one epoch without its checkpoint write, "
              f"torch.profiler CUDA activity): "
              f"window {window:.3f} s, device busy {busy_us / 1e6:.3f} s, "
              f"idle share {1 - busy_us / 1e6 / window:.3f}, vq_search "
              f"{sum(e.us for e in events if 'vq_' in e.key) / steps:.2f} "
              f"us a step [{gpu}]")
        for e in sorted(events, key=lambda e: -e.us)[:6]:
            print(f"  {e.us / steps / 1e3:10.4f} ms a step  {e.key[:100]}")

        # the trained checkpoint serves: the val split through the encode
        # server, codes against the plain search on its own latents
        server = BucketedEncodeServer(
            last["params"], last["model_state"], load_configuration(frozen),
            wave_buckets=(7681,), max_batch=SERVE_MAX_BATCH,
            normalizer=normalizer, device="cuda")
        waves = list(np.asarray(store.open("val")["preprocessed_audio"]))
        before = _kernels.vq_search_cuda.launches
        results = server.encode(waves)
        serve_launches = _kernels.vq_search_cuda.launches - before
        if serve_launches != -(-len(waves) // SERVE_MAX_BATCH):
            raise AssertionError(f"experiment: {serve_launches} vq_search "
                                 f"launches serving {len(waves)} waves")
        codebook = server.model.vq.codebook.detach()
        D = codebook.shape[1]
        n_diff = 0
        feature_err = 0.0
        val_features = torch.from_numpy(np.array(
            store.open("val")["input_features"])).cuda()
        mean = torch.from_numpy(normalizer["train_mean"]).float().cuda()
        std = torch.from_numpy(normalizer["train_std"]).float().cuda()
        for at in range(0, len(waves), SERVE_MAX_BATCH):
            rows = list(range(at, min(at + SERVE_MAX_BATCH, len(waves))))
            with torch.inference_mode():
                feats = server.features(server.padded_batch(
                    [waves[i] for i in rows], 7681))[:len(rows)]
                z = server.model.latents(feats)
            want_feats = (val_features[rows] - mean) / std
            feature_err = max(feature_err,
                              (feats - want_feats).abs().max().item())
            flat = z.contiguous().view(-1, D)
            served = torch.from_numpy(np.concatenate(
                [results[i].codes for i in rows])).cuda()
            n_diff += _near_ties(flat, codebook, served,
                                 vq_search_torch(flat, codebook).indices,
                                 NEAR_TIE_SAME_INPUT)
        if not feature_err <= SERVE_FEATURE_TOL:
            raise AssertionError(f"experiment: the server's features are "
                                 f"{feature_err:.3e} from the store's")
        codes = np.concatenate([r.codes for r in results])
        if codes.shape != (len(waves) * 24,):
            raise AssertionError(f"experiment: codes of shape {codes.shape}")
        print(f"experiment: the epoch-{RESUMED_EPOCHS} checkpoint and the "
              f"normalizer in BucketedEncodeServer: {len(waves)} val "
              f"utterances -> {codes.size} codes in {serve_launches} "
              f"launches, near-tie rows vs the plain search on the server's "
              f"latents {n_diff}, {len(np.unique(codes))} of "
              f"{codebook.shape[0]} codes used; the server's normalized "
              f"features within {feature_err:.2e} of the store's (limit "
              f"{SERVE_FEATURE_TOL})")
        return (launches + serve_launches,
                (epoch_sec - save_sec) / steps * 1e3, bare_ms)
    finally:
        os.chdir(here)
        shutil.rmtree(work)


def _device_kernel_counts(fn):
    """{name: launches} of everything that ran on the device (kernels,
    memsets, copies) in one call of ``fn``, from torch.profiler."""
    from vqvae_speech_tpu_torch.utils.profiling import device_events

    return {e.key: e.count for e in device_events(fn)[1]}


def _us(row):
    return ", ".join(f"{k} {v:.2f}" for k, v in row.items())


def _step_phase_profile(step, x0, taps, cond):
    """Where one launch of the decode-step kernel spends its time, from the
    stamps its blocks record. Per kind of phase (gate, projection), the mean
    over the layers of: the phase's length (first block released to first
    block released, on the global timer); the slowest block's staging,
    products and partial-sum stores (on each SM's cycle counter, scaled by
    that block's cycles per nanosecond over the launch); and what is left,
    the barrier and the blocks' spread. Microseconds."""
    import torch

    info = step.describe()
    L = step.shapes["cond"][0]
    stamps = torch.zeros((info["blocks"], 2 * L, 4, 2), dtype=torch.int64,
                         device=x0.device)
    for _ in range(3):
        step(x0, taps, cond, stamps=stamps)
    torch.cuda.synchronize()
    t = stamps.cpu().numpy().astype(np.float64)
    ns, cyc = t[..., 0], t[..., 1]
    # cycles per microsecond of each block's SM, over the whole launch
    rate = ((cyc[:, -1, 3] - cyc[:, 0, 0])
            / (ns[:, -1, 3] - ns[:, 0, 0]) * 1e3)[:, None]
    out = {}
    for kind, first, used in (("gate", 0, info["gate_tiles"]
                               * info["gate_slices"]),
                              ("proj", 1, info["proj_tiles"]
                               * info["proj_slices"])):
        p = np.arange(first, 2 * L - 2, 2)       # phases with a successor
        c = cyc[:used][:, p] / rate[:used, None]  # (used, phases, 4) in us
        row = dict(
            phase=(ns[:, p + 1, 0].min(0) - ns[:, p, 0].min(0)) / 1e3,
            stage=(c[..., 1] - c[..., 0]).max(0),
            products=(c[..., 2] - c[..., 1]).max(0),
            store=(c[..., 3] - c[..., 2]).max(0))
        row["rest"] = (row["phase"] - row["stage"] - row["products"]
                       - row["store"])
        out[kind] = {k: float(np.mean(v)) for k, v in row.items()}
    out["launch"] = float(ns[:, -1, 3].max() - ns[:, 0, 0].min()) / 1e3
    out["mhz"] = float(np.mean(rate))
    return out


def step_kernel_phase(gpu):
    """glu_stack_step (the kernel) against glu_stack_step_torch on the same
    CUDA tensors: the prepared weights of numpy_wavenet_params(seed=0) at
    the vctk_wavenet width (random ones at the narrow width), unit-scale x0,
    taps and cond. Tolerance rtol 1e-4 (the JAX test's bound for its kernel)
    and atol 1e-4 (sums of up to 2304 f32 terms in another order). Two runs
    on the same inputs must agree bit for bit. Timed: the prepared step, as
    the decode loop calls it."""
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
    from vqvae_speech_tpu_torch.ops import (
        glu_stack_step,
        glu_stack_step_torch,
        prepare_glu_stack_step,
    )

    cfg = wavenet_config_from(WAVENET_CONFIG, WAVENET_CONFIG["num_speakers"])
    rng = np.random.default_rng(SEED)
    names = ("wtap", "bias", "wskip", "bskip", "wout", "bout")

    def unit(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    weights = {}
    max_err, timed = 0.0, None
    with torch.inference_mode():
        for B, k, legacy, width in STEP_SHAPES:
            key = (k, None if width is None else tuple(width.items()))
            if key not in weights and width is None:
                kcfg = dataclasses.replace(cfg, kernel_size=k)
                module = load_wavenet_params(
                    WaveNet(kcfg), numpy_wavenet_params(kcfg, SEED)).cuda()
                w = prepare_decode_weights(module, kcfg)
                weights[key] = {n: w[n] for n in names}
                del module
            elif key not in weights:
                L, C, G, S = (width[n] for n in "LCGS")
                weights[key] = dict(
                    wtap=unit(L, k, C, G, scale=(k * C) ** -0.5),
                    bias=unit(L, G, scale=0.1),
                    wskip=unit(L, G // 2, S, scale=(G // 2) ** -0.5),
                    bskip=unit(L, S, scale=0.1),
                    wout=unit(L, G // 2, C, scale=(G // 2) ** -0.5),
                    bout=unit(L, C, scale=0.1))
            w = weights[key]
            L, _, C, G = w["wtap"].shape

            args = dict(x0=unit(B, C), taps=unit(L, k - 1, B, C),
                        cond=unit(L, B, G), **w)
            got = glu_stack_step(legacy=legacy, **args)
            again = glu_stack_step(legacy=legacy, **args)
            want = glu_stack_step_torch(legacy=legacy, **args)
            torch.cuda.synchronize()
            err = 0.0
            for g, g2, p in zip(got, again, want):
                torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4)
                if not torch.equal(g, g2):
                    raise AssertionError(
                        f"glu_stack_step B={B} k={k}: two runs on the same "
                        "inputs differ")
                err = max(err, (g - p).abs().max().item())
            max_err = max(max_err, err)
            step = prepare_glu_stack_step(*(w[n] for n in names), batch=B,
                                          legacy=legacy)
            x0, taps, cond = args["x0"], args["taps"], args["cond"]
            for g, p in zip(step(x0, taps, cond), got):
                if not torch.equal(g, p):
                    raise AssertionError("the prepared step and "
                                         "glu_stack_step differ")
            ms = _per_launch_ms(lambda: step(x0, taps, cond))
            # the kernel's own time on the device, without launch gaps
            _, busy_us = _device_profile(
                lambda: [step(x0, taps, cond) for _ in range(20)],
                "step_kernel", lambda: 20)
            device = f"{sum(busy_us.values()) / 20 / 1e3:.4f} ms a launch"
            plain_ms = _per_launch_ms(
                lambda: glu_stack_step_torch(legacy=legacy, **args))
            weight_bytes = 4 * sum(w[n].numel() for n in ("wtap", "wskip",
                                                           "wout"))
            gbps = weight_bytes / (ms * 1e-3) / 1e9
            bound_ms, _ = wavenet_step_bound(L, k, B, C, G,
                                             w["wskip"].shape[2])
            if (B, k, legacy, width) == TIMED_STEP:
                timed = (ms, plain_ms)
                counts = _device_kernel_counts(lambda: step(x0, taps, cond))
                print(f"kernel glu_stack_step: one prepared step launches "
                      f"{sum(counts.values())} device kernels, memsets and "
                      f"copies (torch.profiler): {counts}; launch "
                      f"{step.describe()}")
            if width is None and k == 3 and legacy:
                prof = _step_phase_profile(step, x0, taps, cond)
                print(f"kernel glu_stack_step B={B}: inside one launch, us "
                      f"a phase (mean over layers; the slowest block's "
                      f"staging, products, stores; the rest is the barrier "
                      f"and the blocks' spread): gate {_us(prof['gate'])}; "
                      f"projection {_us(prof['proj'])}; first phase start "
                      f"to last store {prof['launch']:.1f} us; SM clock "
                      f"{prof['mhz']:.0f} MHz")
            print(f"kernel glu_stack_step L={L} k={k} B={B} C={C} G={G} "
                  f"S={w['wskip'].shape[2]} legacy={legacy}: max_abs_err "
                  f"{err:.3e}, two runs bit-equal; kernel {ms:.4f} ms/step "
                  f"({gbps:.0f} GB/s of {weight_bytes / 1e6:.1f} MB weights, "
                  f"bound {bound_ms:.4f} ms, {bound_ms / ms:.3f} of the "
                  f"kernel's time), plain {plain_ms:.4f} ms/step (mean of "
                  f"100 back-to-back launches, CUDA events); kernel's "
                  f"device time {device} (torch.profiler, 20 launches) "
                  f"[{gpu}]")
    return max_err, timed


def synthesis_phase(gpu):
    """WaveNet-VQ-VAE synthesis serving at the vctk_wavenet width."""
    import torch
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
    def synthesize_once():
        _kernels.wavenet_step_cuda.launches = 0
        server.synthesize([lcs[i] for i in idx], [speakers[i] for i in idx])

    window, busy_us = _device_profile(
        synthesize_once, "step_kernel",
        lambda: _kernels.wavenet_step_cuda.launches)
    total_us = sum(busy_us.values())
    kernel_us = sum(v for k, v in busy_us.items() if "step_kernel" in k)
    print(f"synthesis profile (bucket {bucket}, torch.profiler CUDA "
          f"activity): window {window:.3f} s, device busy "
          f"{total_us / 1e6:.3f} s, idle share "
          f"{1 - total_us / 1e6 / window:.3f}; decode-step kernels "
          f"{kernel_us / total_us:.3f} of device time [{gpu}]")
    for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:10.2f} ms  {name[:100]}")
    return step_launches, vq_launches


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for work of
    ``flops`` f32 operations outside the tensor cores and ``nbytes`` bytes
    moved once, at the published peaks."""
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def vq_search_bound(N, K, D):
    """The codebook search: distances 2*N*K*D flops and the dw sums N*D;
    flat and codebook read once, indices, quantized, counts, dw written."""
    return _bound(2 * N * K * D + N * D,
                  4 * (N * D + K * D + N + N * D + K + K * D))


def wavenet_step_bound(L, k, B, C, G, S):
    """One decode step: every weight read once (2*B flops an element), the
    inputs x0, taps, cond and biases read, x, skip and x_all written."""
    weights = L * (k * C * G + G // 2 * (S + C))
    io = (B * C + L * (k - 1) * B * C + L * B * G + L * (G + S + C)
          + B * C + B * S + L * B * C)
    return _bound(2 * B * weights, 4 * (weights + io))


def chain_bound(L, k, T, C, G, S, cin):
    """One fused chain: per row and layer the gate products
    2*(k*C + cin)*2G and the projections 2*G*(C + S); x, c_up and the
    weights read once, x and skip written once. Returns (bound_ms, bound_by,
    tensor_bound_ms): the bound at the f32 rate outside the tensor cores,
    the function's work at the rate the kernels were first held to, and the
    least time the error-compensated TF32 design could take, three TF32
    products a f32 product at the tensor cores' dense TF32 peak (or the
    bytes' time if larger)."""
    flops = T * L * (2 * (k * C + cin) * 2 * G + 2 * G * (C + S))
    weights = L * (2 * k * C * G + 2 * cin * G + G * (C + S) + 2 * G + C + S)
    nbytes = 4 * (T * (C + cin) + weights + T * (C + S))
    tensor_ms = max(3 * flops / PEAK_TF32_FLOPS,
                    nbytes / PEAK_BYTES_PER_S) * 1e3
    return (*_bound(flops, nbytes), tensor_ms)


def _random_chain(rng, L, k, T, C, G, S, cin):
    """Unit-scale x (T, C) and c_up (T, cin) and stacked chain weights scaled
    by 1/sqrt(fan-in), as a weight-normed init gives them, on the card."""
    import torch

    def f(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    fan = (k * C + cin) ** -0.5
    stacked = dict(
        wf=f((L, k, C, G), fan), wg=f((L, k, C, G), fan),
        wfc=f((L, cin, G), fan), wgc=f((L, cin, G), fan),
        wres=f((L, G, C), G ** -0.5), wskip=f((L, G, S), G ** -0.5),
        bf=f((L, G), 0.1), bg=f((L, G), 0.1), bres=f((L, C), 0.1),
        bskip=f((L, S), 0.1))
    return f((T, C)), f((T, cin)), stacked


def _main_loop_check(rng):
    """One bare product of the chain kernels' tensor-core main loop against
    torch.matmul in f32 at the student gate's size, and the same product
    with the lo parts dropped (one TF32 product): max abs errors against a
    float64 product. A check of the loop, not a path of the port."""
    import torch
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.ops.fused_resblock import split_tf32

    M, N, K = 20480, 512, 464
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda()
    b = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                         .astype(np.float32)).cuda()
    hi, lo = (t.contiguous() for t in split_tf32(b.t().contiguous()))
    got = _kernels.tf32x3_matmul_cuda(a, hi, lo)
    coarse = _kernels.tf32x3_matmul_cuda(split_tf32(a)[0], hi,
                                         torch.zeros_like(lo))
    want = a @ b
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    exact = a.double() @ b.double()
    errs = [(t.double() - exact).abs().max().item()
            for t in (got, want, coarse)]
    ms = _median_ms(lambda: _kernels.tf32x3_matmul_cuda(a, hi, lo), iters=20)
    print(f"kernel fused_block_chain main loop: ({M}, {K}) @ ({K}, {N}) by "
          f"wgmma in error-compensated TF32: max abs err against float64 "
          f"{errs[0]:.3e} (torch.matmul f32 {errs[1]:.3e}; one TF32 product "
          f"{errs[2]:.3e}); within rtol 1e-5, atol 2e-5 of torch.matmul; "
          f"{ms:.4f} ms, {3 * 2 * M * N * K / ms / 1e9:.0f} TFLOP/s of TF32 "
          f"work")


def _gemm_yardstick(gpu, L=6, T=20480):
    """What cuBLAS takes for the student chain's products alone, (T, 464) @
    (464, 512) and (T, 256) @ (256, 256) L times, in f32 and in one-pass
    TF32. The port never calls it; allow_tf32 is restored."""
    import torch

    rng = np.random.default_rng(SEED)
    mats = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda() for shape in ((T, 464), (464, 512), (T, 256), (256, 256))]

    def products():
        for _ in range(L):
            torch.matmul(mats[0], mats[1])
            torch.matmul(mats[2], mats[3])

    old = torch.backends.cuda.matmul.allow_tf32
    try:
        times = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            times[tf32] = _median_ms(products, iters=20, warmup=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    print(f"yardstick: the student chain's products alone at T={T}, {L} x "
          f"[({T}, 464) @ (464, 512) + ({T}, 256) @ (256, 256)] by "
          f"torch.matmul: {times[False]:.4f} ms in f32, {times[True]:.4f} ms "
          f"with allow_tf32 (one TF32 product a f32 product; 3 x that is "
          f"{3 * times[True]:.4f} ms); no bias, activation or epilogue "
          f"[{gpu}]")


def chain_kernel_phase(gpu):
    """The three fused-chain entry points (the kernels) against their plain
    PyTorch chains on the same CUDA tensors, within CHAIN_TOL, and bit-equal
    over two runs. The kernel's prepared weights are held against the same
    layout built with tensor operations, and a chain bound once
    (prepare_block_chain) against the bare call, bit for bit. Times each
    shape on prepared weights, as the shapes route it and forced onto the
    row-tiled and the split decomposition (the shapes choose one; the other
    shows where the switch lies), holding both against the plain chain.
    Returns {wrapper: its kernels-line numbers at the first shape listed
    for it}."""
    import torch
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.ops import fused_resblock as fused

    calls = {
        "tiled": (fused.fused_block_chain_tiled,
                  fused.fused_block_chain_tiled_torch,
                  _kernels.fused_block_chain_tiled_cuda),
        "chain": (fused.fused_block_chain, fused.fused_block_chain_torch,
                  _kernels.fused_block_chain_cuda),
        "nc": (fused.fused_block_chain_nc, fused.fused_block_chain_nc_torch,
               _kernels.fused_block_chain_nc_cuda),
    }
    rng = np.random.default_rng(SEED)
    _main_loop_check(rng)
    out = {}
    with torch.inference_mode():
        for name, which, L, k, dil, T, C, G, S, cin in CHAIN_SHAPES:
            x, c, stacked = _random_chain(rng, L, k, T, C, G, S, cin)
            kernel, plain, wrapper = calls[which]
            extra = () if dil is None else (dil,)
            got = kernel(x, c, stacked, L, k, *extra)
            split = _kernels._fused_chain_launch.last_split
            again = kernel(x, c, stacked, L, k, *extra)
            want = plain(x, c, stacked, L, k, *extra)
            torch.cuda.synchronize()
            err = 0.0
            for g, g2, w in zip(got, again, want):
                torch.testing.assert_close(g, w, **CHAIN_TOL)
                if not torch.equal(g, g2):
                    raise AssertionError(f"{name}: two runs on the same "
                                         "inputs differ")
                err = max(err, (g - w).abs().max().item())
            # the weights bound once: the layout, then the same bits
            prepared = fused.prepare_block_chain(stacked)
            layout = fused.prepared_chain_weights_torch(stacked)
            torch.cuda.synchronize()
            if not (torch.equal(prepared.wgate, layout["wgate"])
                    and torch.equal(prepared.wproj, layout["wproj"])):
                raise AssertionError(f"{name}: the prepared weights differ "
                                     "from the plain layout")
            del layout
            for g, p in zip(got, kernel(x, c, prepared, L, k, *extra)):
                if not torch.equal(g, p):
                    raise AssertionError(f"{name}: the prepared chain and "
                                         "the bare call differ")
            ms = _median_ms(lambda: kernel(x, c, prepared, L, k, *extra),
                            iters=20, warmup=3)
            bare_ms = _median_ms(lambda: kernel(x, c, stacked, L, k, *extra),
                                 iters=5, warmup=1)
            plain_ms = _median_ms(lambda: plain(x, c, stacked, L, k, *extra),
                                  iters=20, warmup=3)
            forced = {}
            for path in ("rows", "split"):
                for g, w in zip(wrapper(x, c, prepared, *extra, path=path),
                                want):
                    torch.testing.assert_close(g, w, **CHAIN_TOL)
                forced[path] = _median_ms(
                    lambda: wrapper(x, c, prepared, *extra, path=path),
                    iters=10, warmup=2)
            bound_ms, bound_by, tensor_ms = chain_bound(L, k, T, C, G, S, cin)
            row = out.setdefault(which, dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, tensor_bound_ms=tensor_ms))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            coarse = ""
            if T == 20480:
                # what one TF32 product a f32 product would have cost
                one = fused.fused_block_chain_tf32_torch(
                    x, c, stacked, L, k, dil, causal=dil is None, passes=1)
                coarse = (f"; with ONE TF32 product a f32 product (plain "
                          f"twin, passes=1) max_abs_err "
                          f"{max((g - w).abs().max().item() for g, w in zip(one, want)):.3e}")
            print(f"kernel fused_block_chain[{which}] {name}: L={L} k={k} "
                  f"dilations={dil or 'k**l'} T={T} C={C} G={G} S={S} "
                  f"cin={cin}: max_abs_err {err:.3e}, two runs bit-equal, "
                  f"prepared weights ({prepared.nbytes / 1e6:.1f} MB) equal "
                  f"the plain layout and give the bare call's bits{coarse}; "
                  f"kernel {ms:.4f} ms on the "
                  f"{'split' if split else 'row-tiled'} path on prepared "
                  f"weights ({bare_ms:.4f} ms preparing them in the call), "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                  f"{bound_by} at the f32 rate ({bound_ms / ms:.3f} of the "
                  f"kernel's time), tensor_bound_ms {tensor_ms:.4f} "
                  f"({tensor_ms / ms:.3f}; median of 20, CUDA events); "
                  f"forced row-tiled {forced['rows']:.4f} ms, forced split "
                  f"{forced['split']:.4f} ms (median of 10) [{gpu}]")
    _gemm_yardstick(gpu)
    return out


def _prepared_bytes(tree):
    """Bytes of device memory the chains bound to the kernel hold in their
    prepared weights, summed over a server's parameter tree."""
    from vqvae_speech_tpu_torch.ops._kernels import PreparedFusedChain

    if isinstance(tree, PreparedFusedChain):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(_prepared_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_prepared_bytes(v) for v in tree)
    return 0


def vocoder_phase(gpu):
    """One-pass vocoder serving at paper width; returns the chain kernels'
    launch counts on the main path, {wrapper: count}."""
    import torch
    from vqvae_speech_tpu_torch.convert import load_student_params
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.ops import fused_resblock as fused
    from vqvae_speech_tpu_torch.serve import BucketedParallelSynthesisServer

    t0 = time.perf_counter()
    models = vocoder_models()
    mels = vocoder_requests("cuda")
    golden = np.load(VOCODER_GOLDEN)
    golden_mel, golden_z = vocoder_golden_inputs()
    wrappers = {"tiled": _kernels.fused_block_chain_tiled_cuda,
                "chain": _kernels.fused_block_chain_cuda,
                "nc": _kernels.fused_block_chain_nc_cuda}
    n_samples = sum(m.shape[0] for m in mels) * VOCODER_HOP
    print(f"vocoder: set-up {time.perf_counter() - t0:.2f} s (random "
          f"paper-width weights, {len(mels)} requests of "
          f"{[m.shape[0] for m in mels]} frames, {n_samples} samples)")

    launches = {}
    for kind, (params, cfg, kw) in models.items():
        which, chains = (("tiled", sum(cfg.num_blocks_student))
                         if kind == "iaf_student"
                         else ("nc", cfg.n_block * cfg.n_flow))
        common = dict(frame_buckets=VOCODER_BUCKETS, temp=VOCODER_TEMP,
                      device="cuda", **kw)
        fused_server = BucketedParallelSynthesisServer(
            kind, params, cfg, max_batch=1, use_fused_chain=True, **common)
        plain_server = BucketedParallelSynthesisServer(
            kind, params, cfg, max_batch=8, **common)

        # the main path: mel requests -> buckets -> one-pass synthesis, every
        # resblock chain one call of the chain kernel
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = fused_server.synthesize(mels, seed=SEED)
        main_sec = time.perf_counter() - t0
        counts = {n: w.launches for n, w in wrappers.items()}
        want_counts = {n: chains * len(mels) if n == which else 0
                       for n in wrappers}
        if counts != want_counts:
            raise AssertionError(f"{kind}: chain kernel launches {counts}, "
                                 f"expected {want_counts}")
        launches[which] = counts[which]
        if sorted({r.bucket for r in results}) != [20, 40, 80]:
            raise AssertionError(f"{kind}: requests filled buckets "
                                 f"{sorted({r.bucket for r in results})}")
        for mel, r in zip(mels, results):
            if r.wave.shape != (mel.shape[0] * VOCODER_HOP,):
                raise AssertionError(f"{kind}: wave {r.wave.shape} for "
                                     f"{mel.shape[0]} frames")
            if not (np.isfinite(r.wave).all() and r.wave.std() > 1e-3):
                raise AssertionError(f"{kind}: wave not finite or constant")
        print(f"vocoder {kind}: {len(mels)} requests through buckets "
              f"[20, 40, 80], {fused_server.stats['launches']} launches, "
              f"{chains} chains a request; kernel launches {counts}; main "
              f"path {main_sec:.3f} s (first calls included); the chains' "
              f"prepared weights hold "
              f"{_prepared_bytes(fused_server._params) / 1e6:.1f} MB")

        # (a)/(b) against (c): the plain path at max_batch 8, the same noise
        reference = plain_server.synthesize(mels, seed=SEED)
        diffs = [float(np.abs(r.wave - p.wave).max())
                 for r, p in zip(results, reference)]
        if not max(diffs) <= VOCODER_TOL:
            raise AssertionError(f"{kind}: fused vs plain server waves differ "
                                 f"by up to {max(diffs):.3e} > {VOCODER_TOL}")
        (got,) = fused_server.synthesize([golden_mel], noises=[golden_z])
        golden_err = float(np.abs(got.wave - golden[kind]).max())
        if not golden_err <= VOCODER_TOL:
            raise AssertionError(f"{kind}: golden request differs from the JAX "
                                 f"wave by {golden_err:.3e} > {VOCODER_TOL}")
        rms = float(np.sqrt(np.mean(np.concatenate(
            [r.wave for r in results]) ** 2)))
        print(f"vocoder {kind}: fused (max_batch 1) vs plain (max_batch 8) "
              f"waves, max abs diff per request "
              f"{[f'{d:.1e}' for d in diffs]} (limit {VOCODER_TOL}, wave rms "
              f"{rms:.3f}); golden request vs JAX: max abs diff "
              f"{golden_err:.3e} (limit {VOCODER_TOL})")

        single_server = BucketedParallelSynthesisServer(
            kind, params, cfg, max_batch=1, **common)
        for name, server in (("fused chains, max_batch 1", fused_server),
                             ("plain, max_batch 1", single_server),
                             ("plain, max_batch 8", plain_server)):
            sec = _median_seconds(lambda: server.synthesize(mels, seed=SEED))
            print(f"vocoder {kind} [{name}]: {len(mels)} requests in "
                  f"{sec * 1e3:.2f} ms (median of 3): "
                  f"{n_samples / sec:.0f} samples/s delivered, "
                  f"{sec / len(mels) * 1e3:.3f} ms a request [{gpu}]")
        for bucket in (20, 40, 80):
            mel = next(m for m in mels if m.shape[0] == bucket)
            sec = _median_seconds(lambda: fused_server.synthesize([mel]))
            print(f"vocoder {kind} [fused chains] bucket {bucket} "
                  f"({bucket * VOCODER_HOP} samples): {sec * 1e3:.3f} ms a "
                  f"request, {bucket * VOCODER_HOP / sec:.0f} samples/s, "
                  f"real-time factor "
                  f"{sec / (bucket * VOCODER_HOP / VOCODER_RATE):.4f} at "
                  f"{VOCODER_RATE} Hz [{gpu}]")

        mel = next(m for m in mels if m.shape[0] == 80)
        window, busy_us = _device_profile(
            lambda: fused_server.synthesize([mel]))
        total_us = sum(busy_us.values())
        chain_us = sum(v for k, v in busy_us.items() if any(
            n in k for n in ("gemm_kernel", "glu_kernel")))
        print(f"vocoder {kind} profile (one fused bucket-80 request, "
              f"torch.profiler CUDA activity): window {window * 1e3:.2f} "
              f"ms, device busy {total_us / 1e3:.2f} ms, idle share "
              f"{1 - total_us / 1e6 / window:.3f}; chain kernels "
              f"{chain_us / total_us:.3f} of device time [{gpu}]")
        for key, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / 1e3:10.3f} ms  {key[:100]}")
        del fused_server, single_server, plain_server
        torch.cuda.empty_cache()

    # the whole-T entry point's own path: the student's first chain at the
    # shape of the JAX package's chain benchmark (T=4096), as that script
    # drives it, on the student's own weights
    params, cfg, _ = models["iaf_student"]
    stacked = load_student_params(params, cfg, "cuda")["iafs"][0]["chains"][0]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal(
        (4096, cfg.residual_channels)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.random(
        (4096, cfg.cin_channels)).astype(np.float32)).cuda()
    wrappers["chain"].launches = 0
    got = fused.fused_block_chain(x, c, stacked, cfg.num_layers,
                                  cfg.kernel_size)
    torch.cuda.synchronize()
    launches["chain"] = wrappers["chain"].launches
    if launches["chain"] != 1:
        raise AssertionError("fused_block_chain did not launch its kernel")
    want = fused.fused_block_chain_torch(x, c, stacked, cfg.num_layers,
                                         cfg.kernel_size)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **CHAIN_TOL)
    print("vocoder: fused_block_chain on the student's first chain at "
          f"T=4096: {launches['chain']} kernel launch, within CHAIN_TOL of "
          "its plain chain")
    return launches


PHASES = ("kernel", "slice", "train", "experiment", "step_kernel",
          "synthesis", "chain_kernel", "vocoder")


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ", ".join(PHASES))
    only = parser.parse_args().phases.split(",")
    if not set(only) <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phase in {only}")
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

    names = ("vq_search", "wavenet_step", "fused_resblock")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(timed_build, names)))
    for name, (sec, report) in builds.items():
        print(f"built csrc/{name}.cu in {sec:.2f} s (nvcc, in parallel)")
        for line in report.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print("  " + line.strip())

    print(_tensor_core_instructions(_kernels))

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.2f} s")
        return out

    if set(only) != set(PHASES):
        for name, fn, args in (
                ("kernel", kernel_phase, ()), ("slice", slice_phase, (gpu,)),
                ("train", train_phase, (gpu,)),
                ("experiment", experiment_phase, (gpu,)),
                ("step_kernel", step_kernel_phase, (gpu,)),
                ("synthesis", synthesis_phase, (gpu,)),
                ("chain_kernel", chain_kernel_phase, (gpu,)),
                ("vocoder", vocoder_phase, (gpu,))):
            if name in only:
                phase(fn, *args)
        print(f"chip_smoke: partial run of {only}; no result line")
        return

    vq_err, (vq_ms, vq_plain_ms) = phase(kernel_phase)
    encode_vq_launches = phase(slice_phase, gpu)
    train_vq_launches, vq_device_ms, train_ms = phase(train_phase, gpu)
    experiment_vq_launches, loop_ms, bare_ms = phase(experiment_phase, gpu)
    print(f"experiment vs train: the loop {loop_ms:.3f} ms a step at batch 2 "
          f"(no checkpoint), the bare step {bare_ms:.3f} ms at batch 2 and "
          f"{train_ms:.3f} ms at batch 64 (train phase, gradient VQ) [{gpu}]")
    step_err, (step_ms, step_plain_ms) = phase(step_kernel_phase, gpu)
    step_launches, synth_vq_launches = phase(synthesis_phase, gpu)
    chains = phase(chain_kernel_phase, gpu)
    chain_launches = phase(vocoder_phase, gpu)
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "vqvae_speech_tpu"))
    if jax_side:
        raise AssertionError(f"the run imported JAX-side modules {jax_side}")

    # no single PyTorch call computes any of these fused functions (a search
    # with its statistics, a whole layer stack, a whole resblock chain)
    def line(name, source, replaces, launches, numbers, **more):
        return dict(name=name, route="cuda",
                    source=f"vqvae_speech_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, **numbers,
                    library_ms=None, **more)

    from vqvae_speech_tpu_torch.models.wavenet_decoder import (
        wavenet_config_from,
    )

    wcfg = wavenet_config_from(WAVENET_CONFIG, WAVENET_CONFIG["num_speakers"])
    vq_bound = vq_search_bound(*TIMED_SHAPE, 64)
    step_bound = wavenet_step_bound(
        wcfg.layers, wcfg.kernel_size, TIMED_STEP[0], wcfg.residual_channels,
        wcfg.gate_channels, wcfg.skip_out_channels)
    print(json.dumps({"kernels": [
        line("vq_search", "vq_search.cu", "vqvae_speech_tpu/ops/vq.py:91",
             encode_vq_launches + train_vq_launches + experiment_vq_launches
             + synth_vq_launches,
             dict(max_abs_err=vq_err, ms=vq_ms, plain_ms=vq_plain_ms,
                  bound_ms=vq_bound[0], bound_by=vq_bound[1]),
             # ms is by CUDA events, which at this size time the host's
             # launch; device_ms is the kernel's own time in the train steps
             device_ms=vq_device_ms),
        line("wavenet_step", "wavenet_step.cu",
             "vqvae_speech_tpu/ops/wavenet_step.py:35", step_launches,
             dict(max_abs_err=step_err, ms=step_ms, plain_ms=step_plain_ms,
                  bound_ms=step_bound[0], bound_by=step_bound[1])),
        line("fused_block_chain_tiled", "fused_resblock.cu",
             "vqvae_speech_tpu/ops/fused_resblock.py:95",
             chain_launches["tiled"], chains["tiled"]),
        line("fused_block_chain_nc", "fused_resblock.cu",
             "vqvae_speech_tpu/ops/fused_resblock.py:215",
             chain_launches["nc"], chains["nc"]),
        line("fused_block_chain", "fused_resblock.cu",
             "vqvae_speech_tpu/ops/fused_resblock.py:65",
             chain_launches["chain"], chains["chain"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
