#!/usr/bin/env python3
"""Drive the PyTorch port (vqvae_speech_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the three hand-written kernel sources, one nvcc each, in
   parallel: the fused VQ codebook search (csrc/vq_search.cu), the fused
   WaveNet decode-step layer stack (csrc/wavenet_step.cu) and the fused
   gated-resblock chains in f32 and bf16 (csrc/fused_resblock.cu), and
   checks that the chains' binary holds TF32 and bf16 wgmma instructions.
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
   bf16 (right after the f32 runs, in the same phase): the gradient VQ at
   compute_dtype bfloat16, 5 + 50 steps on the same batch: one kernel launch
   a step, the reconstruction loss within TRAIN_BF16_RECON_BAND of the f32
   run's at every step, ms a step beside f32's, the idle share and the top
   device kernels.
   Pth import phase (between the slice and the train phases): a
   reference-layout state_dict of seeded numpy weights at the flagship
   width, saved as .pth and converted by train/convert_reference.py,
   encodes the 12 requests on the card (VQ kernel) and on the CPU: the
   same codes, or near-ties on the card's latents.
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
   Evaluate phase (right after it, on the experiment phase's directory and
   its epoch-3 checkpoint): the port's CLI evaluates the val split
   (--evaluate with the alignments in both pairings, the clustering
   metrics, the many-to-one mapping and the average phoneme count,
   --no_figures); checks every file under the JAX package's name, 80
   empirical alignments of 24 codes in each pairing, the groundtruth
   alignments of the val utterances with TextGrids, ARI/AMI/NMI finite in
   [-1, 1]. In process, Evaluator(device="cuda", figures=False) runs the
   same options with the speaker and entropy pass, then the single-batch
   capture: one VQ kernel launch an encode batch, the model bit-equal
   after, the capture's encodings, distances and pairwise distances
   against their recomputations; the VQ kernel's codes on this path against
   the plain search on the same batches (every differing row a near-tie;
   with none, the plain codes' scores equal the CLI's); the empirical
   sweep's utterances/s and, from torch.profiler, its device idle share
   and the kernel's share of device time.
   WaveNet train phase (after the evaluate phase): WaveNet-VQ-VAE training
   at configurations/vctk_wavenet.yaml's width (20 layers, k=3, C=G=768,
   S=256, quantize 256, K=29, length 7680, batch 1, gradient VQ), 3 + 20
   steps of make_wavenet_train_step on a VCTK crop with the f32 decoder and
   with the bf16 one: one VQ kernel launch a step, finite losses, ms a
   step, the idle share and the top device kernels; then the CLI
   (python -m vqvae_speech_tpu_torch.main) on an experiments JSON naming
   configurations/vctk_wavenet.yaml, one epoch and a resume to two, on the
   first 3 wavs of each speaker of the tracked subset (the only cut: 19
   train utterances): the checkpoints of epochs 1 and 2, the epoch-2
   parameters in the JAX tree and layout, the optax-named amsgrad state
   and its count, the checkpoint's size.
4. Decode-step kernel phase: holds glu_stack_step against its plain
   PyTorch chain at the vctk_wavenet width (20 layers, k=3, C=G=768,
   S=256) for batch 1, 8 and 32 with and without the legacy skip scaling,
   for batch 33, 64 and 100 (groups of 32 streams, one launch a group),
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

   Continuous phase (right after it): the same model and ten requests
   (local_conditioning, so the VQ kernel runs) drained greedily by
   ContinuousSynthesisServer (8 slots, chunks of 512, max_frames 23), one
   decode-step kernel launch a step. Checks launches = chunks x 512, two
   requests against a standalone batch-1 decode (equal, or equal up to a
   printed near-tie), the last request alone bit-equal to its stream
   admitted behind the other nine, the streams against the bucketed
   server's (parting only at near-ties of the teacher-forced logits);
   reports samples/s beside the bucketed server's, ms a step, seconds a
   chunk, slot utilization, latency and admission wait in chunks, and the
   device's idle share. Then the int8, int8_block and bf16 decodes (the
   per-layer path): one chunk of 512 steps at 8 slots on the card against
   the same on the CPU (equal up to near-ties), ms a step beside K2's; and a
   scalar-input (mixture) WaveNet at the same width through the kernel,
   greedy and sampled, for 384 steps. Then 64 slots (two launches of the
   decode-step kernel a step): 64 one-frame requests in chunks of 256
   steps, launches = steps x 2, each stream against the 8-slot server's
   (parting only at a near-tie, the step and its top-two gap printed).

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
   student chain's products alone in f32, in one-pass TF32 and in bf16.
   Then the three bf16 entry points (x, c_up and weights bf16, one bf16
   wgmma product a product) at the same shapes but the ragged and deep ones:
   bit-equal over two runs, held to the plain bf16 chain within
   BF16_SPREAD_MULTIPLE times the spread between two summation orders of
   that chain (bf16_chain_check), their prepared bf16 weights against the
   plain layout, one bare bf16 product of the main loop against
   torch.matmul; timed beside the plain bf16 chain and the f32 kernel, with
   the bound at the bf16 tensor rate.
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
   reports samples/s and ms a request. Then the bf16 serving configuration
   (compute_dtype=bfloat16) of each kind: the same 8 requests through a
   fused server at max_batch 1 (every chain one call of the bf16 chain
   kernel, counted) and a plain one at max_batch 8, fused held against
   plain, the golden request against the JAX package's bf16 server's wave
   (tests/data/torch_port_vocoder_golden_bf16.npz), times, and the bf16
   whole-T entry point on the student's first chain loaded at bf16.

Exits non-zero on any failure, and without a CUDA device. The last two lines
of output are a JSON object of per-kernel results (the five f32 entry
points and the three bf16 ones) and the JSON status line.
Imports nothing of JAX.

    python3 chip_smoke.py --phases step_kernel,synthesis

runs only the named phases (kernel, slice, pth_import, train, experiment,
evaluate, wavenet_train, step_kernel, synthesis, continuous, chain_kernel,
vocoder), for work on one
kernel or slice; such a run prints neither of the two JSON lines. The
evaluate phase run without the experiment phase first trains jitter12 for
one epoch through the CLI. A run fails if it imported JAX, the JAX package,
scikit-learn or matplotlib.
"""
import concurrent.futures
import json
import os
import pickle
import shutil
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
# the gradient VQ at compute_dtype bfloat16 against the same steps in f32:
# its reconstruction loss, step by step, within this share of the f32
# run's (chosen before the first run on the card, from the CPU tests'
# bf16 spread of a few 1e-4 relative at the tiny width, with room for 55
# steps at full width)
TRAIN_BF16_RECON_BAND = 0.1
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
# B = 33, 64 and 100 run as groups of 32 streams, one launch each
STEP_SHAPES = ((1, 3, True, None), (1, 3, False, None), (8, 3, True, None),
               (8, 3, False, None), (2, 2, True, None), (32, 3, True, None),
               (33, 3, True, None), (64, 3, True, None), (100, 3, True, None),
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
# the same request through the JAX package's bf16 server (compute_dtype
# bf16, plain, one jitted program)
VOCODER_BF16_GOLDEN = os.path.join(REPO_ROOT, "tests", "data",
                                   "torch_port_vocoder_golden_bf16.npz")
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
# the bf16 entry points at the f32 rows' shapes (K3 at T=20480 and 5119,
# K5 at 4096, K4 at the eight flow blocks); ragged shapes and both paths
# are the card tests' (tests/test_torch_fused_resblock_kernel.py)
BF16_CHAIN_SHAPES = tuple(
    shape for shape in CHAIN_SHAPES
    if shape[0] not in ("flow block 7, ragged T", "deep dilations"))
# The bf16 chains: the kernel and its plain bf16 chain round x to bf16 after
# every layer from f32 sums taken in different orders, so some elements land
# on the other side of a rounding and the flip propagates (through a 6-layer
# chain to a third of x). The yardstick is the spread between two legitimate
# orders of the plain chain: its f32 sums as cuBLAS takes them, and the same
# sums correctly rounded (fused_block_chain_bf16_torch(exact=True),
# float64 products and sums). The kernel's max abs error against the plain
# chain, on x and skip, is held to BF16_SPREAD_MULTIPLE times that spread
# (or one bf16 ulp of the largest |x|, where a small shape shows none); the
# share of x elements in which the kernel differs from the exact chain, to
# the multiple of the share in which the plain chain does, or of
# BF16_SHARE_FLOOR: at a few thousand rows one early flip that cascades
# through the next layer's taps moves the share by a few tenths of a percent
# (flow block 7's shape at T=81: the kernel 0 and 0.58% off the exact chain
# on two seeds, the plain chain 0.024% and 0.039%), while a systematic
# defect moves tens of percent (a bf16 sigmoid rounded once where JAX rounds
# each step moved a third of its outputs). Measured on an H100
# (scripts/bf16_chain_accumulation_cuda.py): a bare product of the bf16 loop
# is as close to float64 as cuBLAS's f32 one at K = 464-10240 (mean 1.5e-7
# against 1.6e-7 at K=10240; without the accumulator's promotion 9e-6), and
# the chains' shares 0-1.8 times the plain chain's.
BF16_SHARE_FLOOR = 2.5e-3
BF16_SPREAD_MULTIPLE = 4
# a fused server's wave against the plain server's and against the JAX
# package's golden wave (f32 conv stacks of up to ~150 layers in another
# summation order, through exp() of the flows' log-scales)
VOCODER_TOL = 1e-3
# bf16 servers, (max abs, mean abs) over a wave. Against the bf16 golden
# wave: about twice the JAX package's own spread on that request between
# its jitted server and its eager ops (max 0.031 / 0.109, mean 0.0042 /
# 0.0083 for the student / the flow; the port follows JAX's eager ops).
# Fused (max_batch 1) against plain (max_batch 8): twice the largest
# difference over the smoke's 8 requests on the CPU (max 0.078 / 0.281, mean
# 0.0039 / 0.0089): the fused chain keeps its gate and skip sums in f32
# where the plain resblocks round every op to bf16, a difference the size
# of bf16's own error (the plain bf16 server is 0.061 / 0.53 off the f32
# one).
VOCODER_BF16_GOLDEN_TOL = {"iaf_student": (0.0625, 0.0084),
                           "flowavenet": (0.25, 0.0166)}
VOCODER_BF16_FUSED_TOL = {"iaf_student": (0.156, 0.0078),
                          "flowavenet": (0.5625, 0.0178)}
# NVIDIA's published peaks for the H100 SXM: f32 outside the tensor cores,
# dense TF32 and dense bf16 on them, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bf16_chain_check(name, got, want, exact):
    """Hold a bf16 chain kernel's (x, skip) to its plain bf16 chain ``want``
    within BF16_SPREAD_MULTIPLE times the spread between ``want`` and
    ``exact``, the plain chain with its sums correctly rounded (see
    BF16_SPREAD_MULTIPLE); raises, else returns (max abs error, spread, the
    kernel's share of x off the exact chain, the plain chain's share)."""
    import math

    def diff(a, b):
        return max((u.float() - v.float()).abs().max().item()
                   for u, v in zip(a, b))

    err, spread = diff(got, want), diff(exact, want)
    flips = (got[0] != exact[0]).float().mean().item()
    spread_flips = (want[0] != exact[0]).float().mean().item()
    peak = want[0].float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(peak)) - 7) if peak > 0 else 0.0
    limit = BF16_SPREAD_MULTIPLE * max(spread, ulp)
    flip_limit = BF16_SPREAD_MULTIPLE * max(spread_flips, BF16_SHARE_FLOOR)
    if not (err <= limit and flips <= flip_limit):
        raise AssertionError(
            f"{name}: bf16 kernel off its plain chain by {err:.3e} (limit "
            f"{limit:.3e}, spread {spread:.3e}); {flips:.2e} of x off the "
            f"exact chain (limit {flip_limit:.2e}, the plain chain "
            f"{spread_flips:.2e})")
    return err, spread, flips, spread_flips


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
    holds none, or no bf16 one."""
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
    if not any("BF16" in op for op in ops):
        raise AssertionError("no bf16 HGMMA instruction in the chain kernels' "
                             f"SASS: {sorted(set(ops))}")
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
    total_launches, vq_device_ms, step_ms, recon_runs = 0, None, {}, {}
    for name, config in (("gradient VQ", base),
                         ("EMA VQ", dict(base, decay=0.99)),
                         ("gradient VQ, bf16",
                          dict(base, compute_dtype="bfloat16"))):
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
        recon_runs[name] = recons
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
        if "bf16" not in name:
            vq_device_ms = vq_us / n_prof / 1e3
        print(f"train [{name}] profile ({n_prof} steps, torch.profiler "
              f"CUDA activity): window {window / n_prof * 1e3:.3f} ms a "
              f"step, device busy {total_us / n_prof / 1e3:.3f} ms a "
              f"step, idle share {1 - total_us / 1e6 / window:.3f}; "
              f"vq_search {vq_us / n_prof / 1e3:.5f} ms a step "
              f"({vq_us / total_us:.4f} of device time), convolution "
              f"kernels forward {share(lambda k: is_conv(k) and not is_bwd(k)):.3f}"
              f" and backward {share(lambda k: is_conv(k) and is_bwd(k)):.3f}"
              f" (by kernel name), optimizer (multi_tensor_apply) "
              f"{share(lambda k: 'multi_tensor' in k):.3f} [{gpu}]")
        for key, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / n_prof / 1e3:10.4f} ms a step  {key[:100]}")
        del state
        torch.cuda.empty_cache()

    f32, bf16 = recon_runs["gradient VQ"], recon_runs["gradient VQ, bf16"]
    band = ((bf16 - f32).abs() / f32).max().item()
    if not band <= TRAIN_BF16_RECON_BAND:
        raise AssertionError(f"train: the bf16 step's reconstruction loss is "
                             f"{band:.3f} of the f32 run's from it (limit "
                             f"{TRAIN_BF16_RECON_BAND})")
    print(f"train: compute_dtype bfloat16 against f32 (gradient VQ, the same "
          f"{TRAIN_WARMUP + TRAIN_STEPS} steps on the same batch): "
          f"reconstruction loss within {band:.4f} of the f32 run's at every "
          f"step (limit {TRAIN_BF16_RECON_BAND}); "
          f"{step_ms['gradient VQ, bf16']:.3f} ms a step against "
          f"{step_ms['gradient VQ']:.3f} ms in f32, "
          f"{step_ms['gradient VQ'] / step_ms['gradient VQ, bf16']:.2f}x "
          f"[{gpu}]")

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


# the wavenet_train phase: configurations/vctk_wavenet.yaml as it stands
# (20 layers, k=3, C=G=768, S=256, quantize 256, K=29, length 7680, batch 1,
# the gradient VQ, learning rate 2e-4), normalize false, on a crop of
# VCTK p300_001: 3 warm-up and 20 timed steps of the f32 decoder, then of
# the bf16 one (compute_dtype bfloat16: the decoder in bf16)
WAVENET_TRAIN_CONFIG = dict(WAVENET_CONFIG, learning_rate=2e-4, length=7680,
                            normalize=False)
WAVENET_TRAIN_WARMUP, WAVENET_TRAIN_STEPS = 3, 20
# the CLI: configurations/vctk_wavenet.yaml through main.py, num_epochs 1
# then 2 in the frozen config; the only cut is the number of utterances:
# the first WAVENET_CLI_WAVS of each of the tracked subset's 8 speakers
# (24 wavs, a 0.8 split: 19 train utterances, 19 steps an epoch at batch 1)
WAVENET_CLI_WAVS = 3
WAVENET_EXPERIMENT = "wavenet"


def wavenet_train_batch(device):
    """One utterance at the vctk_wavenet length: VCTK p300_001 (tiled where
    shorter) cropped to length + 1 samples, its MFCC + deltas, speaker 0."""
    import torch
    from vqvae_speech_tpu_torch.data.audio import load_and_preprocess

    n = WAVENET_TRAIN_CONFIG["length"] + 1
    w, _ = load_and_preprocess(os.path.join(WAVE_DIR, "p300_001.wav"), 16000)
    audio = np.tile(w, -(-n // len(w)))[:n].astype(np.float32)
    feats = wavenet_features(audio, device)
    return {"preprocessed_audio": torch.from_numpy(audio)[None].to(device),
            "input_features": feats,
            "speaker_id": torch.zeros((1,), dtype=torch.int64, device=device)}


def _wavenet_cli_workdir(work):
    """configurations/ (both YAMLs linked, the experiments JSON naming
    vctk_wavenet.yaml) and data/vctk/raw/VCTK-Corpus holding the first
    WAVENET_CLI_WAVS wavs of each speaker of the tracked subset (links),
    with its txt and phonemes trees."""
    corpus = os.path.join(CORPUS_ROOT, "VCTK-Corpus")
    os.makedirs(os.path.join(work, "configurations"))
    for name in ("vctk_features.yaml", "vctk_wavenet.yaml"):
        os.symlink(os.path.join(REPO_ROOT, "configurations", name),
                   os.path.join(work, "configurations", name))
    spec = {"experiments_path": "experiments", "results_path": "results",
            "configuration_path": os.path.join("configurations",
                                               "vctk_wavenet.yaml"),
            "seed": 1234,
            "experiments": {WAVENET_EXPERIMENT: {"num_epochs": 1}}}
    with open(os.path.join(work, "wavenet.json"), "w") as f:
        json.dump(spec, f, indent=4)
    raw = os.path.join(work, "data", "vctk", "raw", "VCTK-Corpus")
    for tree in ("txt", "phonemes"):
        os.makedirs(raw, exist_ok=True)
        os.symlink(os.path.join(corpus, tree), os.path.join(raw, tree))
    n = 0
    for speaker in sorted(os.listdir(os.path.join(corpus, "wav48"))):
        os.makedirs(os.path.join(raw, "wav48", speaker))
        for name in sorted(os.listdir(os.path.join(corpus, "wav48",
                                                   speaker)))[:WAVENET_CLI_WAVS]:
            os.symlink(os.path.join(corpus, "wav48", speaker, name),
                       os.path.join(raw, "wav48", speaker, name))
            n += 1
    return n


def _wavenet_cli(gpu, work):
    """main.py trains configurations/vctk_wavenet.yaml one epoch and resumes
    it to two; the checkpoints are the JAX package's format."""
    from vqvae_speech_tpu_torch.convert import numpy_wavenet_vqvae_params
    from vqvae_speech_tpu_torch.train import (
        find_checkpoints,
        freeze_configuration,
        load_checkpoint,
        load_configuration,
    )

    n_wavs = _wavenet_cli_workdir(work)
    spec = ("--experiments_configuration_path", "wavenet.json")
    export_sec, _ = _cli(work, "--export_to_features", *spec)
    exp_dir = os.path.join(work, "experiments")
    first_sec, _ = _cli(work, *spec)
    frozen = os.path.join(exp_dir, f"{WAVENET_EXPERIMENT}_configuration.yaml")
    config = load_configuration(frozen)
    if config["decoder_type"] != "wavenet" or config["n_layers"] != 20:
        raise AssertionError(f"wavenet cli: frozen config {config}")
    freeze_configuration(dict(config, num_epochs=2), exp_dir,
                         WAVENET_EXPERIMENT)
    second_sec, out = _cli(work, *spec)
    if "Resuming WaveNet" not in out:
        raise AssertionError("wavenet cli: the second run did not resume")
    ckpts = find_checkpoints(exp_dir, WAVENET_EXPERIMENT)
    if [e for e, _ in ckpts] != [1, 2]:
        raise AssertionError(f"wavenet cli: checkpoints {ckpts}")
    path = ckpts[-1][1]
    size = os.path.getsize(path)
    ckpt = load_checkpoint(path)
    steps = len(ckpt["train_res_recon_error"])
    want, _, _ = numpy_wavenet_vqvae_params(
        config, config["num_speakers"], 0)

    def leaves(tree, at=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], at + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, at + (i,))
        else:
            yield at, tree

    got = list(leaves(ckpt["params"]))
    expected = list(leaves(want))
    if [p for p, _ in got] != [p for p, _ in expected] or any(
            g.shape != w.shape or g.dtype != np.float32
            for (_, g), (_, w) in zip(got, expected)):
        raise AssertionError("wavenet cli: the epoch-2 checkpoint's params "
                             "are not the JAX tree")
    state, rest = ckpt["opt_state"]
    count = int(np.asarray(state[0]))
    if (type(state).__name__, type(rest).__name__) != (
            "ScaleByAmsgradState", "EmptyState") or count != 2 * steps:
        raise AssertionError(f"wavenet cli: opt_state {type(state)} count "
                             f"{count} after 2 epochs of {steps} steps")
    losses = np.asarray([e["loss"] for e in ckpt["train_res_recon_error"]])
    if not np.isfinite(losses).all():
        raise AssertionError("wavenet cli: non-finite losses")
    print(f"wavenet cli: main.py on configurations/vctk_wavenet.yaml, "
          f"{n_wavs} wavs ({steps} train utterances, batch 1): export "
          f"{export_sec:.1f} s, epoch 1 {first_sec:.1f} s, resumed epoch 2 "
          f"{second_sec:.1f} s (processes with start-up and checkpoint "
          f"writes); epoch-2 checkpoint {os.path.basename(path)} "
          f"{size / 1e9:.3f} GB, {len(got)} parameter leaves in the JAX "
          f"layout ({got[0][0]} {tuple(got[0][1].shape)}), "
          f"optax-named amsgrad state, count {count}; epoch-2 loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} [{gpu}]")


def wavenet_train_phase(gpu):
    """WaveNet-VQ-VAE training at the vctk_wavenet width: the step with the
    f32 and the bf16 decoder, then the CLI; returns the VQ kernel's launches
    and {decoder: ms a step}."""
    import tempfile

    import torch
    from vqvae_speech_tpu_torch.convert import (
        load_wavenet_vqvae_params,
        numpy_wavenet_vqvae_params,
    )
    from vqvae_speech_tpu_torch.models import WaveNetVQVAE
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.train import (
        create_wavenet_train_state,
        make_optimizer,
        make_wavenet_train_step,
    )

    config = WAVENET_TRAIN_CONFIG
    speakers = config["num_speakers"]
    batch = wavenet_train_batch("cuda")
    if tuple(batch["input_features"].shape) != (1, 47, 39):
        raise AssertionError(f"wavenet train: features "
                             f"{tuple(batch['input_features'].shape)}")
    params, state, _ = numpy_wavenet_vqvae_params(config, speakers, SEED)
    n_steps = WAVENET_TRAIN_WARMUP + WAVENET_TRAIN_STEPS
    launches, step_ms = 0, {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = load_wavenet_vqvae_params(WaveNetVQVAE(config, speakers),
                                          params, state)
        optimizer = make_optimizer(config["learning_rate"])
        tstate = create_wavenet_train_state(model, optimizer, device="cuda",
                                            seed=SEED)
        step = make_wavenet_train_step(config, model.decoder.cfg, optimizer,
                                       compute_dtype=dtype)
        metrics = []
        _kernels.vq_search_cuda.launches = 0
        for _ in range(WAVENET_TRAIN_WARMUP):
            tstate, m = step(tstate, batch)
            metrics.append(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WAVENET_TRAIN_STEPS):
            tstate, m = step(tstate, batch)
            metrics.append(m)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / WAVENET_TRAIN_STEPS
        got = _kernels.vq_search_cuda.launches
        launches += got
        if got != n_steps:
            raise AssertionError(f"wavenet train [{name}]: {got} vq_search "
                                 f"launches in {n_steps} steps")
        loss = torch.stack([m["loss"] for m in metrics]).cpu()
        ce = torch.stack([m["reconstruction_loss"] for m in metrics]).cpu()
        if not bool(torch.isfinite(loss).all()):
            raise AssertionError(f"wavenet train [{name}]: non-finite loss")
        step_ms[name] = sec * 1e3
        print(f"wavenet train [{name} decoder]: batch 1 x 7680 samples, "
              f"{WAVENET_TRAIN_WARMUP} + {WAVENET_TRAIN_STEPS} steps, one "
              f"vq_search launch a step; cross-entropy {ce[0]:.4f} -> "
              f"{ce[-1]:.4f}, loss {loss[0]:.4f} -> {loss[-1]:.4f}, "
              f"perplexity {metrics[-1]['perplexity'].item():.2f}; "
              f"{sec * 1e3:.2f} ms a step (host clock around "
              f"{WAVENET_TRAIN_STEPS} steps ending in a sync) [{gpu}]")
        n_prof = 3
        _kernels.vq_search_cuda.launches = 0
        window, busy_us = _device_profile(
            lambda: [step(tstate, batch) for _ in range(n_prof)],
            "vq_", lambda: n_prof)
        launches += _kernels.vq_search_cuda.launches
        total_us = sum(busy_us.values())
        print(f"wavenet train [{name} decoder] profile ({n_prof} steps, "
              f"torch.profiler CUDA activity): window "
              f"{window / n_prof * 1e3:.2f} ms a step, device busy "
              f"{total_us / n_prof / 1e3:.2f} ms a step, idle share "
              f"{1 - total_us / 1e6 / window:.3f} [{gpu}]")
        for key, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / n_prof / 1e3:10.3f} ms a step "
                  f"({us / total_us:.3f})  {key[:90]}")
        del tstate, model, step
        torch.cuda.empty_cache()
    print(f"wavenet train: bf16 decoder {step_ms['bf16']:.2f} ms a step "
          f"against f32 {step_ms['f32']:.2f} ms, "
          f"{step_ms['f32'] / step_ms['bf16']:.2f}x [{gpu}]")
    work = tempfile.mkdtemp(prefix="chip_smoke_wavenet_")
    try:
        _wavenet_cli(gpu, work)
    finally:
        shutil.rmtree(work)
    return launches, step_ms


def reference_state_dict(params):
    """A ``conv_vqvae_init``-shaped tree (plain convs) as the reference
    ConvolutionalVQVAE's state_dict: its module paths and torch layouts,
    the inverse of train/convert_reference.py's map."""
    import torch

    sd = {}

    def put(prefix, conv):
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(conv["w"]).transpose(2, 1, 0)))
        if "b" in conv:
            sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(conv["b"]))

    for i in range(1, 6):
        put(f"_encoder._conv_{i}", params["encoder"][f"conv_{i}"])
    for side in ("encoder", "decoder"):
        block = params[side]["residual_stack"]["block"]
        put(f"_{side}._residual_stack._layers.0._block.1", block["conv1"])
        put(f"_{side}._residual_stack._layers.0._block.3", block["conv2"])
    put("_pre_vq_conv", params["pre_vq_conv"])
    put("_decoder._conv_1", params["decoder"]["conv_1"])
    for i in range(1, 4):
        put(f"_decoder._conv_trans_{i}", params["decoder"][f"conv_trans_{i}"])
    sd["_vq._embedding.weight"] = torch.from_numpy(
        np.asarray(params["vq"]["codebook"]))
    return sd


PTH_MAX_BATCH = 4


def pth_import_phase(gpu):
    """A reference-layout .pth of seeded numpy weights at the flagship width,
    converted by train/convert_reference.py, encodes the 12 smoke requests
    on the card through K1 and on the CPU: the same codes, or near-ties on
    the card's latents. Returns K1's launches."""
    import tempfile

    import torch
    from vqvae_speech_tpu_torch.convert import numpy_params
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.serve import BucketedEncodeServer
    from vqvae_speech_tpu_torch.train.convert_reference import (
        convert_reference_checkpoint,
    )

    params, _ = numpy_params(FLAGSHIP_CONFIG, seed=SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "baseline_15_checkpoint.pth")
        torch.save({"model": reference_state_dict(params),
                    "experiment_name": "baseline", "epoch": 15}, path)
        got, state, meta = convert_reference_checkpoint(path, FLAGSHIP_CONFIG)
    if meta != {"experiment_name": "baseline", "epoch": 15} or not np.array_equal(
            got["encoder"]["conv_3"]["w"], params["encoder"]["conv_3"]["w"]):
        raise AssertionError("pth import: the converted tree is not the one "
                             "saved")
    requests = smoke_requests()
    codes = {}
    for device in ("cuda", "cpu"):
        server = BucketedEncodeServer(got, state, FLAGSHIP_CONFIG,
                                      max_batch=PTH_MAX_BATCH, device=device)
        _kernels.vq_search_cuda.launches = 0
        results = server.encode(requests)
        if device == "cuda":
            launches = _kernels.vq_search_cuda.launches
            if launches == 0:
                raise AssertionError("pth import: no vq_search launch")
            cuda_server, cuda_results = server, results
        codes[device] = results
    n_diff = 0
    codebook = cuda_server.model.vq.codebook.detach()
    for bucket in sorted({r.bucket for r in cuda_results}):
        rows = [i for i, r in enumerate(cuda_results) if r.bucket == bucket]
        for at in range(0, len(rows), PTH_MAX_BATCH):
            part = rows[at:at + PTH_MAX_BATCH]
            with torch.inference_mode():
                z = cuda_server.model.latents(cuda_server.features(
                    cuda_server.padded_batch([requests[i] for i in part],
                                             bucket)))
            flat = z[:len(part)].contiguous().view(-1, codebook.shape[1])
            on_card = torch.from_numpy(np.concatenate(
                [codes["cuda"][i].codes for i in part])).cuda()
            on_cpu = torch.from_numpy(np.concatenate(
                [codes["cpu"][i].codes for i in part])).cuda()
            n_diff += _near_ties(flat, codebook, on_card, on_cpu,
                                 NEAR_TIE_GOLDEN)
    n_codes = sum(r.codes.size for r in cuda_results)
    print(f"pth import: a reference-layout state_dict (seeded numpy weights, "
          f"flagship width) saved as .pth, read with weights_only=True and "
          f"converted; {len(requests)} requests encoded on the card "
          f"({launches} vq_search launches) and on the CPU: {n_codes} codes, "
          f"{n_diff} differ (each a near-tie on the card's latents) [{gpu}]")
    return launches


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


def _experiment_workdir(work, epochs=EXPERIMENT_EPOCHS):
    """configurations/ (the base YAML linked, the experiments JSON with
    jitter12 alone and num_epochs cut) and data/vctk/raw linked to the
    tracked corpus, as the CLI expects them under its working directory."""
    with open(os.path.join(REPO_ROOT, EXPERIMENTS_SPEC)) as f:
        spec = json.load(f)
    spec["experiments"] = {EXPERIMENT: dict(spec["experiments"][EXPERIMENT],
                                            num_epochs=epochs)}
    os.makedirs(os.path.join(work, "configurations"))
    os.symlink(os.path.join(REPO_ROOT, "configurations", "vctk_features.yaml"),
               os.path.join(work, "configurations", "vctk_features.yaml"))
    with open(os.path.join(work, EXPERIMENTS_SPEC), "w") as f:
        json.dump(spec, f, indent=4)
    os.makedirs(os.path.join(work, "data", "vctk"))
    os.symlink(CORPUS_ROOT, os.path.join(work, "data", "vctk", "raw"))
    return spec


def experiment_phase(gpu, work):
    """The flagship's training loop through the port's CLI in ``work``,
    resumed, then the loop in process and the trained checkpoint served;
    returns (the VQ kernel's launches on that path, the loop's ms a step
    without the checkpoint, the bare step's at batch 2). ``work`` keeps the
    trained experiment for the evaluate phase."""
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


# the CLI evaluation of the trained jitter12 checkpoint on the val split:
# every option that writes numbers, no figures (no matplotlib on the card's
# machine); in process, the same options with the speaker and entropy pass
EVALUATE_FLAGS = ("--evaluate", "--compute_alignments", "--per_frame_alignments",
                  "--compute_clustering_metrics", "--compute_many_to_one_mapping",
                  "--compute_groundtruth_average_phonemes_number",
                  "--no_figures")
EVALUATE_OPTIONS = dict(
    {flag[2:]: True for flag in EVALUATE_FLAGS[1:-1]},
    alignment_subset="val", compute_speaker_dependency_stats=True,
    compute_entropy_distributions=True)
CLUSTERING_METRICS = ("adjusted_rand_score", "adjusted_mutual_info_score",
                      "normalized_mutual_info_score")
# the single-batch capture's distances against vq_distances on the same rows,
# and its pairwise distances against a float64 numpy recomputation
CAPTURE_DISTANCE_RTOL = 1e-5
PAIRWISE_RTOL = 1e-4


def _train_one_epoch(work):
    """For an evaluate phase run without the experiment phase: the export,
    the stats and one epoch of jitter12 through the CLI in ``work``."""
    _experiment_workdir(work, epochs=1)
    for args in (("--export_to_features",), ("--compute_dataset_stats",), ()):
        _cli(work, *args)


def _evaluated_files():
    """The number files the CLI evaluation writes, under the JAX
    package's names."""
    names = {"vctk_val_groundtruth_alignments.pickle",
             "vctk_val_groundtruth_bigrams_wo_diag_20ms.npy",
             f"{EXPERIMENT}_vctk_val_empirical_alignments.pickle",
             f"{EXPERIMENT}_vctk_val_empirical_alignments_per_frame.pickle",
             f"{EXPERIMENT}_vctk_val_empirical_bigrams_wo_diag_10ms.npy",
             f"{EXPERIMENT}_phonemes_mapping.pickle",
             f"{EXPERIMENT}_tokens_mapping.pickle"}
    for metric in CLUSTERING_METRICS:
        names |= {f"{EXPERIMENT}_{metric}.npy",
                  f"{EXPERIMENT}_per_frame_{metric}.npy"}
    return names


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def evaluate_phase(gpu, work):
    """The trained experiment in ``work`` evaluated through the port's CLI
    (--evaluate ... --no_figures), then in process: the launch count, the
    model unchanged, the single-batch capture, K1 against the plain search
    on this path, the sweep's rate and device profile. Returns the VQ
    kernel's launches on the in-process evaluation."""
    import math

    import torch
    from vqvae_speech_tpu_torch.data import FeatureStore
    from vqvae_speech_tpu_torch.eval import Evaluator, alignment_stats
    from vqvae_speech_tpu_torch.ops import (
        _kernels,
        reference_flatten,
        vq_distances,
        vq_search_torch,
    )
    from vqvae_speech_tpu_torch.train import (
        Experiment,
        latest_checkpoint_epoch,
        load_configuration,
        update_configuration_from_experiments,
    )
    from vqvae_speech_tpu_torch.utils.profiling import device_events

    cli_sec, _ = _cli(work, *EVALUATE_FLAGS)
    here = os.getcwd()
    try:
        os.chdir(work)
        with open(EXPERIMENTS_SPEC) as f:
            spec = json.load(f)
        exp_dir, results = spec["experiments_path"], spec["results_path"]
        epoch, _ = latest_checkpoint_epoch(exp_dir, EXPERIMENT)
        base = update_configuration_from_experiments(
            EXPERIMENTS_SPEC, load_configuration(os.path.join(
                "configurations", "vctk_features.yaml")))
        exp = Experiment(EXPERIMENT, exp_dir, "results_in_process", base,
                         spec["experiments"][EXPERIMENT], spec["seed"],
                         device="cuda")
        cfg = exp.configuration
        store = FeatureStore(os.path.join(cfg["data_root"],
                                          cfg["features_path"]))
        meta = store.metadata("val")
        n_val = store.num_examples("val")
        phonemes = os.path.join(cfg["data_root"], "raw", "VCTK-Corpus",
                                "phonemes")
        with_textgrid = {alignment_stats.utterance_key(w)
                         for w in meta["wav_filenames"]
                         if os.path.isfile(alignment_stats.textgrid_path(
                             phonemes, w))}

        # 1. the CLI's files
        got_files = set(os.listdir(results))
        if got_files != _evaluated_files():
            raise AssertionError(f"evaluate: the CLI wrote {sorted(got_files)}")
        gt = _load_pickle(os.path.join(
            results, "vctk_val_groundtruth_alignments.pickle"))
        gt_keys = [k for k, _ in gt["extended_alignment_dataset"]]
        if (not gt_keys or not set(gt_keys) <= with_textgrid
                or {len(a) for _, a in gt["extended_alignment_dataset"]}
                != {24}):
            raise AssertionError(
                f"evaluate: {len(gt_keys)} groundtruth alignments of "
                f"lengths {sorted({len(a) for _, a in gt['extended_alignment_dataset']})} "
                f"for {len(with_textgrid)} val utterances with TextGrids")
        emp = {}
        for suffix in ("", "_per_frame"):
            dic = _load_pickle(os.path.join(
                results,
                f"{EXPERIMENT}_vctk_val_empirical_alignments{suffix}.pickle"))
            seqs = [s for _, s in dic["all_alignments"]]
            if (len(seqs) != n_val or {s.shape for s in seqs} != {(24,)}
                    or {s.dtype for s in seqs} != {np.dtype(np.int32)}):
                raise AssertionError(f"evaluate: empirical alignments{suffix}"
                                     f" of {len(seqs)} utterances")
            emp[suffix] = dic
        scores = {}
        for suffix in ("", "_per_frame"):
            for metric in CLUSTERING_METRICS:
                v = float(np.load(os.path.join(
                    results, f"{EXPERIMENT}{suffix}_{metric}.npy")))
                if not (np.isfinite(v) and -1.0 <= v <= 1.0):
                    raise AssertionError(f"evaluate: {suffix} {metric} {v}")
                scores[suffix + metric] = v
        print(f"evaluate: CLI `main {' '.join(EVALUATE_FLAGS)}` on the "
              f"epoch-{epoch} checkpoint: {cli_sec:.2f} s wall clock "
              f"(process start included); {len(got_files)} files under the "
              f"JAX package's names; {n_val} empirical alignments of 24 codes "
              f"in each pairing; {len(gt_keys)} groundtruth alignments of "
              f"{len(with_textgrid)} val utterances with TextGrids [{gpu}]")
        print("evaluate scores (reference pairing / per-frame): " + ", ".join(
            f"{m} {scores[m]:.5f} / {scores['_per_frame' + m]:.5f}"
            for m in CLUSTERING_METRICS))

        # 2. in process: the launch count, the model unchanged; the
        # evaluator, not this script, sets the f32 numerics the CLI runs
        torch.backends.cudnn.allow_tf32 = True
        ev = Evaluator(exp, device="cuda", figures=False)
        if torch.backends.cudnn.allow_tf32:
            raise AssertionError("evaluate: the evaluator left cuDNN's TF32 "
                                 "on")
        model = ev._load_model()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        _kernels.vq_search_cuda.launches = 0
        t0 = time.perf_counter()
        ev.evaluate(EVALUATE_OPTIONS)
        entry = ev._evaluate_once()
        torch.cuda.synchronize()
        in_process_sec = time.perf_counter() - t0
        launches = _kernels.vq_search_cuda.launches
        # alignments in both pairings and the mapping at batch 32, the
        # speaker and entropy pass at 16, the capture's one utterance
        want_launches = 3 * math.ceil(n_val / 32) + math.ceil(n_val / 16) + 1
        if launches != want_launches:
            raise AssertionError(f"evaluate: {launches} vq_search launches, "
                                 f"{want_launches} encode batches")
        after = model.state_dict()
        if before.keys() != after.keys() or not all(
                torch.equal(v, after[k]) for k, v in before.items()):
            raise AssertionError("evaluate: the evaluation changed the model")
        for suffix, dic in emp.items():
            again = _load_pickle(os.path.join(
                "results_in_process",
                f"{EXPERIMENT}_vctk_val_empirical_alignments{suffix}.pickle"))
            if not all(np.array_equal(a, b) for (_, a), (_, b) in zip(
                    again["all_alignments"], dic["all_alignments"])):
                raise AssertionError(f"evaluate: in process, the empirical "
                                     f"alignments{suffix} differ from the "
                                     "CLI's")

        # the single-batch capture
        K = cfg["num_embeddings"]
        idx = entry["encoding_indices"][:, 0]
        if not np.array_equal(entry["encodings"].argmax(-1).reshape(-1), idx):
            raise AssertionError("evaluate: encodings.argmax != indices")
        codebook = model.vq.codebook.detach()
        x = torch.from_numpy(entry["valid_originals"]).cuda()
        with torch.inference_mode():
            flat = reference_flatten(model.latents(x), codebook.shape[1])
            d = vq_distances(flat, codebook).cpu().numpy()
        d_err = np.abs(entry["distances"].reshape(-1, K) - d).max() / np.abs(
            d).max()
        flat64 = flat.double().cpu().numpy()
        cb64 = codebook.double().cpu().numpy()
        want_c = np.sqrt(((flat64[:, None] - cb64[None]) ** 2).sum(-1))
        want_p = np.sqrt(((flat64[:, None] - flat64[None]) ** 2).sum(-1))[
            np.triu_indices(len(flat64), 1)]
        want_e = np.sqrt(((cb64[:, None] - cb64[None]) ** 2).sum(-1))[
            np.triu_indices(K, 1)]
        pair_err = max(
            np.abs(entry["frames_vs_embedding_distances"].reshape(-1, K)
                   - want_c).max() / want_c.max(),
            np.abs(entry["encoding_distances"][0] - want_p).max()
            / want_p.max(),
            np.abs(entry["embedding_distances"] - want_e).max() / want_e.max())
        if not (d_err <= CAPTURE_DISTANCE_RTOL and pair_err <= PAIRWISE_RTOL):
            raise AssertionError(f"evaluate: capture distances {d_err:.2e}, "
                                 f"pairwise {pair_err:.2e}")

        # 3. K1 against the plain search on this path's batches
        feats = alignment_stats.normalized_features(store.open("val"), cfg)
        D = codebook.shape[1]
        near_ties, plain = {}, {}
        for suffix, dic in emp.items():
            cli_codes = np.stack([s for _, s in dic["all_alignments"]])
            n_diff, rows = 0, []
            for at in range(0, n_val, 32):
                xb = torch.from_numpy(feats[at:at + 32]).cuda()
                with torch.inference_mode():
                    z = model.latents(xb)
                    fb = (z.transpose(1, 2).reshape(-1, D) if suffix
                          else reference_flatten(z, D))
                    want = vq_search_torch(fb, codebook).indices
                got = torch.from_numpy(cli_codes[at:at + 32].reshape(-1)).cuda()
                n_diff += _near_ties(fb, codebook, got, want,
                                     NEAR_TIE_SAME_INPUT)
                rows.append(want.view(xb.shape[0], -1).cpu().numpy())
            near_ties[suffix] = n_diff
            plain[suffix] = dict(dic, all_alignments=[
                (k, s) for (k, _), s in zip(dic["all_alignments"],
                                            np.concatenate(rows))])
        scores_match = "not compared (near-tie rows differ)"
        if not any(near_ties.values()):
            os.makedirs("results_plain")
            shutil.copy(os.path.join(
                results, "vctk_val_groundtruth_alignments.pickle"),
                "results_plain")
            for suffix, dic in plain.items():
                with open(os.path.join(
                        "results_plain",
                        f"{EXPERIMENT}_vctk_val_empirical_alignments"
                        f"{suffix}.pickle"), "wb") as f:
                    pickle.dump(dic, f)
                got_scores = alignment_stats.compute_clustering_metrics(
                    "results_plain", EXPERIMENT, "val", cfg,
                    per_frame=bool(suffix))
                for metric, value in got_scores.items():
                    if value != scores[suffix + metric]:
                        raise AssertionError(
                            f"evaluate: {suffix} {metric} from the plain "
                            f"search's alignments {value} vs the CLI's "
                            f"{scores[suffix + metric]}")
            scores_match = "equal to the CLI's"
        print(f"evaluate: in process through Evaluator(device='cuda', "
              f"figures=False), the same options with the speaker and "
              f"entropy pass, then the single-batch capture: "
              f"{in_process_sec:.3f} s, {launches} vq_search launches = the "
              f"encode batches ({math.ceil(n_val / 32)} x 3 at batch 32, "
              f"{math.ceil(n_val / 16)} at 16, 1 at 1); the model's "
              f"parameters and buffers bit-equal after; empirical alignments "
              f"equal to the CLI's; capture distances within {d_err:.1e} of "
              f"vq_distances, pairwise within {pair_err:.1e} of float64 "
              f"numpy; K1 against vq_search_torch on this path's batches: "
              f"near-tie rows {near_ties['']} (reference pairing), "
              f"{near_ties['_per_frame']} (per-frame), scores from the plain "
              f"search's alignments {scores_match}")

        # 4. the empirical sweep's rate and device profile
        def sweep():
            alignment_stats.compute_empirical_alignments(
                model, store, "val", cfg, "results_sweep", EXPERIMENT)
            torch.cuda.synchronize()

        sweep_launches = math.ceil(n_val / 32)
        sweep()
        sweep_sec = _median_seconds(sweep, repeats=5)

        def check(events):
            return sum(e.count for e in events if "vq_" in e.key) == \
                sweep_launches

        window, events = device_events(sweep, check=check)
        busy_us = sum(e.us for e in events)
        k1_us = sum(e.us for e in events if "vq_" in e.key)
        print(f"evaluate sweep (compute_empirical_alignments, {n_val} val "
              f"utterances at batch 32, {sweep_launches} K1 launches): "
              f"{n_val / sweep_sec:.1f} utterances/s ({sweep_sec * 1e3:.2f} "
              f"ms, median of 5, host clock); torch.profiler window "
              f"{window * 1e3:.2f} ms, device busy {busy_us / 1e3:.3f} ms, "
              f"idle share {1 - busy_us / 1e6 / window:.3f}, K1 "
              f"{k1_us:.1f} us = {k1_us / busy_us:.4f} of device time "
              f"[{gpu}]")
        for e in sorted(events, key=lambda e: -e.us)[:5]:
            print(f"  {e.us:10.1f} us  {e.count:4d}x  {e.key[:90]}")
        return launches
    finally:
        os.chdir(here)


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
            groups = step.launches_per_step
            _, busy_us = _device_profile(
                lambda: [step(x0, taps, cond) for _ in range(20)],
                "step_kernel", lambda: 20 * groups)
            device = (f"{sum(busy_us.values()) / 20 / 1e3:.4f} ms a step of "
                      f"{groups} launch{'es' if groups > 1 else ''}")
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
            if width is None and k == 3 and legacy and groups == 1:
                prof = _step_phase_profile(step, x0, taps, cond)
                print(f"kernel glu_stack_step B={B}: inside one launch, us "
                      f"a phase (mean over layers; the slowest block's "
                      f"staging, products, stores; the rest is the barrier "
                      f"and the blocks' spread): gate {_us(prof['gate'])}; "
                      f"projection {_us(prof['proj'])}; first phase start "
                      f"to last store {prof['launch']:.1f} us; SM clock "
                      f"{prof['mhz']:.0f} MHz")
            print(f"kernel glu_stack_step L={L} k={k} B={B} C={C} G={G} "
                  f"S={w['wskip'].shape[2]} legacy={legacy} ({groups} "
                  f"launch{'es' if groups > 1 else ''} a step): max_abs_err "
                  f"{err:.3e}, two runs bit-equal; kernel {ms:.4f} ms/step "
                  f"({gbps:.0f} GB/s of {weight_bytes / 1e6:.1f} MB weights, "
                  f"bound {bound_ms:.4f} ms, {bound_ms / ms:.3f} of the "
                  f"kernel's time), plain {plain_ms:.4f} ms/step (mean of "
                  f"100 back-to-back launches, CUDA events); kernel's "
                  f"device time {device} (torch.profiler, 20 launches) "
                  f"[{gpu}]")
    return max_err, timed


_SYNTH_MODEL = []


def synthesis_model():
    """(numpy params, WaveNet config, WaveNetVQVAE on the card) at the
    vctk_wavenet width, weights from numpy seed SEED; made once a run, for
    the synthesis and continuous phases."""
    if not _SYNTH_MODEL:
        from vqvae_speech_tpu_torch.convert import (
            load_wavenet_vqvae_params,
            numpy_wavenet_vqvae_params,
        )
        from vqvae_speech_tpu_torch.models import WaveNetVQVAE

        n_spk = WAVENET_CONFIG["num_speakers"]
        params, state, wcfg = numpy_wavenet_vqvae_params(
            WAVENET_CONFIG, n_spk, seed=SEED)
        model = load_wavenet_vqvae_params(WaveNetVQVAE(WAVENET_CONFIG, n_spk),
                                          params, state).cuda().eval()
        _SYNTH_MODEL.append((params, wcfg, model))
    return _SYNTH_MODEL[0]


def synthesis_phase(gpu):
    """WaveNet-VQ-VAE synthesis serving at the vctk_wavenet width."""
    import torch
    from vqvae_speech_tpu_torch.ops import (
        _kernels,
        mu_law_decode,
        mu_law_encode,
        vq_search,
        vq_search_torch,
    )
    from vqvae_speech_tpu_torch.serve import BucketedSynthesisServer

    t0 = time.perf_counter()
    params, wcfg, model = synthesis_model()
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


# continuous-batching AR synthesis: the synthesis phase's model and requests
CONT_SLOTS, CONT_CHUNK, CONT_MAX_FRAMES = 8, 512, 23
CONT_STANDALONE = (0, 9)        # requests held against a batch-1 decode
# more slots than one launch of K2 takes (32): 64 one-frame requests (the
# ten requests' frames 0..6) in chunks of 256 steps, two launches a step
WIDE_SLOTS, WIDE_CHUNK, WIDE_FRAMES = 64, 256, 7
# the per-layer decodes, one chunk at 8 slots on the card and on the CPU;
# 2 conditioning frames a slot (768 samples) hold the chunk's 512 steps
NARROW_CONFIGS = (("int8", dict(weight_quant="int8")),
                  ("int8_block", dict(weight_quant="int8_block")),
                  ("bf16", dict(compute_dtype="bfloat16")))
NARROW_FRAMES = 2
# the CPU's run of the same chunk covers its first steps: a bf16 stream
# parts from the card's after 27 steps or more, and the CPU takes 14-183 ms
# a step at this width, by host
NARROW_CPU_STEPS = 64
# a bf16 near-tie: the top two logits within 2**-6 of the top one's
# magnitude (2-4 bf16 ulps: cuBLAS and the CPU's bf16 products round apart)
BF16_NEAR_TIE_REL = 2 ** -6
SCALAR_STEPS = 384              # the mixture WaveNet's decode, at 8 streams
PROFILED_CHUNKS = 3             # the idle share's window, a full pool


def _first_flip(got, want, logits, tie):
    """(first step where two streams of one request part, or None; the
    top-two gap of ``logits`` there). Raises unless the gap is within
    ``tie(top logit)``."""
    diff = np.flatnonzero(np.asarray(got) != np.asarray(want))
    if not len(diff):
        return None, None
    at = int(diff[0])
    top2 = np.sort(np.asarray(logits[at]))[-2:]
    gap = float(top2[1] - top2[0])
    if not gap <= tie(float(top2[1])):
        raise AssertionError(f"streams part at step {at} where the top two "
                             f"logits are {gap:.3e} apart, no near-tie")
    return at, gap


def _narrow_chunk(module, wcfg, lcs, speakers, kw, steps):
    """One chunk of ``steps`` steps of 8 admitted slots through the
    per-layer decode of ``kw`` on the f32 ``module``'s device: (bins
    (8, steps), logits (8, steps, 256), seconds)."""
    import torch
    from vqvae_speech_tpu_torch.models.wavenet import cast_floating
    from vqvae_speech_tpu_torch.models.wavenet.chunked import (
        admit_slot,
        decode_chunk,
        init_decode_slots,
        slot_conditioning,
    )

    kw = {k: getattr(torch, v) if k == "compute_dtype" else v
          for k, v in kw.items()}
    module = cast_floating(module, kw.get("compute_dtype"))
    device = module.first_conv.bias.device
    max_t = NARROW_FRAMES * module.upsample_factor
    prep, state = init_decode_slots(module, wcfg, CONT_SLOTS, max_t, **kw)
    for slot in range(CONT_SLOTS):
        c = lcs[slot][:NARROW_FRAMES].detach().to(device)
        rows = slot_conditioning(module, wcfg, c, speakers[slot], max_t)
        admit_slot(prep, state, slot, rows)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, em, outs = decode_chunk(prep, state, wcfg, steps, sample=False,
                               return_logits=True)
    em, outs = em.cpu().numpy(), outs.cpu().numpy()
    return em, outs, time.perf_counter() - t0


def continuous_phase(gpu):
    """ContinuousSynthesisServer at the vctk_wavenet width: the synthesis
    phase's model and its ten VCTK requests, greedy, f32 (K2 a step)."""
    import dataclasses

    import torch
    from vqvae_speech_tpu_torch.convert import (
        load_wavenet_params,
        numpy_wavenet_params,
    )
    from vqvae_speech_tpu_torch.models.wavenet import (
        WaveNet,
        wavenet_incremental_generate,
    )
    from vqvae_speech_tpu_torch.ops import _kernels, mu_law_decode
    from vqvae_speech_tpu_torch.serve import (
        BucketedSynthesisServer,
        ContinuousSynthesisServer,
    )

    parts = [("start", time.perf_counter())]
    t0 = time.perf_counter()
    params, wcfg, model = synthesis_model()
    tree = params["decoder"]["wavenet"]
    server = ContinuousSynthesisServer(
        tree, wcfg, slots=CONT_SLOTS, chunk_size=CONT_CHUNK,
        max_frames=CONT_MAX_FRAMES, device="cuda")
    waves, speakers = synthesis_requests()
    factor = server.stats["upsample_factor"]
    print(f"continuous: set-up {time.perf_counter() - t0:.2f} s "
          f"({len(waves)} requests, {CONT_SLOTS} slots, chunk {CONT_CHUNK}, "
          f"max_frames {CONT_MAX_FRAMES})")

    # the main path: waves -> features -> codes (VQ kernel) -> local
    # conditioning -> continuous batching (decode-step kernel every step)
    _kernels.vq_search_cuda.launches = 0
    _kernels.wavenet_step_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lcs = [model.local_conditioning(wavenet_features(w, "cuda"))[0][0]
               for w in waves]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = server.run(lcs, speakers)
    sec = time.perf_counter() - t1     # the run ends in a device-to-host copy
    main_sec = time.perf_counter() - t0
    vq_launches = _kernels.vq_search_cuda.launches
    step_launches = _kernels.wavenet_step_cuda.launches
    stats = server.stats
    if step_launches != stats["launches"] * CONT_CHUNK:
        raise AssertionError(f"decode-step kernel launched {step_launches} "
                             f"times in {stats['launches']} chunks of "
                             f"{CONT_CHUNK}")
    if vq_launches == 0:
        raise AssertionError("the VQ kernel never ran on the continuous path")
    lengths = [lc.shape[0] * factor for lc in lcs]
    for n, r in zip(lengths, results):
        if r.wave.shape != (n,):
            raise AssertionError(f"wave {r.wave.shape} for {n} samples")
        audio = mu_law_decode(torch.from_numpy(r.wave), wcfg.out_channels)
        if not (bool(torch.isfinite(audio).all())
                and float(audio.abs().max()) <= 1.0):
            raise AssertionError("decoded audio not finite or outside [-1, 1]")
    print(f"continuous: main path {main_sec:.2f} s, {stats['launches']} "
          f"chunks = {step_launches} decode steps, each one decode-step "
          f"kernel launch; vq_search {vq_launches}; {sum(lengths)} samples "
          f"(LC frames {[lc.shape[0] for lc in lcs]}) decoded to finite "
          f"audio in [-1, 1]")
    print(f"continuous stats: {json.dumps(stats)}")

    parts.append(("main", time.perf_counter()))
    # each stream against a standalone batch-1 decode through the kernel
    # (its bucketed path at max_batch 1): the same weights, another batch
    # size for the kernel and for the upsampler's and hoist's products
    for i in CONT_STANDALONE:
        outs, em = wavenet_incremental_generate(
            server.model, wcfg, lengths[i], c=lcs[i][None],
            g=torch.tensor([speakers[i]], device="cuda"), sample=False,
            use_fused_stack=True)
        at, gap = _first_flip(results[i].wave, em[0].cpu().numpy(),
                              outs[0].cpu().numpy(),
                              lambda top: NEAR_TIE_LOGITS)
        print(f"continuous request {i} vs a standalone batch-1 decode: " + (
            f"equal in all {lengths[i]} samples" if at is None else
            f"equal up to sample {at} of {lengths[i]}, where the standalone "
            f"decode's top two logits lie {gap:.3e} apart (a near-tie)"))

    parts.append(("standalone", time.perf_counter()))
    # admission time and neighbours: the last request served alone (the
    # drained pool rewinds its clock: slot 0 at clock 0) is bit-equal to
    # its stream admitted last behind the other nine
    last = len(lcs) - 1
    alone = server.run([lcs[last]], [speakers[last]])[0].wave
    if not np.array_equal(alone, results[last].wave):
        raise AssertionError(f"request {last} alone differs from request "
                             f"{last} admitted behind the others")
    print(f"continuous: request {last} served alone bit-equal to its stream "
          f"admitted last behind the other {last} ({len(alone)} samples)")

    parts.append(("alone", time.perf_counter()))
    # the bucketed server (frame buckets 12 and 23 at max_batch 8) on the
    # same conditioning; a stream that parts must part at a near-tie of
    # the plain teacher-forced forward over the continuous stream
    bucketed = BucketedSynthesisServer(
        tree, wcfg, frame_buckets=SYNTH_BUCKETS, max_batch=SYNTH_MAX_BATCH,
        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_results = bucketed.synthesize(lcs, speakers)
    b_sec = time.perf_counter() - t0
    parted = []
    for i, (r, b) in enumerate(zip(results, b_results)):
        if np.array_equal(r.wave, b.wave):
            continue
        emitted = torch.from_numpy(r.wave)[None].cuda()
        with torch.inference_mode():
            forward = server.model(
                teacher_forced_inputs(emitted, wcfg.out_channels),
                lcs[i][None], torch.tensor([speakers[i]], device="cuda"))
        at, gap = _first_flip(r.wave, b.wave, forward[0].cpu().numpy(),
                              lambda top: NEAR_TIE_LOGITS)
        parted.append((i, at, f"{gap:.2e}"))
    print(f"continuous vs bucketed streams: {len(lcs) - len(parted)} of "
          f"{len(lcs)} equal; parted (request, first sample, top-two gap of "
          f"the teacher-forced logits there): {parted}")

    parts.append(("bucketed", time.perf_counter()))
    wide_launches = _wide_pool(server, tree, wcfg, lcs, speakers, gpu)
    parts.append(("64 slots", time.perf_counter()))
    # throughput and latency of the main path's drain, then the device's
    # idle share
    rate = WAVENET_CONFIG["sampling_rate"]
    chunks = stats["launches"]
    real = sum(lengths)
    print(f"continuous: drain of {len(lcs)} requests {sec:.3f} s, {chunks} "
          f"chunks, {sec / chunks:.4f} s a chunk, "
          f"{sec / (chunks * CONT_CHUNK) * 1e3:.4f} ms a decode step, "
          f"{real / sec:.0f} samples/s delivered, real-time factor of a "
          f"stream {sec / (real / len(lcs) / rate):.3f}; bucketed "
          f"synthesize {b_sec:.3f} s, {real / b_sec:.0f} samples/s delivered "
          f"({bucketed.stats['launches']} launches); continuous / bucketed "
          f"{b_sec / sec:.3f} [{gpu}]")
    print(f"continuous latency in chunks (slot_utilization "
          f"{stats['slot_utilization']}): latency {stats['latency_chunks']}, "
          f"admission wait {stats['admission_wait_chunks']}, decode "
          f"{stats['decode_chunks']}; in seconds at {sec / chunks:.4f} s a "
          f"chunk: latency p50 {stats['latency_chunks']['p50'] * sec / chunks:.3f}"
          f", p90 {stats['latency_chunks']['p90'] * sec / chunks:.3f} [{gpu}]")

    # a full pool for PROFILED_CHUNKS chunks: the first 8 requests cut to
    # their first frames (the profiler takes ~7 ms a step to read a window
    # back: a whole drain's took 110 s)
    cut = [lc[:PROFILED_CHUNKS * CONT_CHUNK // factor]
           for lc in lcs[:CONT_SLOTS]]

    def drain():
        _kernels.wavenet_step_cuda.launches = 0
        server.run(cut, speakers[:CONT_SLOTS])

    window, busy_us = _device_profile(
        drain, "step_kernel", lambda: _kernels.wavenet_step_cuda.launches)
    total_us = sum(busy_us.values())
    kernel_us = sum(v for k, v in busy_us.items() if "step_kernel" in k)
    print(f"continuous profile (8 slots busy, {len(cut[0])} frames each: "
          f"{_kernels.wavenet_step_cuda.launches} steps; torch.profiler CUDA "
          f"activity through utils.profiling.device_events): window "
          f"{window:.3f} s, "
          f"device busy {total_us / 1e6:.3f} s, idle share "
          f"{1 - total_us / 1e6 / window:.3f}; decode-step kernels "
          f"{kernel_us / total_us:.3f} of device time [{gpu}]")
    for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {us / 1e3:10.2f} ms  {name[:100]}")
    k2_ms = sec / (chunks * CONT_CHUNK) * 1e3

    parts.append(("profile", time.perf_counter()))
    # the bf16 and int8 decodes: one chunk at 8 slots on the card and the
    # same on the CPU at the same weights, streams equal up to a near-tie
    cpu_lcs = [lc.detach().cpu() for lc in lcs[:CONT_SLOTS]]
    cpu_model = load_wavenet_params(WaveNet(wcfg), tree).eval()
    for name, kw in NARROW_CONFIGS:
        before = _kernels.wavenet_step_cuda.launches
        em, outs, sec = _narrow_chunk(server.model, wcfg, lcs, speakers, kw,
                                      CONT_CHUNK)
        if _kernels.wavenet_step_cuda.launches != before:
            raise AssertionError(f"{name}: the decode-step kernel ran")
        cpu_em, cpu_outs, cpu_sec = _narrow_chunk(
            cpu_model, wcfg, cpu_lcs, speakers, kw, NARROW_CPU_STEPS)
        em, outs = em[:, :NARROW_CPU_STEPS], outs[:, :NARROW_CPU_STEPS]
        if not np.isfinite(outs).all():
            raise AssertionError(f"{name}: logits not finite")
        if name == "bf16":
            def tie(top):
                return BF16_NEAR_TIE_REL * max(1.0, abs(top))
        else:
            def tie(top):
                return NEAR_TIE_LOGITS
        flips = [_first_flip(em[s], cpu_em[s], cpu_outs[s], tie)
                 for s in range(CONT_SLOTS)]
        agree = [NARROW_CPU_STEPS if at is None else at for at, _ in flips]
        err = max(np.abs(outs[s, :n] - cpu_outs[s, :n]).max()
                  for s, n in enumerate(agree) if n)
        print(f"continuous {name}: one chunk of {CONT_CHUNK} steps at "
              f"{CONT_SLOTS} slots, per-layer path on the card "
              f"{sec / CONT_CHUNK * 1e3:.4f} ms a step "
              f"({sec / CONT_CHUNK * 1e3 / k2_ms:.1f}x the f32 step through "
              f"K2, {k2_ms:.4f} ms in the drain), on the CPU "
              f"{cpu_sec / NARROW_CPU_STEPS * 1e3:.3f} ms a step; streams "
              f"equal to the CPU's first {NARROW_CPU_STEPS} for {agree} "
              f"steps (parting at near-ties, gaps "
              f"{[None if g is None else f'{g:.1e}' for _, g in flips]}), "
              f"logits before max abs diff {err:.3e} [{gpu}]")

    parts.append(("narrow", time.perf_counter()))
    # a scalar-input (mixture-of-logistics) WaveNet at the same width
    # through the kernel, greedy and sampled
    scfg = dataclasses.replace(wcfg, scalar_input=True, out_channels=30)
    smodel = load_wavenet_params(WaveNet(scfg), numpy_wavenet_params(
        scfg, SEED)).cuda().eval()
    c = torch.stack([lc[:1] for lc in lcs[:CONT_SLOTS]])
    g = torch.tensor(speakers[:CONT_SLOTS], device="cuda")
    before = _kernels.wavenet_step_cuda.launches
    s_outs, greedy = wavenet_incremental_generate(
        smodel, scfg, SCALAR_STEPS, c=c, g=g, sample=False,
        use_fused_stack=True)
    _, sampled = wavenet_incremental_generate(
        smodel, scfg, SCALAR_STEPS, c=c, g=g, sample=True,
        generator=torch.Generator(device="cuda").manual_seed(SEED),
        use_fused_stack=True)
    launches = _kernels.wavenet_step_cuda.launches - before
    if launches != 2 * SCALAR_STEPS:
        raise AssertionError(f"scalar input: {launches} kernel launches for "
                             f"2 x {SCALAR_STEPS} steps")
    if not (bool(torch.isfinite(greedy).all())
            and bool(torch.isfinite(sampled).all())
            and float(sampled.abs().max()) <= 1.0
            and torch.equal(greedy, s_outs[..., 0])):
        raise AssertionError("scalar input: samples not finite, sampled "
                             "outside [-1, 1] or greedy not the logits' "
                             "first channel")
    print(f"continuous scalar input (10 logistics, C=G=768): {SCALAR_STEPS} "
          f"steps at {CONT_SLOTS} streams greedy and sampled, {launches} "
          f"decode-step kernel launches; greedy in "
          f"[{float(greedy.min()):.3f}, {float(greedy.max()):.3f}], sampled "
          f"in [{float(sampled.min()):.3f}, {float(sampled.max()):.3f}]")
    parts.append(("scalar", time.perf_counter()))
    print("continuous phase, seconds by part: " + ", ".join(
        f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t)
        in zip(parts, parts[1:])))
    return step_launches + wide_launches, vq_launches


def _wide_pool(server, tree, wcfg, lcs, speakers, gpu):
    """ContinuousSynthesisServer with WIDE_SLOTS slots, more than one launch
    of K2 takes: K2 on every step, once for each group of 32 slots. The
    streams against the 8-slot ``server``'s on the same requests: a stream
    may part where a group of 32 sums in another order than a group of 8,
    which must be a near-tie of the teacher-forced logits; the first such
    step and its top-two gap are printed. Returns K2's launches."""
    import torch
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.serve import ContinuousSynthesisServer

    reqs = [(lc[f:f + 1], spk) for f in range(WIDE_FRAMES)
            for lc, spk in zip(lcs, speakers)][:WIDE_SLOTS]
    conds, spks = [c for c, _ in reqs], [s for _, s in reqs]
    wide = ContinuousSynthesisServer(
        tree, wcfg, slots=WIDE_SLOTS, chunk_size=WIDE_CHUNK,
        max_frames=CONT_MAX_FRAMES, device="cuda")
    per_step = -(-WIDE_SLOTS // _kernels.WAVENET_STEP_GROUP)
    _kernels.wavenet_step_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = wide.run(conds, spks)
    sec = time.perf_counter() - t0
    launches = _kernels.wavenet_step_cuda.launches
    steps = wide.stats["launches"] * WIDE_CHUNK
    if launches != steps * per_step:
        raise AssertionError(f"{WIDE_SLOTS} slots: {launches} decode-step "
                             f"kernel launches in {steps} steps, not "
                             f"{per_step} a step")
    narrow = server.run(conds, spks)
    parted = []
    for i, (r, n) in enumerate(zip(results, narrow)):
        if np.array_equal(r.wave, n.wave):
            continue
        emitted = torch.from_numpy(r.wave)[None].cuda()
        with torch.inference_mode():
            forward = server.model(
                teacher_forced_inputs(emitted, wcfg.out_channels),
                conds[i][None], torch.tensor([spks[i]], device="cuda"))
        at, gap = _first_flip(r.wave, n.wave, forward[0].cpu().numpy(),
                              lambda top: NEAR_TIE_LOGITS)
        parted.append((i, at, f"{gap:.2e}"))
    print(f"continuous {WIDE_SLOTS} slots: {len(conds)} one-frame requests "
          f"({len(results[0].wave)} samples each), {wide.stats['launches']} "
          f"chunks of {WIDE_CHUNK} = {steps} steps, {launches} decode-step "
          f"kernel launches ({per_step} a step, groups of "
          f"{_kernels.WAVENET_STEP_GROUP}); {sec:.3f} s, "
          f"{sec / steps * 1e3:.4f} ms a step [{gpu}]")
    print(f"continuous {WIDE_SLOTS} slots vs {CONT_SLOTS} slots, greedy: "
          f"{len(conds) - len(parted)} of {len(conds)} streams equal; parted "
          f"(request, first sample, top-two gap of the teacher-forced logits "
          f"there, limit {NEAR_TIE_LOGITS}): {parted}")
    return launches


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


def chain_bound_bf16(L, k, T, C, G, S, cin):
    """One bf16 chain: the same operations, on bf16 x, c_up and weights
    (f32 biases), x written in bf16 and skip in f32. Returns (bound_ms,
    bound_by, bytes_ms, tensor_ms): the bytes over the memory rate, the
    operations over the tensor cores' dense bf16 peak, and the larger."""
    flops = T * L * (2 * (k * C + cin) * 2 * G + 2 * G * (C + S))
    weights = L * (2 * k * C * G + 2 * cin * G + G * (C + S))
    nbytes = (2 * (T * (C + cin) + weights + T * C)
              + 4 * (L * (2 * G + C + S) + T * S))
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return (*bound, bytes_ms, ops_ms)


def _bf16_chain(x, c, stacked):
    """The chain's inputs as the bf16 configuration gives them: x, c_up and
    the weights rounded to bf16, the biases f32."""
    return x.bfloat16(), c.bfloat16(), {
        n: w if n in ("bf", "bg", "bres", "bskip") else w.bfloat16()
        for n, w in stacked.items()}


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
    # the bf16 form: one bf16 product of the same bf16 values, exact
    # products summed in f32
    a16, b16 = a.bfloat16(), b.t().contiguous().bfloat16()
    got = _kernels.bf16_matmul_cuda(a16, b16)
    want = a16.float() @ b16.float().t()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    exact = a16.double() @ b16.double().t()
    errs = [(t.double() - exact).abs().max().item() for t in (got, want)]
    ms = _median_ms(lambda: _kernels.bf16_matmul_cuda(a16, b16), iters=20)
    print(f"kernel fused_block_chain_bf16 main loop: the same product of bf16 "
          f"values by wgmma m64n128k16 bf16: max abs err against float64 "
          f"{errs[0]:.3e} (torch.matmul of the values in f32 {errs[1]:.3e}); "
          f"within rtol 1e-5, atol 2e-5 of it; {ms:.4f} ms, "
          f"{2 * M * N * K / ms / 1e9:.0f} TFLOP/s of bf16 work")


def _gemm_yardstick(gpu, L=6, T=20480):
    """What cuBLAS takes for the student chain's products alone, (T, 464) @
    (464, 512) and (T, 256) @ (256, 256) L times, in f32, in one-pass TF32
    and in bf16 (bf16 operands and output, f32 sums). The port never calls
    it; allow_tf32 is restored. Returns the bf16 ms."""
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
    mats = [m.bfloat16() for m in mats]
    bf16_ms = _median_ms(products, iters=20, warmup=3)
    print(f"yardstick: the student chain's products alone at T={T}, {L} x "
          f"[({T}, 464) @ (464, 512) + ({T}, 256) @ (256, 256)] by "
          f"torch.matmul: {times[False]:.4f} ms in f32, {times[True]:.4f} ms "
          f"with allow_tf32 (one TF32 product a f32 product; 3 x that is "
          f"{3 * times[True]:.4f} ms), {bf16_ms:.4f} ms in bf16; no bias, "
          f"activation or epilogue [{gpu}]")
    return bf16_ms


def chain_kernel_phase(gpu):
    """The three fused-chain entry points (the kernels) against their plain
    PyTorch chains on the same CUDA tensors, within CHAIN_TOL, and bit-equal
    over two runs. The kernel's prepared weights are held against the same
    layout built with tensor operations, and a chain bound once
    (prepare_block_chain) against the bare call, bit for bit. Times each
    shape on prepared weights, as the shapes route it and forced onto the
    row-tiled and the split decomposition (the shapes choose one; the other
    shows where the switch lies), holding both against the plain chain.
    Then the three bf16 entry points at BF16_CHAIN_SHAPES: bit-equal over
    two runs, held to the plain bf16 chain by bf16_chain_check, their
    prepared bf16 weights against the plain layout, timed beside the plain
    bf16 chain and the f32 kernel at the same shape. Returns {wrapper, and
    wrapper + "_bf16": its kernels-line numbers at the first shape listed
    for it} and cuBLAS's bf16 time for the student chain's products alone
    under "yardstick_bf16_ms"."""
    import torch
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.ops import fused_resblock as fused

    f32_ms = {}
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
            f32_ms[name] = ms
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
    with torch.inference_mode():
        for name, which, L, k, dil, T, C, G, S, cin in BF16_CHAIN_SHAPES:
            x, c, stacked = _bf16_chain(
                *_random_chain(rng, L, k, T, C, G, S, cin))
            kernel = calls[which][0]
            extra = () if dil is None else (dil,)
            causal = dil is None
            got = kernel(x, c, stacked, L, k, *extra)
            split = _kernels._fused_chain_launch.last_split
            again = kernel(x, c, stacked, L, k, *extra)
            want, exact = (fused.fused_block_chain_bf16_torch(
                x, c, stacked, L, k, dil, causal=causal, exact=e)
                for e in (False, True))
            torch.cuda.synchronize()
            for g, g2 in zip(got, again):
                if not torch.equal(g, g2):
                    raise AssertionError(f"bf16 {name}: two runs on the same "
                                         "inputs differ")
            err, spread, flips, spread_flips = bf16_chain_check(
                f"bf16 {name}", got, want, exact)
            prepared = fused.prepare_block_chain(stacked)
            layout = fused.prepared_chain_weights_torch(stacked)
            torch.cuda.synchronize()
            if not (torch.equal(prepared.wgate, layout["wgate"])
                    and torch.equal(prepared.wproj, layout["wproj"])):
                raise AssertionError(f"bf16 {name}: the prepared weights "
                                     "differ from the plain layout")
            del layout
            for g, p in zip(got, kernel(x, c, prepared, L, k, *extra)):
                if not torch.equal(g, p):
                    raise AssertionError(f"bf16 {name}: the prepared chain "
                                         "and the bare call differ")
            ms = _median_ms(lambda: kernel(x, c, prepared, L, k, *extra),
                            iters=20, warmup=3)
            plain_ms = _median_ms(
                lambda: fused.fused_block_chain_bf16_torch(
                    x, c, stacked, L, k, dil, causal=causal),
                iters=20, warmup=3)
            bound_ms, bound_by, bytes_ms, tensor_ms = chain_bound_bf16(
                L, k, T, C, G, S, cin)
            row = out.setdefault(f"{which}_bf16", dict(
                max_abs_err=0.0, spread=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                tensor_bound_ms=tensor_ms))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["spread"] = max(row["spread"], spread)
            print(f"kernel fused_block_chain_bf16[{which}] {name}: L={L} k={k} "
                  f"dilations={dil or 'k**l'} T={T} C={C} G={G} S={S} "
                  f"cin={cin}: max_abs_err {err:.3e} against the plain bf16 "
                  f"chain, whose spread to the same chain with exact sums is "
                  f"{spread:.3e}; {flips:.2e} of x off the exact chain "
                  f"against the plain chain's {spread_flips:.2e} (limits "
                  f"{BF16_SPREAD_MULTIPLE} x), two runs bit-equal, "
                  f"prepared bf16 weights ({prepared.nbytes / 1e6:.1f} MB) "
                  f"equal the plain layout; kernel {ms:.4f} ms on the "
                  f"{'split' if split else 'row-tiled'} path (f32 kernel "
                  f"{f32_ms[name]:.4f} ms), plain bf16 chain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by} (bytes at bf16 "
                  f"{bytes_ms:.4f} ms, tensor bound at the dense bf16 peak "
                  f"{tensor_ms:.4f} ms; {bound_ms / ms:.3f} of the kernel's "
                  f"time; median of 20, CUDA events) [{gpu}]")
    out["yardstick_bf16_ms"] = _gemm_yardstick(gpu)
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
    """One-pass vocoder serving at paper width, each kind in f32 and in
    bf16 (_serve_kind), then the whole-T entry point at both dtypes; returns
    the chain kernels' launch counts on the main path, {wrapper: count}."""
    import torch
    from vqvae_speech_tpu_torch.convert import load_student_params
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.ops import fused_resblock as fused

    t0 = time.perf_counter()
    models = vocoder_models()
    mels = vocoder_requests("cuda")
    golden_f32 = np.load(VOCODER_GOLDEN)
    golden_bf16 = np.load(VOCODER_BF16_GOLDEN)
    golden_mel, golden_z = vocoder_golden_inputs()
    wrappers = {"tiled": _kernels.fused_block_chain_tiled_cuda,
                "chain": _kernels.fused_block_chain_cuda,
                "nc": _kernels.fused_block_chain_nc_cuda,
                "tiled_bf16": _kernels.fused_block_chain_tiled_bf16_cuda,
                "chain_bf16": _kernels.fused_block_chain_bf16_cuda,
                "nc_bf16": _kernels.fused_block_chain_nc_bf16_cuda}
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
        for dtype, golden in ((None, golden_f32), (torch.bfloat16, golden_bf16)):
            key = which if dtype is None else f"{which}_bf16"
            launches[key] = _serve_kind(
                gpu, kind, params, cfg, dict(common, compute_dtype=dtype),
                mels, key, chains, wrappers, golden[kind], golden_mel,
                golden_z, n_samples)
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
    # the same at bf16, on the student's first chain loaded at bf16
    stacked = load_student_params(params, cfg, "cuda",
                                  compute_dtype=torch.bfloat16
                                  )["iafs"][0]["chains"][0]
    x, c = x.bfloat16(), c.bfloat16()
    wrappers["chain_bf16"].launches = 0
    got = fused.fused_block_chain(x, c, stacked, cfg.num_layers,
                                  cfg.kernel_size)
    torch.cuda.synchronize()
    launches["chain_bf16"] = wrappers["chain_bf16"].launches
    if launches["chain_bf16"] != 1:
        raise AssertionError("fused_block_chain did not launch its bf16 kernel")
    want, exact = (fused.fused_block_chain_bf16_torch(
        x, c, stacked, cfg.num_layers, cfg.kernel_size, exact=e)
        for e in (False, True))
    err = bf16_chain_check("bf16 whole-T chain on the student's weights",
                           got, want, exact)[0]
    print("vocoder: fused_block_chain at bf16 on the student's first chain "
          f"(loaded at bf16) at T=4096: {launches['chain_bf16']} kernel launch,"
          f" max_abs_err {err:.3e}, within the spread check of its plain "
          "bf16 chain")
    return launches


def _serve_kind(gpu, kind, params, cfg, common, mels, key, chains, wrappers,
                golden, golden_mel, golden_z, n_samples):
    """One kind at one compute dtype (``common["compute_dtype"]``, None for
    f32): the main path through the fused server at max_batch 1 (mel
    requests -> buckets -> one-pass synthesis, every resblock chain one call
    of the wrapper ``key`` of the chain kernel, counted), held against the
    plain server at max_batch 8 on the same noise and, on the golden
    request, both against the JAX package's wave at that dtype; timed, with
    the plain server at max_batch 1, per bucket and under torch.profiler.
    Returns the wrapper's launches on the main path."""
    import torch
    from vqvae_speech_tpu_torch.serve import BucketedParallelSynthesisServer

    bf16 = common["compute_dtype"] == torch.bfloat16
    tag = f"{kind}{' bf16' if bf16 else ''}"
    # (max abs, mean abs or None) of a wave: fused vs plain, and vs golden
    fused_tol = VOCODER_BF16_FUSED_TOL[kind] if bf16 else (VOCODER_TOL, None)
    golden_tol = (VOCODER_BF16_GOLDEN_TOL[kind] if bf16
                  else (VOCODER_TOL, None))

    def within(err, tol):
        return err.max() <= tol[0] and (tol[1] is None or err.mean() <= tol[1])

    fused_server = BucketedParallelSynthesisServer(
        kind, params, cfg, max_batch=1, use_fused_chain=True, **common)
    plain_server = BucketedParallelSynthesisServer(
        kind, params, cfg, max_batch=8, **common)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = fused_server.synthesize(mels, seed=SEED)
    main_sec = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    want_counts = {n: chains * len(mels) if n == key else 0 for n in wrappers}
    if counts != want_counts:
        raise AssertionError(f"{tag}: chain kernel launches {counts}, "
                             f"expected {want_counts}")
    if sorted({r.bucket for r in results}) != [20, 40, 80]:
        raise AssertionError(f"{tag}: requests filled buckets "
                             f"{sorted({r.bucket for r in results})}")
    for mel, r in zip(mels, results):
        if (r.wave.shape != (mel.shape[0] * VOCODER_HOP,)
                or r.wave.dtype != np.float32):
            raise AssertionError(f"{tag}: wave {r.wave.shape} {r.wave.dtype} "
                                 f"for {mel.shape[0]} frames")
        if not (np.isfinite(r.wave).all() and r.wave.std() > 1e-3):
            raise AssertionError(f"{tag}: wave not finite or constant")
    print(f"vocoder {tag}: {len(mels)} requests through buckets [20, 40, "
          f"80], {fused_server.stats['launches']} launches, {chains} chains a "
          f"request; kernel launches {counts}; main path {main_sec:.3f} s "
          f"(first calls included); the chains' prepared weights hold "
          f"{_prepared_bytes(fused_server._params) / 1e6:.1f} MB")

    reference = plain_server.synthesize(mels, seed=SEED)
    diffs = [np.abs(r.wave - p.wave) for r, p in zip(results, reference)]
    if not all(within(d, fused_tol) for d in diffs):
        raise AssertionError(
            f"{tag}: fused vs plain server waves differ by up to "
            f"{max(d.max() for d in diffs):.3e} (mean "
            f"{max(d.mean() for d in diffs):.3e}), limits {fused_tol}")
    errs = {}
    for name, server in (("fused", fused_server), ("plain", plain_server)):
        (got,) = server.synthesize([golden_mel], noises=[golden_z])
        errs[name] = np.abs(got.wave - golden)
        if not within(errs[name], golden_tol):
            raise AssertionError(
                f"{tag} {name}: golden request off the JAX wave by "
                f"{errs[name].max():.3e} (mean {errs[name].mean():.3e}), "
                f"limits {golden_tol}")
    rms = float(np.sqrt(np.mean(np.concatenate(
        [r.wave for r in results]) ** 2)))
    print(f"vocoder {tag}: fused (max_batch 1) vs plain (max_batch 8) waves, "
          f"max abs diff per request {[f'{d.max():.1e}' for d in diffs]}, "
          f"mean {[f'{d.mean():.1e}' for d in diffs]} (limits {fused_tol}, "
          f"wave rms {rms:.3f}); golden request vs JAX: fused max "
          f"{errs['fused'].max():.3e} mean {errs['fused'].mean():.3e}, plain "
          f"max {errs['plain'].max():.3e} mean {errs['plain'].mean():.3e} "
          f"(limits {golden_tol})")

    single_server = BucketedParallelSynthesisServer(
        kind, params, cfg, max_batch=1, **common)
    for name, server in (("fused chains, max_batch 1", fused_server),
                         ("plain, max_batch 1", single_server),
                         ("plain, max_batch 8", plain_server)):
        sec = _median_seconds(lambda: server.synthesize(mels, seed=SEED))
        print(f"vocoder {tag} [{name}]: {len(mels)} requests in "
              f"{sec * 1e3:.2f} ms (median of 3): "
              f"{n_samples / sec:.0f} samples/s delivered, "
              f"{sec / len(mels) * 1e3:.3f} ms a request [{gpu}]")
    for bucket in (20, 40, 80):
        mel = next(m for m in mels if m.shape[0] == bucket)
        sec = _median_seconds(lambda: fused_server.synthesize([mel]))
        print(f"vocoder {tag} [fused chains] bucket {bucket} "
              f"({bucket * VOCODER_HOP} samples): {sec * 1e3:.3f} ms a "
              f"request, {bucket * VOCODER_HOP / sec:.0f} samples/s, "
              f"real-time factor "
              f"{sec / (bucket * VOCODER_HOP / VOCODER_RATE):.4f} at "
              f"{VOCODER_RATE} Hz [{gpu}]")
    mel = next(m for m in mels if m.shape[0] == 80)
    window, busy_us = _device_profile(lambda: fused_server.synthesize([mel]))
    total_us = sum(busy_us.values())
    chain_us = sum(v for k, v in busy_us.items() if any(
        n in k for n in ("gemm_kernel", "glu_kernel")))
    print(f"vocoder {tag} profile (one fused bucket-80 request, "
          f"torch.profiler CUDA activity): window {window * 1e3:.2f} ms, "
          f"device busy {total_us / 1e3:.2f} ms, idle share "
          f"{1 - total_us / 1e6 / window:.3f}; chain kernels "
          f"{chain_us / total_us:.3f} of device time [{gpu}]")
    for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:10.3f} ms  {name[:100]}")
    return counts[key]


PHASES = ("kernel", "slice", "pth_import", "train", "experiment", "evaluate",
          "wavenet_train", "step_kernel", "synthesis", "continuous",
          "chain_kernel", "vocoder")
# what a run may not import: the card's machine has none of them, and the
# port needs none
FORBIDDEN_IMPORTS = ("jax", "vqvae_speech_tpu", "sklearn", "matplotlib")


def _check_imports():
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in FORBIDDEN_IMPORTS)
    if imported:
        raise AssertionError(f"the run imported {imported}")


def _print_retaken():
    from vqvae_speech_tpu_torch.utils.profiling import RETAKEN
    print(f"profiler windows retaken (lead sentinels seen, launched, tail "
          f"sentinels seen, launched, other device events, whether they "
          f"added up): {len(RETAKEN)} {RETAKEN}")


def main():
    import argparse
    import tempfile

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

    # the experiment phase trains jitter12 here, the evaluate phase scores it
    work = tempfile.mkdtemp(prefix="chip_smoke_experiment_")
    try:
        if set(only) != set(PHASES):
            if "evaluate" in only and "experiment" not in only:
                phase(_train_one_epoch, work)
            for name, fn, args in (
                    ("kernel", kernel_phase, ()),
                    ("slice", slice_phase, (gpu,)),
                    ("pth_import", pth_import_phase, (gpu,)),
                    ("train", train_phase, (gpu,)),
                    ("experiment", experiment_phase, (gpu, work)),
                    ("evaluate", evaluate_phase, (gpu, work)),
                    ("wavenet_train", wavenet_train_phase, (gpu,)),
                    ("step_kernel", step_kernel_phase, (gpu,)),
                    ("synthesis", synthesis_phase, (gpu,)),
                    ("continuous", continuous_phase, (gpu,)),
                    ("chain_kernel", chain_kernel_phase, (gpu,)),
                    ("vocoder", vocoder_phase, (gpu,))):
                if name in only:
                    phase(fn, *args)
            _check_imports()
            _print_retaken()
            print(f"chip_smoke: partial run of {only}; no result line")
            return

        vq_err, (vq_ms, vq_plain_ms) = phase(kernel_phase)
        encode_vq_launches = phase(slice_phase, gpu)
        pth_vq_launches = phase(pth_import_phase, gpu)
        train_vq_launches, vq_device_ms, train_ms = phase(train_phase, gpu)
        experiment_vq_launches, loop_ms, bare_ms = phase(experiment_phase, gpu,
                                                         work)
        print(f"experiment vs train: the loop {loop_ms:.3f} ms a step at "
              f"batch 2 (no checkpoint), the bare step {bare_ms:.3f} ms at "
              f"batch 2 and {train_ms:.3f} ms at batch 64 (train phase, "
              f"gradient VQ) [{gpu}]")
        evaluate_vq_launches = phase(evaluate_phase, gpu, work)
    finally:
        shutil.rmtree(work)
    wavenet_vq_launches, _ = phase(wavenet_train_phase, gpu)
    step_err, (step_ms, step_plain_ms) = phase(step_kernel_phase, gpu)
    step_launches, synth_vq_launches = phase(synthesis_phase, gpu)
    cont_step_launches, cont_vq_launches = phase(continuous_phase, gpu)
    chains = phase(chain_kernel_phase, gpu)
    chain_launches = phase(vocoder_phase, gpu)
    _check_imports()
    _print_retaken()

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
             encode_vq_launches + pth_vq_launches + train_vq_launches
             + experiment_vq_launches + evaluate_vq_launches
             + wavenet_vq_launches + synth_vq_launches + cont_vq_launches,
             dict(max_abs_err=vq_err, ms=vq_ms, plain_ms=vq_plain_ms,
                  bound_ms=vq_bound[0], bound_by=vq_bound[1]),
             # ms is by CUDA events, which at this size time the host's
             # launch; device_ms is the kernel's own time in the train steps
             device_ms=vq_device_ms),
        line("wavenet_step", "wavenet_step.cu",
             "vqvae_speech_tpu/ops/wavenet_step.py:35",
             step_launches + cont_step_launches,
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
        # the bf16 forms of the same three TPU kernels (the JAX package runs
        # them at bf16 in its serving configuration); spread: the plain bf16
        # chain's own distance between two summation orders
        line("fused_block_chain_tiled_bf16", "fused_resblock.cu",
             "vqvae_speech_tpu/ops/fused_resblock.py:95",
             chain_launches["tiled_bf16"], chains["tiled_bf16"]),
        line("fused_block_chain_nc_bf16", "fused_resblock.cu",
             "vqvae_speech_tpu/ops/fused_resblock.py:215",
             chain_launches["nc_bf16"], chains["nc_bf16"]),
        line("fused_block_chain_bf16", "fused_resblock.cu",
             "vqvae_speech_tpu/ops/fused_resblock.py:65",
             chain_launches["chain_bf16"], chains["chain_bf16"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
