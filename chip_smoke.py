#!/usr/bin/env python3
"""Drive the PyTorch port (vqvae_speech_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the fused VQ codebook-search kernel (csrc/vq_search.cu) from source.
2. Kernel phase: holds the kernel against its plain PyTorch version on the
   same CUDA tensors at the serving and benchmark shapes, and times both.
3. Slice phase: serves mixed-length VCTK requests through all three buckets
   of BucketedEncodeServer at the flagship vq44-mfcc39 width, with random
   weights from numpy_params(seed=0); checks that the kernel ran, that the
   codes equal the plain search on the server's own latents and the JAX
   package's codes in tests/data/torch_port_flagship_codes.npz, and that the
   eval forward gives finite reconstructions; reports requests/s and
   frames/s.

Exits non-zero on any failure, and without a CUDA device. The last two lines
of output are a JSON object of per-kernel results and the JSON status line.
Imports nothing of JAX.
"""
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
# configurations/experiments_mfcc39-codebook_sizes.json
KERNEL_SHAPES = ((1, 44), (1000, 44), (1536, 44), (3072, 44), (6144, 44),
                 (24576, 44), (1536, 1000))
TIMED_SHAPE = (1536, 44)
# a differing index is a near-tie when its distance is within this of the
# winner's: 1e-5 * (||z||^2 + 1) between the kernel and the plain search on
# the same tensors (f32 summation order); 1e-4 * (||z||^2 + 1) against the
# JAX codes, whose latents came from XLA's CPU convolutions
NEAR_TIE_SAME_INPUT = 1e-5
NEAR_TIE_GOLDEN = 1e-4


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

    t0 = time.perf_counter()
    report = _kernels.build("vq_search", force=True)
    print(f"built csrc/vq_search.cu in {time.perf_counter() - t0:.2f} s")
    print(report.strip())

    max_err, (ms, plain_ms) = kernel_phase()
    launches = slice_phase(gpu)
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "vqvae_speech_tpu"))
    if jax_side:
        raise AssertionError(f"the run imported JAX-side modules {jax_side}")

    print(json.dumps({"kernels": [{
        "name": "vq_search",
        "route": "cuda",
        "source": "vqvae_speech_tpu_torch/csrc/vq_search.cu",
        "replaces": "vqvae_speech_tpu/ops/vq.py:91",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
