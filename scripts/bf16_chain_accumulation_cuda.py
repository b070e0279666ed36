#!/usr/bin/env python3
"""How far the bf16 fused resblock chains (PyTorch port,
vqvae_speech_tpu_torch/csrc/fused_resblock.cu, the bf16 form) sit from
their plain bf16 chain and from the same chain with its sums correctly
rounded, on one NVIDIA GPU, against how far those two sit from each other,
for three promotion intervals of the tensor cores' accumulator.

    python3 scripts/bf16_chain_accumulation_cuda.py

The bf16 chain rounds x to bf16 after every layer from f32 sums, so two
orders of the same sums disagree on a few elements by an ulp, and the flip
propagates. Two plain versions on the card (TF32 off):

  want      fused_block_chain_bf16_torch: cuBLAS f32 products of the bf16
            values (exact products, rounded f32 sums), in the JAX kernels'
            order
  exact     the same with float64 products and sums, rounded to f32 once
            where the f32 chain rounds: the sums correctly rounded
            (exact=True)

The tensor cores add into their f32 accumulator by truncation; the kernel
adds the accumulator into a rounded f32 total every CHAIN_PROMOTE chunks of
64 bf16 (shipped: 2). The source is built with -DCHAIN_PROMOTE=1, 2 and
1000000 (never before the end) into libraries of their own
(build/libfused_resblock_promote{n}.so, never the one the port loads), all
three nvcc runs at once, and for each, at the student's shapes and three
FloWaveNet block shapes, the script prints the kernel's max abs error and
share of differing x elements against ``want`` and against ``exact``,
the same for ``exact`` against ``want``, the signed mean of the kernel's x error (a
systematic offset shows there), and the chain's ms (median of 20, CUDA
events). Before the chains, for each variant, one bare product through the
main loop (``_kernels.bf16_matmul_cuda``, 80 rows of unit-normal bf16
against 512 columns of weights scaled by 1/sqrt(K)) at the reduction depths
the chains have (K = 464, the student's gate; 2560 and 10240, the wide flow
blocks' conditioning): max and mean abs error against the float64 product,
beside torch.matmul's of the same values in f32. Every line ends with the
card's name and power limit. Imports nothing of JAX.
"""
import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

PROMOTE = (1, 2, 1000000)
# (name, L, k, dilations or None, T, C, G, S, cin)
SHAPES = (
    ("student chain", 6, 3, None, 20480, 128, 256, 128, 80),
    ("student chain, odd T", 6, 3, None, 5119, 128, 256, 128, 80),
    ("flow block 0", 2, 3, (1, 2), 10240, 256, 256, 256, 80),
    ("flow block 3", 2, 3, (1, 2), 1280, 256, 256, 256, 640),
    ("flow block 6", 2, 3, (1, 2), 160, 256, 256, 256, 5120),
    ("flow block 7", 2, 3, (1, 2), 80, 256, 256, 256, 10240),
    ("flow block 7, ragged T", 2, 3, (1, 2), 81, 256, 256, 256, 10240),
)


def build(n):
    from vqvae_speech_tpu_torch.ops import _kernels

    out = os.path.join(_kernels.BUILD_DIR, f"libfused_resblock_promote{n}.so")
    src = os.path.join(_kernels.CSRC_DIR, "fused_resblock.cu")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                    f"-DCHAIN_PROMOTE={n}", "-o", out, src], check=True,
                   capture_output=True)
    return out


def median_ms(fn, iters=20, warmup=3):
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


def main():
    import torch
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.ops import fused_resblock as fused

    if not torch.cuda.is_available():
        raise SystemExit("bf16_chain_accumulation_cuda: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(PROMOTE)) as pool:
        libs = dict(zip(PROMOTE, pool.map(build, PROMOTE)))

    def diff(a, b):
        return max((u.float() - v.float()).abs().max().item()
                   for u, v in zip(a, b))

    def share(a, b):
        return (a[0] != b[0]).float().mean().item()

    rng = np.random.default_rng(0)
    for K in (464, 2560, 10240):
        a = torch.from_numpy(rng.standard_normal((80, K)).astype(np.float32)
                             ).cuda().bfloat16()
        b = torch.from_numpy((rng.standard_normal((512, K)) * K ** -0.5)
                             .astype(np.float32)).cuda().bfloat16()
        exact = a.double() @ b.double().t()

        def errs(t):
            e = (t.double() - exact).abs()
            return f"max {e.max().item():.3e} mean {e.mean().item():.3e}"

        line = [f"torch.matmul f32 {errs(a.float() @ b.float().t())}"]
        for n, path in libs.items():
            lib = ctypes.CDLL(path)
            _kernels._bind_fused_resblock(lib)
            _kernels._libs["fused_resblock"] = lib
            line.append(f"CHAIN_PROMOTE={n} {errs(_kernels.bf16_matmul_cuda(a, b))}")
        print(f"bare product (80, {K}) @ ({K}, 512) against float64: "
              + "; ".join(line) + f" [{gpu}]")
    for name, L, k, dil, T, C, G, S, cin in SHAPES:
        def f(shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32)).cuda()

        fan = (k * C + cin) ** -0.5
        stacked = dict(
            wf=f((L, k, C, G), fan), wg=f((L, k, C, G), fan),
            wfc=f((L, cin, G), fan), wgc=f((L, cin, G), fan),
            wres=f((L, G, C), G ** -0.5), wskip=f((L, G, S), G ** -0.5))
        stacked = {n: w.bfloat16() for n, w in stacked.items()}
        stacked.update(bf=f((L, G), 0.1), bg=f((L, G), 0.1),
                       bres=f((L, C), 0.1), bskip=f((L, S), 0.1))
        x, c = f((T, C)).bfloat16(), f((T, cin)).bfloat16()
        causal = dil is None
        with torch.inference_mode():
            want = fused.fused_block_chain_bf16_torch(x, c, stacked, L, k, dil,
                                                      causal=causal)
            ex = fused.fused_block_chain_bf16_torch(x, c, stacked, L, k, dil,
                                                    causal=causal,
                                                    exact=True)
        print(f"{name} (L={L} k={k} T={T} C={C} G={G} S={S} cin={cin}): "
              f"exact vs want {diff(ex, want):.3e}, {share(ex, want):.2e} of "
              f"x [{gpu}]")
        for n, path in libs.items():
            lib = ctypes.CDLL(path)
            _kernels._bind_fused_resblock(lib)
            _kernels._libs["fused_resblock"] = lib
            prepared = fused.prepare_block_chain(stacked)
            if causal:
                def run():
                    return fused.fused_block_chain_tiled(x, c, prepared, L, k)
            else:
                def run():
                    return fused.fused_block_chain_nc(x, c, prepared, L, k,
                                                      dil)
            got = run()
            torch.cuda.synchronize()
            bias = (got[0].float() - want[0].float()).mean().item()
            ms = median_ms(run)
            print(f"  CHAIN_PROMOTE={n}: kernel vs want {diff(got, want):.3e}, "
                  f"{share(got, want):.2e} of x, signed mean x error "
                  f"{bias:+.2e}; vs exact {diff(got, ex):.3e}, "
                  f"{share(got, ex):.2e} of x; {ms:.4f} ms [{gpu}]")
            del prepared


if __name__ == "__main__":
    main()
