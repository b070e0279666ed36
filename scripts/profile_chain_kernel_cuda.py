#!/usr/bin/env python3
"""Where the fused resblock-chain kernel (PyTorch port,
vqvae_speech_tpu_torch/csrc/fused_resblock.cu) spends its time on one
NVIDIA GPU, at the IAF student's width and T=20480.

    python3 scripts/profile_chain_kernel_cuda.py

Builds the source seven times into a library of its own
(build/libfused_resblock_probe.so, never the one the port loads), one
process a build, and prints for each:

  as shipped           the two bare products of a student layer through the
                       main loop alone (the gate's (T, 464) @ (464, 512) and
                       the projection's (T, 256) @ (256, 256)), a deep
                       product ((T, 4096) @ (4096, 512)) and one whole chain,
                       ms by CUDA events, and the device time a launch of
                       the gate and projection kernels (torch.profiler)
  -DCHAIN_NO_LOADS     the same with the ring's refills left out: the wgmma
                       side alone (results are wrong)
  -DCHAIN_NO_PRODUCTS  the same with the wgmma instructions left out: the
                       loads, fragment reads and splits alone
  -DCHAIN_PROMOTE=n    the tensor cores' accumulator added into the rounded
                       f32 total every n chunks (1, 4, never) in place of
                       the shipped 2: the chain's time and its max abs error
                       against the plain chain
  -DCHAIN_STAMPS       a block's timeline from the kernel's own global-timer
                       stamps, for the gate and the projection launch of the
                       chain's last layer: microseconds from entry to the
                       first loads issued, the first chunk landed, the main
                       loop done and the epilogue done

Every line ends with the card's name and power limit. Imports nothing of
JAX.
"""
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

VARIANTS = ((), ("-DCHAIN_NO_LOADS",), ("-DCHAIN_NO_PRODUCTS",),
            ("-DCHAIN_PROMOTE=1",), ("-DCHAIN_PROMOTE=4",),
            ("-DCHAIN_PROMOTE=1000000",), ("-DCHAIN_STAMPS",))
STUDENT = dict(L=6, k=3, T=20480, C=128, G=256, S=128, cin=80)
STAMP_BLOCKS, STAMP_FIELDS = 8192, 6


def load_variant(flags):
    """Compile csrc/fused_resblock.cu with ``flags`` into the probe library
    and make it the one this process's wrappers call."""
    from vqvae_speech_tpu_torch.ops import _kernels

    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    out = os.path.join(_kernels.BUILD_DIR, "libfused_resblock_probe.so")
    src = os.path.join(_kernels.CSRC_DIR, "fused_resblock.cu")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *flags, "-o", out,
                    src], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    _kernels._bind_fused_resblock(lib)
    _kernels._libs["fused_resblock"] = lib
    return lib


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


def run_variant(flags):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vqvae_speech_tpu_torch.ops import _kernels
    from vqvae_speech_tpu_torch.ops import fused_resblock as fused

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = load_variant(flags)
    tag = " ".join(flags) or "as shipped"
    rng = np.random.default_rng(0)

    def f(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    d = STUDENT
    T = d["T"]
    for N, K in ((512, 464), (256, 256), (512, 4096)):
        a, b = f((T, K)), f((N, K), K ** -0.5)
        hi, lo = (t.contiguous() for t in fused.split_tf32(b))
        ms = median_ms(lambda: _kernels.tf32x3_matmul_cuda(a, hi, lo))
        print(f"[{tag}] main loop ({T}, {K}) @ ({K}, {N}): {ms:.4f} ms, "
              f"{3 * 2 * T * N * K / ms / 1e9:.0f} TFLOP/s of TF32 work "
              f"[{gpu}]")

    L, k, C, G, S, cin = (d[n] for n in ("L", "k", "C", "G", "S", "cin"))
    fan = (k * C + cin) ** -0.5
    stacked = dict(
        wf=f((L, k, C, G), fan), wg=f((L, k, C, G), fan),
        wfc=f((L, cin, G), fan), wgc=f((L, cin, G), fan),
        wres=f((L, G, C), G ** -0.5), wskip=f((L, G, S), G ** -0.5),
        bf=f((L, G), 0.1), bg=f((L, G), 0.1), bres=f((L, C), 0.1),
        bskip=f((L, S), 0.1))
    x, c = f((T, C)), f((T, cin))
    chain = fused.prepare_block_chain(stacked)

    def run():
        return _kernels.fused_block_chain_tiled_cuda(x, c, chain)

    ms = median_ms(run)
    with torch.inference_mode():
        want = fused.fused_block_chain_tiled_torch(x, c, stacked, L, k)
        err = max((g - w).abs().max().item() for g, w in zip(run(), want))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / e.count
               for e in prof.key_averages() if "gemm_kernel" in e.key}
    print(f"[{tag}] student chain T={T}: {ms:.4f} ms (median of 20, CUDA "
          f"events), max abs err against the plain chain {err:.3e}; device "
          f"us a launch (torch.profiler; dependent launches "
          f"overlap, so spans include waiting): "
          + ", ".join(f"{'gate' if 'gemm_kernel<0' in key else 'projection'} {us:.1f}"
                      for key, us in sorted(kernels.items())) + f" [{gpu}]")

    if "-DCHAIN_STAMPS" not in flags:
        return
    lib.fused_chain_read_stamps.argtypes = [ctypes.c_void_p]
    lib.fused_chain_read_stamps.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (4 * STAMP_BLOCKS * STAMP_FIELDS))()
    err = lib.fused_chain_read_stamps(ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"reading the stamps failed with CUDA error {err}")
    stamps = np.array(buf[:], dtype=np.float64).reshape(
        4, STAMP_BLOCKS, STAMP_FIELDS)
    row_tiles = -(-T // 128)
    for kind, blocks, name in ((0, row_tiles * -(-G // 64), "gate"),
                               (2, row_tiles * -(-(C + S) // 128),
                                "projection")):
        t = (stamps[kind, :blocks, :5] - stamps[kind, :blocks, 0].min()) / 1e3
        steps = np.diff(t, axis=1).mean(0)
        per_sm = np.bincount(stamps[kind, :blocks, 5].astype(int))
        print(f"[{tag}] {name} launch of the last layer: {blocks} blocks, "
              f"{per_sm[per_sm > 0].min()}-{per_sm.max()} an SM, launch span "
              f"{t[:, 4].max():.1f} us; a block, mean us: entry to first "
              f"loads issued {steps[0]:.2f}, to first chunk landed "
              f"{steps[1]:.2f}, main loop {steps[2]:.2f}, epilogue "
              f"{steps[3]:.2f}, total {(t[:, 4] - t[:, 0]).mean():.2f} [{gpu}]")


def main():
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--variant":
        run_variant(tuple(sys.argv[2:]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("profile_chain_kernel_cuda: no CUDA device")
    for flags in VARIANTS:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--variant",
                        *flags], check=True)


if __name__ == "__main__":
    main()
