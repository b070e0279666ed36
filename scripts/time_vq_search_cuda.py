#!/usr/bin/env python3
"""Time the fused VQ codebook search (csrc/vq_search.cu) on one NVIDIA GPU.

    python3 scripts/time_vq_search_cuda.py

Builds the kernel, prints nvcc's -Xptxas -v report, holds the kernel against
the plain search at each shape, and prints for each shape the kernel's device
time a launch from torch.profiler (the sum of its device kernels over 200
launches), its CUDA-event time over 200 back-to-back launches, the plain
search's the same two ways, and the bytes bound. Then builds a probe
library with -DVQ_STAMPS (build/libvq_search_probe.so, never the one the port
loads) and prints, for the one-launch shapes, where a launch's time goes by
the kernel's own stamps of the global timer: for each phase the latest
block's time since the earliest block's entry. Imports nothing of JAX.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vqvae_speech_tpu_torch.ops import _kernels, vq_search_torch  # noqa: E402

SHAPES = ((1536, 44), (3072, 44), (6144, 44), (24576, 44), (1536, 100),
          (1536, 400), (1536, 500), (1536, 1000), (24576, 1000), (24, 29))
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def _event_ms(fn, n=200):
    for _ in range(5):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _device_ms(fn, n=200):
    from vqvae_speech_tpu_torch.utils.profiling import device_events

    _, rows = device_events(lambda: [fn() for _ in range(n)])
    return sum(r.us for r in rows) / n / 1e3, rows


PHASES = ("codebook staged", "first tile in shared memory",
          "its squared norms", "its distances", "its indices",
          "its quantized rows copied", "its statistics", "every tile done",
          "partial written", "past the grid barrier", "sums written")
STAMP_SLOTS = 16


def stamp_profile(shapes, rng):
    """Microseconds since the earliest block's entry at which the LATEST
    block passed each phase boundary, median over 20 launches, from a probe
    build of the kernel."""
    out = os.path.join(_kernels.BUILD_DIR, "libvq_search_probe.so")
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-DVQ_STAMPS",
                    "-o", out, os.path.join(_kernels.CSRC_DIR, "vq_search.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    _kernels._bind_vq_search(lib)
    lib.vq_search_set_stamps.argtypes = [ctypes.c_void_p]
    lib.vq_search_set_stamps.restype = ctypes.c_int
    for N, K in shapes:
        plan = _kernels.vq_search_plan(N, K, 64, torch.device("cuda", 0))
        if not plan["fused"]:
            continue
        flat = torch.from_numpy(rng.standard_normal((N, 64), np.float32)).cuda()
        cb = torch.from_numpy(rng.standard_normal((K, 64), np.float32)).cuda()
        idx = torch.empty(N, dtype=torch.int32, device="cuda")
        q, dw = torch.empty_like(flat), torch.empty_like(cb)
        counts = torch.empty(K, device="cuda")
        scratch = torch.empty(plan["scratch_floats"], device="cuda")
        stamps = torch.zeros((plan["blocks"], STAMP_SLOTS), dtype=torch.int64,
                             device="cuda")
        if lib.vq_search_set_stamps(stamps.data_ptr()):
            raise RuntimeError("vq_search_set_stamps failed")
        rows = []
        for _ in range(25):
            err = lib.vq_search_f32(
                flat.data_ptr(), cb.data_ptr(), N, K, 64, idx.data_ptr(),
                q.data_ptr(), counts.data_ptr(), dw.data_ptr(),
                scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe launch failed with CUDA error {err}")
            torch.cuda.synchronize()
            t = stamps.cpu().numpy().astype(np.float64)
            last = 12 if plan["blocks"] > 1 else 9   # one block: no barrier
            rows.append((t[:, 1:last].max(0) - t[:, 0].min()) / 1e3)
        lib.vq_search_set_stamps(None)
        med = np.median(np.array(rows[5:]), axis=0)
        print(f"N={N} K={K} stamps, {plan['blocks']} blocks (us since the "
              "first block's entry, latest block, median of 20): "
              + ", ".join(f"{name} {v:.2f}" for name, v in zip(PHASES, med)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(gpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    for line in _kernels.build("vq_search", force=True).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    rng = np.random.default_rng(0)
    # bring the card's clocks up before the first shape is timed
    warm = torch.randn(4096, 4096, device="cuda")
    for _ in range(200):
        warm @ warm
    torch.cuda.synchronize()
    for N, K in SHAPES:
        flat = torch.from_numpy(rng.standard_normal((N, 64), np.float32)).cuda()
        cb = torch.from_numpy(rng.standard_normal((K, 64), np.float32)).cuda()
        got = _kernels.vq_search_cuda(flat, cb)
        want = vq_search_torch(flat, cb)
        torch.cuda.synchronize()
        n_diff = int((got[0] != want.indices).sum())
        dw_err = (got[3] - want.dw).abs().max().item()
        plan = _kernels.vq_search_plan(N, K, 64, flat.device)
        dev_ms, rows = _device_ms(lambda: _kernels.vq_search_cuda(flat, cb))
        ev_ms = _event_ms(lambda: _kernels.vq_search_cuda(flat, cb))
        plain_dev_ms, _ = _device_ms(lambda: vq_search_torch(flat, cb))
        plain_ev_ms = _event_ms(lambda: vq_search_torch(flat, cb))
        bound = max((2 * N * K * 64 + N * 64) / PEAK_F32_FLOPS,
                    4 * (2 * N * 64 + 2 * K * 64 + N + K) / PEAK_BYTES_PER_S)
        print(f"N={N} K={K} D=64 fused={plan['fused']} blocks={plan['blocks']}"
              f": differing rows {n_diff}, dw err "
              f"{dw_err:.2e}; kernel device {dev_ms:.5f} ms, events "
              f"{ev_ms:.5f} ms; plain device {plain_dev_ms:.5f} ms, events "
              f"{plain_ev_ms:.5f} ms; bound {bound * 1e3:.5f} ms [{gpu}]")
        for key, us, count in rows:
            print(f"    {key.split('(')[0][-60:]}: {us / count:.2f} us x {count}")
    stamp_profile(SHAPES, rng)


if __name__ == "__main__":
    main()
