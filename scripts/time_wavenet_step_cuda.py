#!/usr/bin/env python3
"""Time the decode-step kernel K2 (csrc/wavenet_step.cu) on one NVIDIA GPU.

    python3 scripts/time_wavenet_step_cuda.py [--batches 8,32,64] [--label x]

For the vctk_wavenet width (L=20, k=3, C=G=768, S=256) at each batch, and
the ClariNet teacher's (L=24, k=3, C=128, G=512, S=128) at batch 1: holds
the prepared step against the plain chain, requires two runs bit-equal, and
prints one JSON line a shape with the launches a step, the CUDA-event ms of
a step over 100 back-to-back steps, the kernel's device ms a step from
torch.profiler (its launches counted), the bound (chip_smoke.py's: the
larger of the operations over 67 TFLOP/s f32 and the bytes over 3.35 TB/s)
and where the first launch of a step spends its time, from the kernel's own
stamps (chip_smoke.py's split: per kind of phase, the phase's length and the
slowest block's staging, products and stores, the rest being the barrier
and the blocks' spread). Random weights scaled by 1/sqrt(fan-in), seeded.
Run from two checkouts in one call to compare two versions on one card.
Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from vqvae_speech_tpu_torch.ops import (  # noqa: E402
    _kernels,
    glu_stack_step_torch,
    prepare_glu_stack_step,
)

VCTK = dict(L=20, k=3, C=768, G=768, S=256)
TEACHER = dict(L=24, k=3, C=128, G=512, S=128)
NAMES = ("wtap", "bias", "wskip", "bskip", "wout", "bout")


def inputs(L, k, B, C, G, S, seed):
    rng = np.random.default_rng(seed)

    def f(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    return dict(
        x0=f((B, C)), taps=f((L, k - 1, B, C)), cond=f((L, B, G)),
        wtap=f((L, k, C, G), (k * C) ** -0.5), bias=f((L, G), 0.1),
        wskip=f((L, G // 2, S), (G // 2) ** -0.5), bskip=f((L, S), 0.1),
        wout=f((L, G // 2, C), (G // 2) ** -0.5), bout=f((L, C), 0.1))


def measure(shape, B, label, seed):
    L, k, C, G, S = (shape[n] for n in "LkCGS")
    args = inputs(L, k, B, C, G, S, seed)
    step = prepare_glu_stack_step(*(args[n] for n in NAMES), batch=B,
                                  legacy=True)
    x0, taps, cond = args["x0"], args["taps"], args["cond"]
    got = [t.clone() for t in step(x0, taps, cond)]
    again = step(x0, taps, cond)
    want = glu_stack_step_torch(legacy=True, **args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    launches = step.launches_per_step
    _, busy_us = chip_smoke._device_profile(
        lambda: [step(x0, taps, cond) for _ in range(50)], "step_kernel",
        lambda: 50 * launches)
    device_ms = sum(us for name, us in busy_us.items()
                    if "step_kernel" in name) / 50 / 1e3
    bound_ms, bound_by = chip_smoke.wavenet_step_bound(L, k, B, C, G, S)
    row = dict(
        label=label, shape=dict(shape, B=B), launches=launches,
        describe=step.describe(),
        max_abs_err=max((g - w).abs().max().item() for g, w in zip(got, want)),
        bit_equal=all(torch.equal(g, a) for g, a in zip(got, again)),
        event_ms=chip_smoke._per_launch_ms(lambda: step(x0, taps, cond)),
        device_ms=device_ms, bound_ms=bound_ms, bound_by=bound_by,
        roofline=bound_ms / device_ms,
        phases=chip_smoke._step_phase_profile(step, x0, taps, cond))
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,8,16,32,48,64")
    ap.add_argument("--teacher", type=int, default=1)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=2020)
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(label=opts.label, card=card.strip(),
                          torch=torch.__version__,
                          ptxas=_kernels.build("wavenet_step", force=True)
                          [-2000:])), flush=True)
    with torch.inference_mode():
        for B in (int(b) for b in opts.batches.split(",") if b):
            measure(VCTK, B, opts.label, opts.seed + B)
        if opts.teacher:
            measure(TEACHER, 1, opts.label, opts.seed)


if __name__ == "__main__":
    main()
