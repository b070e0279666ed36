#!/usr/bin/env python3
"""The fused resblock chain against the plain chain at batch 1, on one
NVIDIA GPU: the CUDA counterpart of scripts/bench_fused_resblock_tpu.py.

    python3 scripts/bench_fused_resblock_cuda.py [--t 4096] [--iters 50]
        [--layers 6] [--out chiprun_out/bench_fused_resblock.json]

Runs ONE causal gated-resblock chain at the IAF student's width (C=128,
G=256, S=128, cin=80, k=3, dilations 3**l) over T rows both ways, in f32
and in bf16: the hand-written whole-T chain kernel
(``ops.fused_block_chain`` -> ``csrc/fused_resblock.cu``, on weights bound
once with ``ops.prepare_block_chain``) and the plain PyTorch chain
(``ops.fused_block_chain_torch``; at bf16 ``fused_block_chain_bf16_torch``).
Weights are numpy-seeded weight-normed resblocks (``convert``'s init
distributions), x and c_up unit normals. Each way runs ``--iters`` chains
back to back, each chain's x the previous chain's output (the TPU script's
scan), between two CUDA events; the best of three such runs is kept.
Before timing, the kernel's first chain is held to the plain chain on the
same inputs (max abs error and cosine). Prints the card's name and power
limit, then one JSON line a dtype and a summary line; TF32 is off. Imports
nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vqvae_speech_tpu_torch import convert  # noqa: E402
from vqvae_speech_tpu_torch.ops import (  # noqa: E402
    fused_block_chain,
    fused_block_chain_torch,
    prepare_block_chain,
    stack_block_weights,
)
from vqvae_speech_tpu_torch.ops._kernels import (  # noqa: E402
    fused_block_chain_bf16_cuda,
    fused_block_chain_cuda,
)
from vqvae_speech_tpu_torch.ops.fused_resblock import (  # noqa: E402
    fused_block_chain_bf16_torch,
)

C, G, S, CIN, K = 128, 256, 128, 80, 3


def chain_inputs(L, T, seed=0):
    """(x (T, C), c_up (T, cin), stacked f32 weights) on the card."""
    rng = np.random.default_rng(seed)
    blocks = [{n: convert._resolved_conv(p[n], "cuda") for n in p}
              for p in (convert._resblock_tree(rng, C, G, S, K, CIN)
                        for _ in range(L))]
    x = torch.from_numpy(rng.standard_normal((T, C)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((T, CIN)).astype(np.float32))
    return x.cuda(), c.cuda(), blocks


def best_ms_per_chain(chain, x, iters):
    """Best of three runs of ``iters`` chained chains, ms a chain."""
    def run():
        h = x
        for _ in range(iters):
            h, _ = chain(h)
        return h

    run()
    best = float("inf")
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--t", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_resblock_cuda: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu)
    L, T = args.layers, args.t
    x, c, blocks = chain_inputs(L, T)
    # per row and layer: the filter and gate convs with their conditioning
    # projections, 2 (k C + cin) G multiply-adds, and the residual and skip
    # projections, G (C + S)
    flops = 2 * T * L * (2 * (K * C + CIN) * G + G * (C + S))
    results = {"config": dict(T=T, layers=L, C=C, G=G, S=S, cin=CIN, k=K,
                              batch=1, iters=args.iters), "card": gpu}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        stacked = stack_block_weights(blocks, dtype)
        prepared = prepare_block_chain(stacked)
        xd, cd = x.to(dtype), c.to(dtype)
        plain_fn = (fused_block_chain_torch if dtype == torch.float32 else
                    fused_block_chain_bf16_torch)
        wrapper = (fused_block_chain_cuda if dtype == torch.float32
                   else fused_block_chain_bf16_cuda)
        before = wrapper.launches
        got = fused_block_chain(xd, cd, prepared, layers=L, kernel_size=K)
        assert wrapper.launches == before + 1, "the kernel did not launch"
        want = plain_fn(xd, cd, stacked, L, K)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        cos = torch.nn.functional.cosine_similarity(
            got[0].float().ravel(), want[0].float().ravel(), dim=0).item()
        fused_ms = best_ms_per_chain(
            lambda h: fused_block_chain(h, cd, prepared, layers=L,
                                        kernel_size=K), xd, args.iters)
        plain_ms = best_ms_per_chain(
            lambda h: plain_fn(h, cd, stacked, L, K), xd, args.iters)
        results[name] = {
            "max_abs_err_vs_plain": err, "cosine_vs_plain": cos,
            "fused_ms_per_chain": fused_ms, "plain_ms_per_chain": plain_ms,
            "fused_tflops": flops / fused_ms / 1e9,
            "plain_tflops": flops / plain_ms / 1e9,
            "speedup_fused_over_plain": plain_ms / fused_ms}
        print(json.dumps({name: results[name]}), flush=True)
    print(json.dumps(results))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
