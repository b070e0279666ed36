#!/usr/bin/env python3
"""The program's spans against the device trace's clock, and what a span
costs.

    python3 scripts/span_clock_cuda.py

On one NVIDIA GPU, inside ``utils/profiling.trace(None)`` (CUDA activity
alone):

- 2000 spans, each around one launch of a small elementwise kernel: how far
  the launch call's stamp lies from its span's start and end (both should be
  positive: the span's stamps are ``time.time_ns()``, the launch call's the
  profiler's, converted to the same clock), and how far the kernel's own
  start lies from its launch stamp;
- a convolution's forward and backward (cuDNN through the driver API,
  autograd's device thread for the backward) inside spans ``fwd`` and
  ``bwd``: how many of their kernels have a launch record and where the
  records' launches fall.

Then, on the host, the cost of one ``with annotate(name, id):`` around an
empty body with spans off (over 2,000,000 calls, less an empty loop's time)
and on (over 200,000). Prints one line a reading and a last JSON line.
Imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vqvae_speech_tpu_torch.utils.profiling import (  # noqa: E402
    annotate,
    record_spans,
    trace,
)


def _quartiles(values):
    q = statistics.quantiles(values, n=4)
    return {"min": min(values), "q1": q[0], "median": q[1], "q3": q[2],
            "max": max(values)}


def clock(n=2000):
    x = torch.zeros(4096, device="cuda")
    torch.cuda.synchronize()
    with trace(None) as t:
        for i in range(n):
            with annotate("launch", i):
                x.add_(1.0)
    records = [r for r in t.records if "add" in r.name.lower()
               or "elementwise" in r.name.lower()]
    launched = sorted(r.launch_ns for r in records if r.launch_ns is not None)
    spans = sorted(t.spans, key=lambda s: s.start_ns)
    inside = sum(s.start_ns <= ln <= s.end_ns
                 for s, ln in zip(spans, launched))
    out = {"spans": len(spans), "records": len(records),
           "with_launch": len(launched), "launch_inside_its_span": inside,
           "launch_after_span_start_us": _quartiles(
               [1e-3 * (ln - s.start_ns) for s, ln in zip(spans, launched)]),
           "span_end_after_launch_us": _quartiles(
               [1e-3 * (s.end_ns - ln) for s, ln in zip(spans, launched)]),
           "kernel_start_after_launch_us": _quartiles(
               [1e-3 * (r.start_ns - r.launch_ns) for r in records
                if r.launch_ns is not None])}
    return out


def backward():
    conv = torch.nn.Conv1d(256, 256, 3, padding=1).cuda()
    x = torch.randn(64, 256, 512, device="cuda", requires_grad=True)
    for _ in range(3):                  # cuDNN's plans made
        conv(x).square().mean().backward()
    torch.cuda.synchronize()
    with trace(None) as t:
        with annotate("fwd"):
            loss = conv(x).square().mean()
        with annotate("bwd"):
            grads = torch.autograd.grad(loss, [x, conv.weight, conv.bias])
        del grads
    spans = {s.name: s for s in t.spans}
    where = {"fwd": 0, "bwd": 0, "outside": 0, "no_launch_record": 0}
    for r in t.records:
        if r.launch_ns is None:
            where["no_launch_record"] += 1
            continue
        for name in ("fwd", "bwd"):
            s = spans[name]
            if s.start_ns <= r.launch_ns <= s.end_ns:
                where[name] += 1
                break
        else:
            where["outside"] += 1
    return {"records": len(t.records), "launches_in": where,
            "names": sorted({r.name[:60] for r in t.records})}


def cost(off_calls=2_000_000, on_calls=200_000):
    t0 = time.perf_counter()
    for i in range(off_calls):
        pass
    empty = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(off_calls):
        with annotate("ar.step", i):
            pass
    off = time.perf_counter() - t0
    with record_spans() as spans:
        t0 = time.perf_counter()
        for i in range(on_calls):
            with annotate("ar.step", i):
                pass
        on = time.perf_counter() - t0
    assert len(spans) == on_calls
    return {"off_ns_a_call": 1e9 * (off - empty) / off_calls,
            "on_ns_a_call": 1e9 * (on - empty / off_calls * on_calls)
            / on_calls}


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card", card.strip(), "torch", torch.__version__, torch.version.cuda)
    got = {"card": card.strip(), "clock": clock(), "backward": backward(),
           "cost": cost()}
    for key in ("clock", "backward", "cost"):
        print(key, got[key])
    print(json.dumps(got))


if __name__ == "__main__":
    main()
