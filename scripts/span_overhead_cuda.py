#!/usr/bin/env python3
"""What the program's spans cost end to end in one of the benchmark's cells:
the cell's own window (``h100bench``), with spans off, on, on and off, in one
process after one set-up.

    python3 scripts/span_overhead_cuda.py --workload <cell> [--seed n] \
        [--seconds 51]

On one NVIDIA GPU. Spans are turned on with ``utils/profiling.record_spans``
around the window, as the benchmark's segment (a) turns them on; the window
and its metrics are the harness's. Prints the card, then one JSON line a
window: whether spans were on, how many were recorded, the end-to-end
metrics. Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3000001911)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()

    from h100bench import harness
    from vqvae_speech_tpu_torch.utils.profiling import record_spans

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card", card.strip(), flush=True)
    ctx = harness.Context(args.workload, args.seed, "cuda")
    cell = harness.driver(ctx.traffic["kind"]).Cell(ctx)
    cell.setup()
    for on in (False, True, True, False):
        spans = []
        if on:
            with record_spans() as spans:
                win = cell.window(args.seconds)
        else:
            win = cell.window(args.seconds)
        print(json.dumps({"workload": args.workload, "spans_on": on,
                          "spans": len(spans), "metrics": win["metrics"]}),
              flush=True)


if __name__ == "__main__":
    main()
