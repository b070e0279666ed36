"""The readings a cell's limits are set from, on the card, in one process.

    python3 h100bench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--controls control,half_batch] [--out <file>]

For each seed: the cell's set-up and a window of ``--seconds`` (long
enough to finish the traffic's longest requests and to compare as many as
a run does), then the check's numbers for the program and, with
``--controls``: ``control``, the plain reference put in the program's
place and computed in the precision below the configuration's own (TF32
for an f32 configuration; the driver's ``check(control=True)``);
``half_batch`` and ``unchanged`` (training), the reference on half of each
batch, or with every update left out. One JSON line a seed.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(workload, seed, seconds, control, device="cuda", overrides=None):
    import torch

    from h100bench import harness

    ctx = harness.Context(workload, seed, device, overrides)
    cell = harness.driver(ctx.traffic["kind"]).Cell(ctx)
    t0 = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - t0
    win = cell.window(seconds)
    cell.release()
    if device != "cpu":
        torch.cuda.empty_cache()
    out = {"workload": workload, "seed": seed, "setup_s": setup_s,
           "metrics": win["metrics"], "program": cell.check(control=False)}
    for name in control:
        out[name] = cell.check(control=True if name == "control" else name)
    out["notes"] = dict(ctx.notes)
    out["vectors"] = getattr(cell, "vectors", None)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default="control",
                    help="comma-separated: control (the reference a "
                         "precision below the configuration's), "
                         "half_batch, unchanged (training faults)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default=None,
                    help='JSON {"config": {...}, "traffic": {...}}')
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        over = json.loads(args.override) if args.override else None
        controls = [c for c in args.controls.split(",") if c]
        line = json.dumps(readings(args.workload, seed, args.seconds,
                                   controls, overrides=over), default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
