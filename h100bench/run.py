"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. Set-up makes
the cell's weights and inputs from the seed and warms its shapes; the
window runs for ``--seconds``; with ``--trace 1`` a short profiled segment
follows and the line carries the cell's per-layer metrics instead of its
end-to-end ones. The check then compares what the window produced with the
plain reference. The last line of standard output is the JSON result; the
last lines of standard error each compared number beside its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    print(f"reading import_torch_s {time.perf_counter() - T_START} "
          "(not compared)", file=sys.stderr)

    chips = {w["name"]: w["chips"]
             for w in harness.benchmark()["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, args.trace, device="cuda",
        t_start=T_START, log=lambda s: print(s, file=sys.stderr))
    found = harness.forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, value, limit, _ in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
