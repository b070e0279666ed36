"""Tiny sizes of every cell, for the CPU tests (the widths and depths cut,
the traffic shrunk; the paths the same): ``h100bench/tiny/<workload>.json``,
``{"config": {...}, "traffic": {...}}``, found by the cell's name."""
import os

from h100bench import harness

TINY = os.path.join(harness.HERE, "tiny")


def _path(workload):
    return os.path.join(TINY, f"{workload}.json")


OVERRIDES = {w["name"]: harness.load_json(_path(w["name"]))
             for w in harness.benchmark()["workloads"]
             if os.path.isfile(_path(w["name"]))}
SEED = 2 ** 31 + 11


def run(workload, seconds=1.5, seed=SEED):
    """One run of ``workload`` at tiny size on the CPU: (line, checks). The
    window is long enough for the AR cell's slowest first request (1152
    samples in chunks of 64) at ~5000 samples/s."""
    import torch

    torch.manual_seed(0)
    return harness.run_cell(workload, seed, seconds, 0, device="cpu",
                            overrides=OVERRIDES[workload],
                            log=lambda s: None)
