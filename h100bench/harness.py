"""The benchmark's engine: finds a cell's configuration, traffic, limits,
reference, driver and per-layer readers by name, runs one cell once and
builds the result line.

Everything that belongs to one thing is a file of its own under this
folder, found by the name ``BENCHMARK.json`` gives it, so that a new
configuration and its cells come as new files and appended entries of
``BENCHMARK.json``, with no edit to a file that is here:

* ``configs/<config>.json``: the configuration as it is run, with the
  ``source`` and ``reduced`` of its entry;
* ``reference/<config>.py``: its plain PyTorch reference (importing
  nothing of the program), with ``KEYS``, a tuple of the configuration
  keys it and the cells on it read, which the configuration must hold;
* ``traffic/<mix>.json``: a traffic mix's parameters; its ``kind`` names
  the driver, ``drivers/<kind>.py``;
* ``limits/<workload>.json``: each compared number's limit, with the
  readings it was set from;
* ``tiny/<workload>.json``: ``{"config": {...}, "traffic": {...}}``, the
  keys that shrink the cell for the CPU tests (``tests/tiny.py``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(cell,
  traced)`` -> a number, or None where the cell gives it nothing to read.

A driver's ``Cell(ctx)`` builds the program and says what the check
compares: ``setup()`` makes the weights and inputs from ``ctx.seed`` and
warms every shape the window uses; ``window(seconds)`` returns ``{"metrics":
{<the cell's end-to-end metrics but setup_s>}, "attempted", "failed"}``;
``trace()`` a ``trace.Traced`` of a few more calls under the profiler (None
without a card), ``trace_gaps()`` the host's idle gaps of a shorter one;
``release()`` frees the program's state; ``check(control=False)`` returns
``{name: number}`` for the limits, and ``check(control=True)`` the same
with the plain reference in the program's place, computed in the precision
below the configuration's own (TF32 for an f32 configuration, below bf16,
such as fp8 or int8, for a bf16 one). Optional, for the readers of the
program's spans (``program_spans.py``): ``SEGMENT_CALLS``, the number of
calls a segment makes, and ``drive_segment(n)``, which makes n of them.
"""
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may load: the JAX package, JAX and its
# libraries, and PyYAML, which the card's machine does not have
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
             "vqvae_speech_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(path, name):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(config_name):
    return load_module(os.path.join(HERE, "reference", f"{config_name}.py"),
                       f"h100bench_reference_{config_name}")


def driver(kind):
    return load_module(os.path.join(HERE, "drivers", f"{kind}.py"),
                       f"h100bench_driver_{kind}")


def reader(metric):
    return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                       f"h100bench_metric_{metric}")


def forbidden_modules():
    """The forbidden top-level names present in ``sys.modules``, compared
    whole (the part before the first dot)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Context:
    """One cell's inputs: its entry, configuration, traffic, limits,
    reference, the seed and the device; ``overrides`` ({"config": {...},
    "traffic": {...}}) shrink a cell for the CPU tests."""

    def __init__(self, workload, seed, device, overrides=None):
        self.bench = benchmark()
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the benchmark "
                             f"has {sorted(cells)}")
        self.workload = cells[workload]
        entry = {c["name"]: c for c in self.bench["configs"]}[
            self.workload["config"]]
        self.cfg = load_json(os.path.join(ROOT, entry["file"]))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", f"{self.workload['traffic']}.json"))
        overrides = overrides or {}
        self.cfg.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.limits = load_json(os.path.join(HERE, "limits",
                                             f"{workload}.json"))
        self.ref = reference(self.workload["config"])
        self.seed = int(seed)
        self.device = device
        self.notes = {}

    def note(self, name, value):
        """A reading printed beside the compared numbers, not compared."""
        self.notes[name] = value

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.workload["name"] in m.get("workloads",
                                                  [self.workload["name"]])]

    def per_layer(self):
        return [m for m in self.bench["per_layer"]
                if self.workload["name"] in m.get("workloads", [])]


def compare(numbers, limits):
    """[(name, value, limit, within)] for every limited number; a number
    the run did not give, or one that is not finite, is not within."""
    out = []
    for name, spec in limits["limits"].items():
        value = numbers.get(name)
        ok = (value is not None and math.isfinite(value)
              and value <= spec["limit"])
        out.append((name, value, spec["limit"], ok))
    return out


def device_info(cuda):
    import torch
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run_cell(workload, seed, seconds, trace, *, device="cuda", t_start=None,
             overrides=None, log=print):
    """Run one cell once: set-up, the timed window, with ``trace`` the
    traced segment and the per-layer readers, then the check. Returns the
    result line (a dict) and the checks [(name, value, limit, within)]."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Context(workload, seed, device, overrides)
    cell = driver(ctx.traffic["kind"]).Cell(ctx)
    ctx.note("setup_before_cell_s", time.perf_counter() - t_start)
    cell.setup()
    setup_s = time.perf_counter() - t_start
    win = cell.window(float(seconds))
    metrics, breakdown, traced = {}, None, None
    if trace:
        traced = cell.trace()
        gaps = cell.trace_gaps() if traced is not None else None
        for m in ctx.per_layer():
            value = reader(m["name"]).read(cell, traced)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if traced is not None:
            breakdown = traced.breakdown(gaps)
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in ctx.end_to_end():
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    # the peak is read before the program's state is freed and the
    # reference runs
    info = device_info(device != "cpu")
    if traced is not None:
        info.update(busy_s=traced.busy_s, window_s=traced.window_s)
    cell.release()
    if device != "cpu":
        torch.cuda.empty_cache()
    numbers = cell.check(control=False)
    checks = compare(numbers, ctx.limits)
    for name, value in numbers.items():
        if name not in ctx.limits["limits"]:
            ctx.note(name, value)
    for name, value in sorted(ctx.notes.items()):
        log(f"reading {name} {value} (not compared)")
    line = {"correct": all(c[3] for c in checks),
            "attempted": int(win["attempted"]), "failed": int(win["failed"]),
            "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in checks}
    return line, checks
