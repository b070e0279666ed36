"""A configuration and its cell enter the benchmark as new files and
appended ``BENCHMARK.json`` entries alone.

The benchmark's files are copied as a checkout holds them, with the
program's package beside them. A stub configuration is added to the copy:
its configuration file, a reference with ``KEYS``, a traffic mix of a new
driver kind, that driver (its program is one seeded
``torch.nn.functional.linear`` inside one ``utils.profiling.annotate``
span), the cell's limits and tiny sizes, and one ``program_span`` reader;
``BENCHMARK.json`` gains their entries, and one end-to-end metric's
``workloads`` the cell. Its configuration has none of the VQ-VAE's keys.
Rooted at the copy, the contract's tests and the imports tests of the stub
pass, a tiny run of the cell on the CPU is correct, and the cell's segment
of the program's spans is driven by its own hooks (the segment's look for
a card skipped). No file of the copy but ``BENCHMARK.json`` differs from
the benchmark's own.
"""
import filecmp
import json
import os
import shutil
import subprocess
import sys
import textwrap

from h100bench import harness

CONFIG, CELL = "stub-linear", "stub-cell"
MIX, KIND = "stub-calls", "stub_linear"
READER, METRIC = "stub_ms.stub", "encode_frames_per_s"
SOURCE = ("https://pytorch.org/docs/stable/generated/"
          "torch.nn.functional.linear.html")

FILES = {
    f"configs/{CONFIG}.json": json.dumps({
        "source": SOURCE, "reduced": [], "in_features": 64,
        "out_features": 32, "rows": 256}),
    f"reference/{CONFIG}.py": '''
        """Plain reference of the stub: rows times the transposed weight."""
        import torch

        KEYS = ("in_features", "out_features", "rows")


        def linear(x, w):
            return torch.matmul(x, w.t())
        ''',
    f"traffic/{MIX}.json": json.dumps({"kind": KIND}),
    f"drivers/{KIND}.py": '''
        """The stub's program: one seeded linear map in one span of the
        program, called back to back over the window."""
        import time

        import torch
        import torch.nn.functional as F


        class Cell:
            SEGMENT_CALLS = 3

            def __init__(self, ctx):
                self.ctx, self.cfg = ctx, ctx.cfg
                self.dev = torch.device(ctx.device)

            def setup(self):
                cfg = self.cfg
                gen = torch.Generator(device=self.dev).manual_seed(
                    self.ctx.seed)
                self.x = torch.randn((cfg["rows"], cfg["in_features"]),
                                     generator=gen, device=self.dev)
                self.w = torch.randn((cfg["out_features"], cfg["in_features"]),
                                     generator=gen, device=self.dev)
                self.y = self._call()

            def _call(self):
                from vqvae_speech_tpu_torch.utils import profiling
                with profiling.annotate("stub.linear"):
                    return F.linear(self.x, self.w)

            def drive_segment(self, n):
                for _ in range(n):
                    self.y = self._call()

            def window(self, seconds):
                t0, calls = time.perf_counter(), 0
                while time.perf_counter() - t0 < seconds:
                    self.y = self._call()
                    calls += 1
                wall = time.perf_counter() - t0
                return {"metrics": {"encode_frames_per_s":
                                    calls * self.cfg["rows"] / wall},
                        "attempted": calls, "failed": 0}

            def trace(self):
                return None

            def trace_gaps(self):
                return None

            def release(self):
                pass

            def check(self, control=False):
                ref = self.ctx.ref
                want = ref.linear(self.x, self.w)
                got = (ref.linear(self.x.bfloat16(), self.w.bfloat16()).float()
                       if control else self.y)
                return {"max_err": float((got - want).abs().max()
                                         / want.abs().max())}
        ''',
    f"limits/{CELL}.json": json.dumps({"limits": {"max_err": {
        "limit": 1e-5, "lower": 0.0, "upper": 1e-3,
        "readings": "the stub's own; not measured"}}}),
    f"tiny/{CELL}.json": json.dumps({"config": {"rows": 8}, "traffic": {}}),
    f"metrics/{READER}.py": '''
        """Median host ms of the stub's span over its segment."""
        from h100bench import program_spans


        def read(cell, traced):
            seg = program_spans.segment(cell)
            return None if seg is None else seg.median_host_ms("stub.linear")
        ''',
}

# run in the copy: a tiny run, then the segment with its look for a card
# skipped
RUN = '''
import json, torch
from types import SimpleNamespace
torch.set_num_threads(2)
from h100bench import harness
from h100bench.tests import tiny
line, _ = tiny.run("stub-cell")
ctx = harness.Context("stub-cell", tiny.SEED, "cpu",
                      tiny.OVERRIDES["stub-cell"])
cell = harness.driver(ctx.traffic["kind"]).Cell(ctx)
cell.setup()
cell.dev = SimpleNamespace(type="cuda")
torch.cuda.synchronize = lambda *args: None
ms = harness.reader("stub_ms.stub").read(cell, None)
print(json.dumps({"correct": line["correct"], "metrics": line["metrics"],
                  "calls": cell.program_spans.calls, "ms": ms,
                  "host": len(cell.program_spans.host_ms["stub.linear"])}))
'''


def _add_stub(bench):
    bench["configs"].append({
        "name": CONFIG, "source": SOURCE,
        "file": f"h100bench/configs/{CONFIG}.json",
        "reduced": [], "why": "a stub: one seeded linear map in one span"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
        "why": "a stub cell of a new configuration and driver kind"})
    for m in bench["end_to_end"]:
        if m["name"] == METRIC:
            m["workloads"].append(CELL)
    bench["per_layer"].append({
        "name": READER, "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "Stub", "moves": METRIC,
        "workloads": [CELL]})


def _differing(ours, theirs):
    """Files of ``ours`` that ``theirs`` lacks or holds otherwise."""
    out = []
    for base, dirs, files in os.walk(ours):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ours)
            other = os.path.join(theirs, rel)
            if not (os.path.isfile(other)
                    and filecmp.cmp(os.path.join(base, f), other,
                                    shallow=False)):
                out.append(rel)
    return out


def test_a_new_configuration_enters_as_new_files(tmp_path):
    root = tmp_path / "checkout"
    here = root / "h100bench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(harness.ROOT, "vqvae_speech_tpu_torch"),
               root / "vqvae_speech_tpu_torch")
    for rel, text in FILES.items():
        (here / rel).write_text(textwrap.dedent(text).lstrip())
    bench = harness.benchmark()
    _add_stub(bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2",
               PYTHONDONTWRITEBYTECODE="1")

    def run(*args):
        out = subprocess.run([sys.executable, *args], cwd=root, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
        return out.stdout

    run("-m", "pytest", "-q", "-p", "no:cacheprovider",
        "h100bench/tests/test_h100bench_contract.py",
        "h100bench/tests/test_h100bench_imports.py", "-k",
        f"contract or {CELL} or {CONFIG}")
    got = json.loads(run("-c", RUN).strip().splitlines()[-1])
    assert got["correct"] and set(got["metrics"]) == {METRIC, "setup_s"}
    assert got["calls"] == got["host"] == 3 and got["ms"] > 0

    assert sorted(_differing(str(here), harness.HERE)) == sorted(FILES)
    assert _differing(harness.HERE, str(here)) == []
    assert not filecmp.cmp(root / "BENCHMARK.json",
                           os.path.join(harness.ROOT, "BENCHMARK.json"),
                           shallow=False)
