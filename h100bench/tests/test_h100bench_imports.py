"""What the benchmark loads: a run of each cell (at tiny sizes, on the
CPU) loads no module whose top-level name is one the card's runs may not
load, and the references load nothing of the program either."""
import ast
import json
import os
import subprocess
import sys

import pytest

from h100bench import harness

CELLS = sorted(w["name"] for w in harness.benchmark()["workloads"])
CONFIGS = sorted(c["name"] for c in harness.benchmark()["configs"])
PROGRAM = "vqvae_speech_tpu_torch"


def _python(code):
    env = dict(os.environ, PYTHONPATH=harness.ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_loads_nothing_forbidden(cell):
    got = _python(
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from h100bench.tests import tiny\n"
        "from h100bench import harness\n"
        f"line, _ = tiny.run({cell!r})\n"
        "print(json.dumps({'correct': line['correct'],\n"
        "                  'found': harness.forbidden_modules()}))\n")
    assert got == {"correct": True, "found": []}


@pytest.mark.parametrize("config", CONFIGS)
def test_the_reference_loads_nothing_of_the_program(config):
    got = _python(
        "import json, sys\n"
        "from h100bench import harness\n"
        f"harness.reference({config!r})\n"
        "tops = {n.split('.')[0] for n in sys.modules}\n"
        f"print(json.dumps(sorted(tops & set(harness.FORBIDDEN + ({PROGRAM!r},)))))\n")
    assert got == []


def test_no_reference_source_names_the_program():
    for f in os.listdir(os.path.join(harness.HERE, "reference")):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(harness.HERE, "reference",
                                           f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in harness.FORBIDDEN + (PROGRAM,), (f, m)
                assert top in ("math", "numpy", "torch", "h100bench"), (f, m)


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("jaxlike_module_for_this_test", sys)
    try:
        assert "jax" not in harness.forbidden_modules()
    finally:
        del sys.modules["jaxlike_module_for_this_test"]
