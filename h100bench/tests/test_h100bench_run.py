"""The command's refusals: no result without a card, and none from a
directory that holds only the benchmark's files."""
import os
import shutil
import subprocess
import sys

from h100bench import harness


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", "vq44-train-b64",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
