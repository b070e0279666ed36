"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import ast
import os
import re

import pytest

from h100bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"])
        assert _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _one_line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", CELLS)]
        assert len(reported) >= 2


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_one_metric_its_cells_report(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert _one_line(metric["layer"])
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", CELLS)
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    assert os.path.isfile(os.path.join(harness.HERE, "metrics",
                                       metric["name"] + ".py"))
    assert callable(harness.reader(metric["name"]).read)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_file_of_a_cell_is_found_by_name(cell):
    w = CELLS[cell]
    config = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert config["file"].startswith("h100bench/configs/")
    cfg = harness.load_json(os.path.join(harness.ROOT, config["file"]))
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic",
                                             w["traffic"] + ".json"))
    assert callable(harness.driver(traffic["kind"]).Cell)
    limits = harness.load_json(os.path.join(harness.HERE, "limits",
                                            cell + ".json"))
    assert limits["limits"]
    assert harness.reference(w["config"]).__doc__
    assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    # the cell's sizes for the CPU tests shrink keys the cell has
    tiny = harness.load_json(os.path.join(harness.HERE, "tiny",
                                          cell + ".json"))
    assert set(tiny) == {"config", "traffic"}
    assert set(tiny["config"]) <= set(cfg)
    assert set(tiny["traffic"]) <= set(traffic)


def test_files_under_paths_are_named_from_names():
    for base, _, files in os.walk(harness.HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), harness.ROOT)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_configuration_files_hold_what_the_program_reads():
    for c in BENCH["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        keys = harness.reference(c["name"]).KEYS
        assert isinstance(keys, tuple) and keys, c["name"]
        for key in keys:
            assert key in cfg, (c["name"], key)


@pytest.mark.parametrize("config", sorted(c["name"] for c in BENCH["configs"]))
def test_each_reference_names_every_key_it_reads(config):
    """Every ``cfg["<key>"]`` in the reference's source is in its KEYS."""
    ref = harness.reference(config)
    tree = ast.parse(open(ref.__file__).read())
    read = {node.slice.value for node in ast.walk(tree)
            if isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name) and node.value.id == "cfg"
            and isinstance(node.slice, ast.Constant)}
    assert read <= set(ref.KEYS), sorted(read - set(ref.KEYS))
