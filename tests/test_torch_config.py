"""PyTorch port: the configuration reader and writer, without PyYAML.

The reader must agree with ``yaml.load(..., FullLoader)`` (values and their
types) on every YAML in ``configurations/``, on frozen configs the JAX
package writes and on generated flat maps of scalars; the writer's file must
read back equal through PyYAML and the port, and be byte-equal to
``yaml.dump``'s for the repository's configurations. Outside the flat scalar
subset the reader raises. PyYAML is used here only, never by the port.
"""
import glob
import json
import math
import os

import numpy as np
import pytest
import yaml

from vqvae_speech_tpu.train import config as jconfig
from vqvae_speech_tpu_torch.train import config as tconfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO_ROOT, "configurations", "*.yaml")))
EXPERIMENT_FILES = sorted(glob.glob(os.path.join(REPO_ROOT, "configurations",
                                                 "experiments_*.json")))


def _same(got, want):
    assert got == want or (got != got and want != want)
    assert type(got) is type(want), (got, want)


def _assert_equal_maps(got, want):
    assert list(got) == list(want) or set(got) == set(want)
    assert set(got) == set(want)
    for key in want:
        _same(got[key], want[key])


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_reader_equals_pyyaml_on_the_repository_configs(path, tmp_path):
    want = yaml.load(open(path), Loader=yaml.FullLoader)
    got = tconfig.load_configuration(path)
    _assert_equal_maps(got, want)
    assert tconfig.dump_configuration(want) == yaml.dump(want)
    frozen = tconfig.freeze_configuration(got, str(tmp_path), "exp")
    assert frozen == tconfig.frozen_configuration_path(str(tmp_path), "exp")
    _assert_equal_maps(jconfig.load_configuration(frozen), want)


@pytest.mark.parametrize("spec", EXPERIMENT_FILES, ids=os.path.basename)
def test_frozen_experiment_configs_cross_both_ways(spec, tmp_path):
    """Every experiment of every experiments JSON, merged as both packages
    merge it: the port reads the JAX package's frozen file and JAX reads the
    port's, equal to the merged dict."""
    with open(spec) as f:
        experiments = json.load(f)["experiments"]
    base = tconfig.load_configuration(
        os.path.join(REPO_ROOT, "configurations", "vctk_features.yaml"))
    base = tconfig.update_configuration_from_experiments(spec, base)
    assert base == jconfig.update_configuration_from_experiments(
        spec, jconfig.load_configuration(
            os.path.join(REPO_ROOT, "configurations", "vctk_features.yaml")))
    for name, overrides in experiments.items():
        merged = tconfig.merge_experiment_configuration(base, overrides)
        assert merged == jconfig.merge_experiment_configuration(base,
                                                                overrides)
        jpath = jconfig.freeze_configuration(merged, str(tmp_path / "jax"),
                                             name)
        tpath = tconfig.freeze_configuration(merged, str(tmp_path / "port"),
                                             name)
        assert open(tpath).read() == open(jpath).read()
        _assert_equal_maps(tconfig.load_configuration(jpath), merged)
        _assert_equal_maps(jconfig.load_configuration(tpath), merged)


def _generated_maps():
    rng = np.random.default_rng(0)
    floats = [1e-05, 2e-4, 0.0002, 1e17, 1.5e-300, -0.0, 0.1, 1 / 3, 123.0,
              -7.25e8, math.inf, -math.inf, math.nan]
    floats += [float(x) for x in rng.standard_normal(8) * 10.0 ** rng.integers(
        -12, 12, 8)]
    strings = ["1e-05", "./data/vctk", "data/vctk/vctk-mfcc-stats.pickle",
               "kaiser_fast", "", " lead", "trail ", "yes", "No", "off",
               "null", "~", "1.5", "12", "0755", "0x1F", "1:30",
               "2001-01-01", "a: b", "a #b", "a#b", "-x", "- x", "[a]",
               "{a}", "?x", ":x", "x:", "it's", "say \"hi\"", "...",
               "---x", "a  b", "=", "<<", ".inf", "1_000", "+1", "0.", ".5",
               "1.e+5", "C:\\path", "@home",
               "%pct", "*star", "&amp", "!bang", "|pipe", ">gt", "`tick"]
    scalars = ([None, True, False, 0, -3, 7, 10 ** 20] + floats + strings)
    return [{f"key_{i}": value} for i, value in enumerate(scalars)] + [
        {f"k{j}": scalars[(7 * j) % len(scalars)] for j in range(12)}]


@pytest.mark.parametrize("mapping", _generated_maps(),
                         ids=lambda m: repr(list(m.values())[0])[:24])
def test_written_maps_read_back_equal(mapping):
    text = tconfig.dump_configuration(mapping)
    _assert_equal_maps(yaml.load(text, Loader=yaml.FullLoader), mapping)
    _assert_equal_maps(tconfig.parse_configuration(text), mapping)
    pyyaml_text = yaml.dump(mapping)
    try:
        got = tconfig.parse_configuration(pyyaml_text)
    except ValueError:
        # only forms PyYAML itself reads as another type than a flat scalar
        # of the subset would be refused; none of these maps holds one
        raise AssertionError(f"refused PyYAML's own {pyyaml_text!r}")
    _assert_equal_maps(got, mapping)


@pytest.mark.parametrize("text, want", [
    ("a: 1e-05\n", {"a": "1e-05"}),
    ("a: 1.0e-05\n", {"a": 1e-05}),
    ("a: 1.0e5\n", {"a": "1.0e5"}),
    ("a:\nb: ~\nc: null\n", {"a": None, "b": None, "c": None}),
    ("a: yes\nb: Off\nc: TRUE\n", {"a": True, "b": False, "c": True}),
    ("a: 'x'' y'  # note\nb: 'caf\u00e9'\n", {"a": "x' y", "b": "caf\u00e9"}),
    ("# head\n\na: 0.0   # > 0 selects\n", {"a": 0.0}),
    ("a: 1_000\nb: +3\nc: -0\n", {"a": 1000, "b": 3, "c": 0}),
    ("a: x\na: y\n", {"a": "y"}),
    ("a: http://host/x\n", {"a": "http://host/x"}),
    ("", None),
])
def test_reader_resolves_as_pyyaml(text, want):
    assert yaml.load(text, Loader=yaml.FullLoader) == want
    got = tconfig.parse_configuration(text)
    assert got == want
    if want:
        for key in want:
            _same(got[key], yaml.load(text, Loader=yaml.FullLoader)[key])


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n",             # nested map
    "a: [1, 2]\n",              # flow list
    "a: {b: 1}\n",              # flow map
    "a:\n- 1\n",                # block list
    "- 1\n",                    # top-level list
    "a: &x 1\nb: *x\n",         # anchor and alias
    "a: !!str 1\n",             # tag
    "a: |\n  text\n",           # block scalar
    "a: b: c\n",                # mapping in a value
    "a: 0755\n",                # octal int
    "a: 0x1F\n",                # hex int
    "a: 1:30\n",                # sexagesimal
    "a: 2001-01-01\n",          # date
    "a: 'open\n",               # unclosed quote
    'a: "x"\n',                 # double-quoted string
    "---\na: 1\n",              # document marker
    "a:1\n",                    # not a mapping line
    "yes: 1\n",                 # a key that is not a string
])
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(ValueError):
        tconfig.parse_configuration(text)


@pytest.mark.parametrize("value", [[1, 2], {"b": 1}, (1,), np.float32(1.0),
                                   np.int64(3)])
def test_writer_raises_on_values_outside_the_subset(value, tmp_path):
    with pytest.raises(TypeError):
        tconfig.freeze_configuration({"a": value}, str(tmp_path), "exp")
    assert not os.path.exists(tconfig.frozen_configuration_path(
        str(tmp_path), "exp"))


@pytest.mark.parametrize("value", ["caf\u00e9", "tab\tinside", "bell\x07"])
def test_writer_raises_on_strings_pyyaml_would_double_quote(value, tmp_path):
    assert yaml.dump({"a": value}).startswith('a: "')
    with pytest.raises(ValueError):
        tconfig.freeze_configuration({"a": value}, str(tmp_path), "exp")
    assert not os.path.exists(tconfig.frozen_configuration_path(
        str(tmp_path), "exp"))
