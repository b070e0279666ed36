"""Three-tier configuration: YAML base + JSON experiment overrides + CLI.

Counterpart of ``vqvae_speech_tpu/train/config.py``, with the same contract:

* ``load_configuration`` — the YAML base config (reference
  src/main.py:42-46),
* ``update_configuration_from_experiments`` — top-level JSON keys override
  matching YAML keys (reference src/main.py:48-57),
* ``merge_experiment_configuration`` — per-experiment override of keys
  already present in the base config; the merged dict is frozen to
  ``{name}_configuration.yaml`` (reference src/experiments/experiment.py:67-75).

Without PyYAML (the GPU machine has none). Every configuration this project
reads or writes is a flat map of ``key: scalar`` lines whose values are
None, bools, ints, floats and strings, so the reader takes exactly that
subset of YAML and resolves each plain scalar as PyYAML's YAML 1.1 resolvers
do: ``true/false/yes/no/on/off`` in their three spellings, ``null``, ``~``
and an empty value, decimal ints, floats only in PyYAML's forms (``1e-05``,
without a dot, is a STRING; ``1.0e-05`` is a float), everything else a
string; a single-quoted string is a string. Anything outside the subset (a
double-quoted string, an indented line, a list, a nested map, an anchor, a
tag, a block scalar, a date, an octal, hex or sexagesimal number) raises
``ValueError``: the reader never guesses. The writer writes what
``yaml.dump`` writes for such a map: sorted keys, one ``key: value`` line
each, floats as Python's ``repr`` with ``.0`` put before a bare exponent,
strings plain where PyYAML would leave them plain and single-quoted
otherwise; a string that is not printable ASCII (which PyYAML would
double-quote with escapes) raises ``ValueError``. PyYAML reads the file back
equal and the reader reads PyYAML's files (tests/test_torch_config.py).
"""
import copy
import json
import math
import os
import re

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")
_LINE = re.compile(r"(?P<key>[^\s:#][^:#]*?):(?:[ \t]+(?P<value>.*))?$")
_BOOLS = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
          "NO": False, "true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False, "on": True,
          "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULLS = ("", "~", "null", "Null", "NULL")
# PyYAML's float resolver (yaml/resolver.py), sexagesimal branch apart
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_DECIMAL_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# forms PyYAML resolves to types outside the subset: octal, binary and hex
# ints, sexagesimal numbers, dates, the merge key and the value key
_OTHER = re.compile(r"""^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt \t].*)?
                    |<<|=)$""", re.X)
_FIRST = "#,[]{}&*!|>'\"%@`"


def _resolve_plain(text: str):
    """A plain scalar as PyYAML's implicit resolvers type it."""
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _NULLS:
        return None
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        if v.lstrip("+-") == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return float(v)
    if _DECIMAL_INT.match(text):
        return int(text.replace("_", ""))
    if _OTHER.match(text):
        raise ValueError(f"{text!r} is a YAML form outside the flat scalar "
                         "subset this reader takes")
    return text


def _comment_or_end(rest: str, where: str) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"{where}: unexpected {rest!r} after a quoted string")


def _single_quoted(text: str, where: str) -> str:
    out, i = [], 1
    while True:
        j = text.find("'", i)
        if j < 0:
            raise ValueError(f"{where}: a quoted string must close on its "
                             "own line")
        out.append(text[i:j])
        if text[j + 1:j + 2] == "'":
            out.append("'")
            i = j + 2
            continue
        _comment_or_end(text[j + 1:], where)
        return "".join(out)


def _plain_end(text: str) -> int:
    """Where a plain scalar ends: at a comment (`` #``) or the line's end."""
    m = re.search(r"[ \t]#", text)
    return m.start() if m else len(text)


def _value(text: str, where: str):
    if text == "" or text.startswith("#"):
        return None
    if text[0] == "'":
        return _single_quoted(text, where)
    followed_by_space = len(text) == 1 or text[1] in " \t"
    if text[0] in _FIRST or (text[0] in "-?:" and followed_by_space):
        raise ValueError(f"{where}: {text!r} is not a scalar of the flat "
                         "subset (a double-quoted string, a list, flow "
                         "collection, anchor, alias, tag, block scalar or "
                         "reserved indicator)")
    plain = text[:_plain_end(text)].rstrip()
    if re.search(r":(?:[ \t]|$)", plain):
        raise ValueError(f"{where}: nested mapping in {text!r}")
    return _resolve_plain(plain)


def parse_configuration(text: str):
    """A flat ``key: scalar`` YAML document -> dict (None when it holds no
    key, as PyYAML gives for an empty document)."""
    out = None
    for number, line in enumerate(text.splitlines(), start=1):
        where = f"line {number}"
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: indented line {line!r}: only a flat "
                             "map of scalars is supported")
        m = _LINE.match(line.rstrip())
        if not m or not _KEY.fullmatch(m.group("key")):
            raise ValueError(f"{where}: {line!r} is not a 'key: scalar' line "
                             "with a plain key")
        key = m.group("key")
        if _resolve_plain(key) != key:
            raise ValueError(f"{where}: key {key!r} does not resolve to a "
                             "string")
        out = {} if out is None else out
        out[key] = _value((m.group("value") or "").strip(), where)
    return out


def _printable_ascii(s: str) -> bool:
    return all(" " <= ch <= "~" for ch in s)


def _plain_allowed(s: str) -> bool:
    """Whether PyYAML's emitter writes ``s`` plain in a block mapping
    (yaml/emitter.py ``analyze_scalar`` for printable ASCII strings)."""
    if not s or s != s.strip(" ") or s.startswith(("---", "...")):
        return False
    if not _printable_ascii(s):
        return False
    if s[0] in _FIRST:
        return False
    if s[0] in "-?:" and (len(s) == 1 or s[1] == " "):
        return False
    if re.search(r":(?: |$)", s[1:]) or " #" in s:
        return False
    try:
        return _resolve_plain(s) == s
    except ValueError:
        return False


def _format_scalar(value, key: str) -> str:
    if value is None:
        return "null"
    # exact types: numpy scalars are not in the subset (PyYAML writes them
    # as python objects)
    if type(value) is bool:
        return "true" if value else "false"
    if type(value) is int:
        return str(value)
    if type(value) is float:
        if value != value:
            return ".nan"
        if value in (math.inf, -math.inf):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if type(value) is str:
        if _plain_allowed(value):
            return value
        if _printable_ascii(value):
            return "'" + value.replace("'", "''") + "'"
        raise ValueError(f"{key}: {value!r} is not printable ASCII (PyYAML "
                         "would double-quote it with escapes)")
    raise TypeError(f"{key}: {type(value).__name__} {value!r} is not a "
                    "scalar of the flat subset (None, bool, int, float, str)")


def dump_configuration(configuration: dict) -> str:
    """The text ``yaml.dump`` writes for a flat map of scalars."""
    lines = []
    for key in sorted(configuration):
        if (not isinstance(key, str) or not _KEY.fullmatch(key)
                or not _plain_allowed(key)):
            raise ValueError(f"key {key!r} is not a plain string key")
        lines.append(f"{key}: {_format_scalar(configuration[key], key)}\n")
    return "".join(lines)


def load_configuration(configuration_path: str) -> dict:
    with open(configuration_path, "r", encoding="utf-8") as f:
        return parse_configuration(f.read())


def update_configuration_from_experiments(experiments_configuration_path: str,
                                          configuration: dict) -> dict:
    with open(experiments_configuration_path, "r") as f:
        experiment_configuration = json.load(f)
    for entry in experiment_configuration:
        if entry == "experiments":
            continue
        if entry in configuration:
            configuration[entry] = experiment_configuration[entry]
    return configuration


def merge_experiment_configuration(global_configuration: dict,
                                   experiment_configuration: dict) -> dict:
    """Deep-copy the base, then apply experiment keys that exist in the base."""
    merged = copy.deepcopy(global_configuration)
    for key, value in experiment_configuration.items():
        if key in merged:
            merged[key] = value
    return merged


def freeze_configuration(configuration: dict, experiments_path: str,
                         name: str) -> str:
    text = dump_configuration(configuration)
    os.makedirs(experiments_path, exist_ok=True)
    path = frozen_configuration_path(experiments_path, name)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


def frozen_configuration_path(experiments_path: str, name: str) -> str:
    return os.path.join(experiments_path, f"{name}_configuration.yaml")
