"""Read the JAX package's per-epoch checkpoints without JAX or optax.

Counterpart of the reading half of ``vqvae_speech_tpu/train/checkpoint.py``:
checkpoints are pickles named ``{name}_{epoch}_checkpoint.pkl`` holding
{experiment_name, epoch, params, model_state, opt_state, loss lists}.
``params`` and ``model_state`` are plain dicts of numpy arrays, but
``opt_state`` holds optax NamedTuples (``optax.amsgrad`` states), so a plain
``pickle.load`` needs optax and jax installed. ``load_checkpoint`` unpickles
with a ``find_class`` that resolves numpy and builtins as usual and stands in
a plain tuple subclass for every other class, so the optimizer state comes
back as nested tuples of numpy arrays.

Unpickling runs code named in the file: load only checkpoints this project
wrote.
"""
import os
import pickle
import re

_CKPT_RE = re.compile(r"^(?P<name>.+)_(?P<epoch>\d+)_checkpoint\.pkl$")
_TRUSTED_MODULES = ("builtins", "collections", "copyreg", "numpy")


def find_checkpoints(experiments_path: str, experiment_name: str):
    """All (epoch, path) pairs for an experiment, ascending by epoch."""
    if not os.path.isdir(experiments_path):
        return []
    out = []
    for fname in os.listdir(experiments_path):
        m = _CKPT_RE.match(fname)
        if m and m.group("name") == experiment_name:
            out.append((int(m.group("epoch")),
                        os.path.join(experiments_path, fname)))
    return sorted(out)


def latest_checkpoint_epoch(experiments_path: str, experiment_name: str):
    ckpts = find_checkpoints(experiments_path, experiment_name)
    return ckpts[-1] if ckpts else (None, None)


class _StandIn(tuple):
    """Takes the place of a class this process cannot import (optax's
    NamedTuple states): keeps the constructor arguments as a tuple."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args + tuple(kwargs.values()))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _TRUSTED_MODULES:
            return super().find_class(module, name)
        return type(name, (_StandIn,), {"__module__": module})


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _Unpickler(f).load()
