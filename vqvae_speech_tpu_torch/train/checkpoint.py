"""Per-epoch checkpoints in the JAX package's format, without JAX or optax.

Counterpart of ``vqvae_speech_tpu/train/checkpoint.py`` (reference
src/experiments/checkpoint_utils.py and convolutional_trainer.py:76-86):
one pickle per epoch named ``{name}_{epoch}_checkpoint.pkl`` holding
{experiment_name, epoch, params, model_state, opt_state, loss lists}; resume
picks the latest epoch by filename; loss histories live inside checkpoints
and are merged across epochs for plotting.

**Writing.** ``save_checkpoint`` takes host trees in the JAX layout, as
``convert.export_jax_params`` and ``convert.export_jax_opt_state`` make
them: ``params`` and ``model_state`` load with the JAX package's plain
``load_checkpoint``; ``opt_state`` is optax's state in plain nested tuples
``((count, mu, nu, nu_max), ())``, whose leaves flatten in optax's order.

**Reading.** ``params`` and ``model_state`` of a JAX-written checkpoint are
plain dicts of numpy arrays, but its ``opt_state`` holds optax NamedTuples,
so a plain ``pickle.load`` needs optax and jax installed. ``load_checkpoint``
unpickles with a ``find_class`` that resolves numpy and builtins as usual and
stands in a plain tuple subclass for every other class, so the optimizer
state comes back as nested tuples of numpy arrays
(``convert.load_jax_opt_state`` takes them).

Unpickling runs code named in the file: load only checkpoints this project
wrote.
"""
import os
import pickle
import re

import numpy as np
import torch

_CKPT_RE = re.compile(r"^(?P<name>.+)_(?P<epoch>\d+)_checkpoint\.pkl$")
_TRUSTED_MODULES = ("builtins", "collections", "copyreg", "numpy")


def _to_host(tree):
    """Tensors (and arrays) of a nested dict / tuple / list as numpy."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(experiments_path: str, experiment_name: str, epoch: int,
                    params, model_state, opt_state,
                    train_res_recon_error=None, train_res_perplexity=None):
    """epoch is 0-based here; stored as epoch+1 like the reference."""
    os.makedirs(experiments_path, exist_ok=True)
    payload = {
        "experiment_name": experiment_name,
        "epoch": epoch + 1,
        "params": _to_host(params),
        "model_state": _to_host(model_state),
        "opt_state": _to_host(opt_state),
        "train_res_recon_error": train_res_recon_error or [],
        "train_res_perplexity": train_res_perplexity or [],
    }
    path = os.path.join(experiments_path,
                        f"{experiment_name}_{epoch + 1}_checkpoint.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)  # atomic publish: no torn checkpoints on crash
    return path


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


def prune_checkpoints(experiments_path: str, experiment_name: str,
                      keep_last: int = 2, keep_first: bool = True):
    """Delete all but the newest ``keep_last`` checkpoints (plus the very
    first epoch's, which carries the first training step's losses). Pruning
    trades the merged cross-epoch loss history (merge_checkpoint_losses) for
    bounded disk: callers that need full curves leave it off."""
    ckpts = find_checkpoints(experiments_path, experiment_name)
    protected = set(e for e, _ in ckpts[-keep_last:])
    if keep_first and ckpts:
        protected.add(ckpts[0][0])
    for epoch, path in ckpts:
        if epoch not in protected:
            os.remove(path)


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


def merge_checkpoint_losses(experiments_path: str, experiment_name: str):
    """Merge per-epoch loss dicts across all checkpoints for plotting
    (reference checkpoint_utils.py:80-98)."""
    merged_losses, merged_perplexities = [], []
    for _, path in find_checkpoints(experiments_path, experiment_name):
        ckpt = load_checkpoint(path)
        merged_losses.extend(ckpt.get("train_res_recon_error", []))
        merged_perplexities.extend(ckpt.get("train_res_perplexity", []))
    return merged_losses, merged_perplexities
