"""Sharded checkpoints through ``torch.distributed.checkpoint`` (DCP).

Counterpart of ``vqvae_speech_tpu/train/orbax_checkpoint.py`` (orbax and
tensorstore belong to JAX), with its contract: a save an epoch, the newest
epoch found on disk, a payload of the parameters, the model state, the
optimizer state and the two loss lists. The layout is
``{experiments_path}/{name}_dcp/{epoch + 1}/``: DCP's files, and
``meta.json`` beside them (the name, epoch + 1, the two lists and the
payload's nesting).

The payload is a tree of dicts, lists and tuples (NamedTuples are stored
as tuples) whose leaves are tensors, numpy arrays or numbers; every leaf
comes back as a tensor. Under a process group every rank calls the save
and the load (DCP's collectives): a replicated tensor is written once, and
``load_checkpoint_dcp(target=...)`` restores each rank's tensors in place,
on their device. Without a process group it reads and writes in one
process.

Neither package reads the other's sharded checkpoint: the pickle
checkpoints (``train/checkpoint.py``) are the format the two share.
"""
import json
import os
import re

import numpy as np
import torch
import torch.distributed as dist

from vqvae_speech_tpu_torch.parallel.mesh import is_writer

_EPOCH_RE = re.compile(r"^\d+$")
_META = "meta.json"


def _root(experiments_path: str, experiment_name: str) -> str:
    return os.path.join(experiments_path, f"{experiment_name}_dcp")


def _flatten(tree, prefix, flat):
    """DCP's flat {key: tensor} and the tree's skeleton (JSON) with each
    leaf's key in its place."""
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, f"{prefix}{k}/", flat)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, f"{prefix}{i}/", flat)
                       for i, v in enumerate(tree)]}
    key = prefix.rstrip("/")
    flat[key] = (tree if isinstance(tree, torch.Tensor)
                 else torch.as_tensor(np.asarray(tree)))
    return {"leaf": key}


def _unflatten(skeleton, flat):
    if "dict" in skeleton:
        return {k: _unflatten(v, flat) for k, v in skeleton["dict"].items()}
    if "list" in skeleton:
        return [_unflatten(v, flat) for v in skeleton["list"]]
    if "tuple" in skeleton:
        return tuple(_unflatten(v, flat) for v in skeleton["tuple"])
    return flat[skeleton["leaf"]]


def save_checkpoint_dcp(experiments_path: str, experiment_name: str,
                        epoch: int, params, model_state, opt_state,
                        train_res_recon_error=None,
                        train_res_perplexity=None) -> str:
    """Write epoch ``epoch``'s checkpoint (directory ``epoch + 1``) and
    return its path; under a process group every rank calls it."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(_root(experiments_path, experiment_name),
                        str(epoch + 1))
    flat = {}
    skeleton = _flatten({"params": params, "model_state": model_state,
                         "opt_state": opt_state}, "", flat)
    dcp.save(flat, checkpoint_id=path)
    if is_writer():
        meta = {"experiment_name": experiment_name, "epoch": epoch + 1,
                "train_res_recon_error": train_res_recon_error or [],
                "train_res_perplexity": train_res_perplexity or [],
                "skeleton": skeleton}
        with open(os.path.join(path, _META), "w") as f:
            json.dump(meta, f)
    if dist.is_initialized():
        dist.barrier()
    return path


def latest_checkpoint_epoch_dcp(experiments_path: str, experiment_name: str):
    """(newest epoch, its path), or (None, None)."""
    root = _root(experiments_path, experiment_name)
    if not os.path.isdir(root):
        return None, None
    epochs = sorted(int(d) for d in os.listdir(root) if _EPOCH_RE.match(d)
                    and os.path.isfile(os.path.join(root, d, _META)))
    if not epochs:
        return None, None
    return epochs[-1], os.path.join(root, str(epochs[-1]))


def load_checkpoint_dcp(experiments_path: str, experiment_name: str,
                        epoch: int = None, target=None) -> dict:
    """Restore a checkpoint (the newest without ``epoch``) as the meta's
    keys plus ``params``, ``model_state`` and ``opt_state``. Without a
    ``target`` the tensors are built on the CPU from DCP's metadata; with
    one (a payload-shaped tree {"params", "model_state", "opt_state"} of
    tensors, on any device) they are restored into its tensors, in place."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    if epoch is None:
        epoch, _ = latest_checkpoint_epoch_dcp(experiments_path,
                                               experiment_name)
        if epoch is None:
            raise FileNotFoundError(
                f"no DCP checkpoints for '{experiment_name}'")
    path = os.path.join(_root(experiments_path, experiment_name), str(epoch))
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    skeleton = meta.pop("skeleton")
    flat = {}
    if target is not None:
        _flatten(target, "", flat)
    else:
        stored = FileSystemReader(path).read_metadata().state_dict_metadata
        flat = {key: torch.empty(tuple(md.size), dtype=md.properties.dtype)
                for key, md in stored.items()}
    dcp.load(flat, checkpoint_id=path)
    meta.update(_unflatten(skeleton, flat))
    return meta
