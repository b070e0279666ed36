"""PyTorch port: the WaveNet-VQ-VAE training loop, through the resume
contract shared with the JAX package.

The port's ``Experiments`` trains ``decoder_type: wavenet`` (the tiny
configuration of tests/test_wavenet_trainer.py) on a synthetic store; the
JAX ``WaveNetTrainer`` resumes from the port's checkpoint for epoch 2; the
port resumes from JAX's for epoch 3. The init draws differ (numpy against
``jax.random``, PARITY #3) and so do the dropout draws, so the runs are
held to their contract, not to each other's numbers: checkpoint names and
epochs, the optimizer's step count, the tree's structure, the history file,
``prune_checkpoints`` and ``checkpoint_every``.
"""
import json
import os

import jax
import numpy as np
import yaml

from tests.test_torch_wavenet_train import WN_CFG
from vqvae_speech_tpu.train.checkpoint import load_checkpoint as jax_load
from vqvae_speech_tpu_torch.data.synthetic import build_synthetic_store
from vqvae_speech_tpu_torch.train import Experiments, find_checkpoints


def _setup_wavenet(tmp_path, **overrides):
    root = str(tmp_path)
    store_root = os.path.join(root, "features")
    build_synthetic_store(store_root, num_train=4, num_val=2, length=1920,
                          device="cpu")
    cfg = dict(WN_CFG, use_jitter=True, prune_checkpoints=True)
    cfg.update(overrides)
    cfg_path = os.path.join(root, "wn.yaml")
    with open(cfg_path, "w") as f:
        yaml.dump(cfg, f)
    spec = {"experiments_path": os.path.join(root, "experiments"),
            "results_path": os.path.join(root, "results"),
            "configuration_path": cfg_path, "seed": 7,
            "experiments": {"wn": {}}}
    spec_path = os.path.join(root, "exp.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return root, spec_path, store_root


def _set_frozen(exp_dir, **values):
    frozen = os.path.join(exp_dir, "wn_configuration.yaml")
    with open(frozen) as f:
        cfg = yaml.load(f, yaml.FullLoader)
    cfg.update(values)
    with open(frozen, "w") as f:
        yaml.dump(cfg, f)


def test_wavenet_experiment_resumes_across_packages(tmp_path):
    from vqvae_speech_tpu.train import Experiments as JaxExperiments

    root, spec_path, store_root = _setup_wavenet(tmp_path)
    exp_dir = os.path.join(root, "experiments")
    Experiments.load(spec_path, data_root=store_root, device="cpu").train()
    assert [e for e, _ in find_checkpoints(exp_dir, "wn")] == [1]
    ours = jax_load(os.path.join(exp_dir, "wn_1_checkpoint.pkl"))
    losses = ours["train_res_recon_error"]
    assert len(losses) == 2      # 4 utterances, batch 2
    assert all(np.isfinite(l["loss"]) for l in losses)
    # cross-entropy on 32 classes starts near log(32) ~ 3.47
    assert losses[0]["reconstruction_loss"] < 8.0
    assert "e_latent_loss" in losses[0] and "perplexity" not in losses[0]
    with open(os.path.join(exp_dir, "wn_history.json")) as f:
        assert [h["epoch"] for h in json.load(f)] == [1]

    # JAX resumes from the port's checkpoint for epoch 2 ...
    _set_frozen(exp_dir, num_epochs=2)
    JaxExperiments.load(spec_path, data_root=store_root).train()
    theirs = jax_load(os.path.join(exp_dir, "wn_2_checkpoint.pkl"))
    assert int(theirs["opt_state"][0].count) == 4
    assert (jax.tree_util.tree_structure(theirs["params"])
            == jax.tree_util.tree_structure(ours["params"]))
    # ... and the port from JAX's for epoch 3
    _set_frozen(exp_dir, num_epochs=3)
    Experiments.load(spec_path, data_root=store_root, device="cpu").train()
    last = jax_load(os.path.join(exp_dir, "wn_3_checkpoint.pkl"))
    assert int(last["opt_state"][0].count) == 6
    assert all(np.isfinite(l["loss"]) for l in last["train_res_recon_error"])
    # prune_checkpoints keeps the first and the last two
    assert [e for e, _ in find_checkpoints(exp_dir, "wn")] == [1, 2, 3]
    with open(os.path.join(exp_dir, "wn_history.json")) as f:
        assert [h["epoch"] for h in json.load(f)] == [1, 2, 3]
    # the port's epoch 3 started from JAX's epoch-2 parameters
    first = jax.tree_util.tree_leaves(theirs["params"])
    moved = jax.tree_util.tree_leaves(last["params"])
    assert max(float(np.abs(a - b).max()) for a, b in zip(first, moved)) \
        < 3 * 2 * WN_CFG["learning_rate"] * 1.01


def test_checkpoint_every_and_the_last_epoch(tmp_path):
    """checkpoint_every=2 over 3 epochs saves epochs 2 and 3; the loss
    lists of unsaved epochs join the next checkpoint's."""
    root, spec_path, store_root = _setup_wavenet(
        tmp_path, num_epochs=3, checkpoint_every=2, prune_checkpoints=False)
    exp_dir = os.path.join(root, "experiments")
    Experiments.load(spec_path, data_root=store_root, device="cpu").train()
    assert [e for e, _ in find_checkpoints(exp_dir, "wn")] == [2, 3]
    two = jax_load(os.path.join(exp_dir, "wn_2_checkpoint.pkl"))
    assert len(two["train_res_recon_error"]) == 4
    assert len(two["train_res_perplexity"]) == 4
