"""PyTorch port: the training loop against the JAX package's, through the
resume contract.

The JAX package trains epoch 1 of a tiny no-jitter experiment on a synthetic
store (``Experiments.load(spec, data_root=store).train()``; its init draws
from ``jax.random``, which the port cannot reproduce, PARITY #3). Then, as
``tests/test_training.py::test_auto_resume_continues_from_latest_epoch``
does, the frozen config's ``num_epochs`` goes to 3 and each package resumes
from that checkpoint in its own copy of the directory, with the codebook and
gradient statistics hooks on. Both see the same batches (the loader's numpy
shuffle from the experiment seed). Held against JAX after epochs 2 and 3:
the checkpoint file names, every ``params``, ``model_state`` and
``opt_state`` leaf, the loss and perplexity lists and the hooks' pickles.
Then each package takes epoch 4 from the other's epoch-3 checkpoint: JAX
resumes from a checkpoint the port wrote and the port from JAX's.

Tolerances, from the spread measured over these runs (8 steps at lr 2e-4,
batch 4; the largest differences seen, gradient / EMA quantizer, in
brackets): parameters atol 1e-6 (4.5e-08 / 4.1e-08;
tests/test_torch_train_step.py holds 5 steps to 5e-5); EMA state rtol 1e-5
+ atol 1e-6 (1.0e-06 relative: an EMA codebook row is ema_w over a
Laplace-smoothed cluster size, near zero for a code no row chose, so such
rows reach 1e4); each Adam moment leaf within 5e-5 of its largest magnitude
(mu 8.2e-07, nu 4.9e-07, nu_max 9.1e-06: optax's bias correction runs in
f64 under the tests' ``jax_enable_x64``, the port's in f32, 1.3e-5 apart at
the first step); losses and perplexities rtol 1e-5 (9.4e-07); gradient
statistics rtol 1e-4 (the grad-stats tolerance of
tests/test_torch_train_step.py; 1.3e-06); code indices equal (0 differ) and
codebook rows rtol 1e-5 + atol 1e-6 (4.1e-06 relative).
"""
import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import yaml

from test_training import _setup
from vqvae_speech_tpu.train import Experiments as JaxExperiments
from vqvae_speech_tpu.train.checkpoint import load_checkpoint as jax_load
from vqvae_speech_tpu_torch.train import Experiments, find_checkpoints

RTOL = {"params": 0, "model_state": 1e-5}
ATOL = {"params": 1e-6, "model_state": 1e-6}
MOMENT_OF_SCALE = 5e-5


def _set_frozen(exp_dir, **values):
    frozen = os.path.join(exp_dir, "tiny_configuration.yaml")
    with open(frozen) as f:
        cfg = yaml.load(f, yaml.FullLoader)
    cfg.update(values)
    with open(frozen, "w") as f:
        yaml.dump(cfg, f)


def _copy_run(root, spec_path, name):
    """A copy of the experiments directory and a spec that points at it."""
    exp_dir = os.path.join(root, name)
    shutil.copytree(os.path.join(root, "experiments"), exp_dir)
    with open(spec_path) as f:
        spec = json.load(f)
    spec["experiments_path"] = exp_dir
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return exp_dir, path


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_checkpoints_close(got_path, want_path):
    got, want = jax_load(got_path), jax_load(want_path)
    assert got["epoch"] == want["epoch"]
    assert got["experiment_name"] == want["experiment_name"]
    for part in ("params", "model_state"):
        g, w = _leaves(got[part]), _leaves(want[part])
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=RTOL[part], atol=ATOL[part],
                                       err_msg=jax.tree_util.keystr(path))
    (g_state, g_rest), (w_state, w_rest) = got["opt_state"], want["opt_state"]
    assert type(g_state) is type(w_state) and type(g_rest) is type(w_rest)
    assert int(g_state.count) == int(w_state.count)
    for name in ("mu", "nu", "nu_max"):
        for (path, a), (_, b) in zip(_leaves(getattr(g_state, name)),
                                     _leaves(getattr(w_state, name))):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=MOMENT_OF_SCALE * np.abs(b).max(),
                err_msg=name + jax.tree_util.keystr(path))
    g_losses, w_losses = (got["train_res_recon_error"],
                          want["train_res_recon_error"])
    assert len(g_losses) == len(w_losses) == 4
    for a, b in zip(g_losses, w_losses):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-7,
                                       err_msg=key)
    np.testing.assert_allclose(got["train_res_perplexity"],
                               want["train_res_perplexity"], rtol=1e-5)


def _assert_hook_pickles_close(got_dir, want_dir):
    names = sorted(f for f in os.listdir(want_dir) if f.endswith(".pickle"))
    assert sorted(f for f in os.listdir(got_dir)
                  if f.endswith(".pickle")) == names
    assert any("codebook-stats" in n for n in names)
    assert any("gradient-stats" in n for n in names)
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(want_dir, name), "rb") as f:
            want = pickle.load(f)
        assert sorted(got) == sorted(want), name
        if "gradient-stats" in name:
            for part, entry in want.items():
                assert got[part]["layers"] == entry["layers"], part
                for key in ("avg_grads", "max_grads"):
                    np.testing.assert_allclose(got[part][key], entry[key],
                                               rtol=1e-4, err_msg=part + key)
            continue
        for key in ("n_embedding", "batch_size"):
            assert got[key] == want[key]
        for key in ("encoding_indices", "speaker_ids"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        for key in ("embedding", "concatenated_quantized"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("decay", [0.0, 0.99], ids=["gradient_vq", "ema_vq"])
def test_resumed_epochs_follow_jax_and_carry_over(tmp_path, decay):
    root, spec_path, store_root = _setup(
        tmp_path, cfg_overrides={"decay": decay, "learning_rate": 2e-4},
        experiments={"tiny": {"num_epochs": 1}})
    JaxExperiments.load(spec_path, data_root=store_root).train()
    _set_frozen(os.path.join(root, "experiments"), num_epochs=3,
                record_codebook_stats=True, record_gradient_stats=True)
    jax_dir, jax_spec = _copy_run(root, spec_path, "jax_run")
    port_dir, port_spec = _copy_run(root, spec_path, "port_run")

    JaxExperiments.load(jax_spec, data_root=store_root).train()
    exps = Experiments.load(port_spec, data_root=store_root, device="cpu")
    assert exps.experiments[0].resumed
    exps.train()

    files = sorted(f for f in os.listdir(jax_dir) if f.endswith(".pkl"))
    assert files == ["tiny_1_checkpoint.pkl", "tiny_2_checkpoint.pkl",
                     "tiny_3_checkpoint.pkl"]
    assert sorted(f for f in os.listdir(port_dir) if f.endswith(".pkl")) \
        == files
    for name in files[1:]:
        _assert_checkpoints_close(os.path.join(port_dir, name),
                                  os.path.join(jax_dir, name))
    _assert_hook_pickles_close(port_dir, jax_dir)
    if decay:
        ckpt = jax_load(os.path.join(port_dir, files[-1]))
        assert np.any(ckpt["model_state"]["vq"]["ema_cluster_size"] != 0)

    # epoch 4 of each from the other's epoch 3
    for exp_dir in (jax_dir, port_dir):
        _set_frozen(exp_dir, num_epochs=4, record_codebook_stats=False,
                    record_gradient_stats=False)
    JaxExperiments.load(port_spec, data_root=store_root).train()
    Experiments.load(jax_spec, data_root=store_root, device="cpu").train()
    assert [e for e, _ in find_checkpoints(port_dir, "tiny")] == [1, 2, 3, 4]
    _assert_checkpoints_close(os.path.join(jax_dir, "tiny_4_checkpoint.pkl"),
                              os.path.join(port_dir, "tiny_4_checkpoint.pkl"))
