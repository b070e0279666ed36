"""PyTorch port: checkpoint writing, and training across the two packages.

A checkpoint written by the port loads with the JAX package's plain
``load_checkpoint``, its ``opt_state`` as optax's own NamedTuples (the port
pickles its stand-ins under optax's names) with the leaves, structure and
dtypes of ``optimizer.init(params)``,
a JAX checkpoint loads in the port, and one more step from either agrees
with one more step of the side that wrote it: metrics rtol 2e-4, parameters
within the train-step test's tolerances (tests/test_torch_train_step.py).
"""
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from test_torch_train_step import (
    B,
    CFG,
    T_LAT,
    VARIANTS,
    assert_params_close,
    batches,
    both_sides,
    jax_batch,
    jax_step_draws,
    numpy_tree,
    torch_batch,
)
from vqvae_speech_tpu.train import checkpoint as jckpt
from vqvae_speech_tpu.train import trainer as jtrainer
from vqvae_speech_tpu_torch.convert import (
    export_jax_opt_state,
    export_jax_params,
    load_jax_opt_state,
    load_jax_params,
)
from vqvae_speech_tpu_torch.models import ConvVQVAE
from vqvae_speech_tpu_torch.train import (
    create_train_state,
    find_checkpoints,
    latest_checkpoint_epoch,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    merge_checkpoint_losses,
    prune_checkpoints,
    save_checkpoint,
)


def run_steps(cfg, n):
    jstate, jstep, tstate, tstep = both_sides(cfg)
    data = batches(cfg, n + 1)
    for batch in data[:n]:
        masks, perm = jax_step_draws(jstate.rng, cfg, B * T_LAT)
        jstate, _ = jstep(jstate, jax_batch(batch))
        tstate, _ = tstep(tstate, torch_batch(batch), jitter_masks=masks,
                          revival_perm=perm)
    return jstate, jstep, tstate, tstep, data[n]


def save_port(tmp_path, tstate, epoch=0, **lists):
    params, model_state = export_jax_params(tstate.model)
    return save_checkpoint(
        str(tmp_path), "exp", epoch, params, model_state,
        export_jax_opt_state(tstate.model, tstate.opt_state), **lists)


@pytest.mark.parametrize("variant", ["jitter12", "ema", "weight_norm",
                                     "speaker", "revival"])
def test_port_checkpoint_continues_in_jax(tmp_path, variant):
    cfg = dict(CFG, **VARIANTS[variant])
    jstate, jstep, tstate, tstep, batch = run_steps(cfg, 2)
    path = save_port(tmp_path, tstate)
    assert os.path.basename(path) == "exp_1_checkpoint.pkl"

    ckpt = jckpt.load_checkpoint(path)      # the JAX package's plain loader
    assert ckpt["epoch"] == 1 and ckpt["experiment_name"] == "exp"
    want_struct = jax.tree_util.tree_structure(numpy_tree(jstate.params))
    assert jax.tree_util.tree_structure(ckpt["params"]) == want_struct
    assert (jax.tree_util.tree_structure(ckpt["model_state"])
            == jax.tree_util.tree_structure(numpy_tree(jstate.model_state)))
    joptimizer = jtrainer.make_optimizer(cfg["learning_rate"])
    template = joptimizer.init(jstate.params)
    leaves = jax.tree_util.tree_leaves(ckpt["opt_state"])
    assert len(leaves) == len(jax.tree_util.tree_leaves(template))
    assert ([type(s) for s in ckpt["opt_state"]]
            == [type(s) for s in template])
    opt_state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(a) for a in leaves])
    assert int(opt_state[0].count) == 2
    for got, want in zip(jax.tree_util.tree_leaves(opt_state),
                         jax.tree_util.tree_leaves(jstate.opt_state)):
        assert got.shape == want.shape and got.dtype == want.dtype
    resumed = jtrainer.TrainState(
        jax.tree_util.tree_map(jnp.asarray, ckpt["params"]),
        jax.tree_util.tree_map(jnp.asarray, ckpt["model_state"]),
        opt_state, jstate.rng)

    masks, perm = jax_step_draws(resumed.rng, cfg, B * T_LAT)
    resumed, want = jstep(resumed, jax_batch(batch))
    tstate, got = tstep(tstate, torch_batch(batch), jitter_masks=masks,
                        revival_perm=perm)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    assert_params_close(tstate.model, resumed.params, resumed.model_state, cfg)


@pytest.mark.parametrize("variant", ["jitter12", "ema", "weight_norm",
                                     "speaker", "revival"])
def test_jax_checkpoint_continues_in_the_port(tmp_path, variant):
    cfg = dict(CFG, **VARIANTS[variant])
    jstate, jstep, _, _, batch = run_steps(cfg, 2)
    path = jckpt.save_checkpoint(str(tmp_path), "exp", 4, jstate.params,
                                 jstate.model_state, jstate.opt_state)
    assert latest_checkpoint_epoch(str(tmp_path), "exp") == (5, path)

    ckpt = load_checkpoint(path)            # no optax, no jax in the reader
    model = load_jax_params(ConvVQVAE.from_config(cfg), ckpt["params"],
                            ckpt["model_state"])
    optimizer = make_optimizer(cfg["learning_rate"])
    tstate = create_train_state(model, optimizer, device="cpu")
    load_jax_opt_state(model, ckpt["opt_state"], tstate.opt_state)
    assert tstate.opt_state.count == 2
    tstep = make_train_step(cfg, optimizer)

    masks, perm = jax_step_draws(jstate.rng, cfg, B * T_LAT)
    jstate, want = jstep(jstate, jax_batch(batch))
    tstate, got = tstep(tstate, torch_batch(batch), jitter_masks=masks,
                        revival_perm=perm)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    assert_params_close(tstate.model, jstate.params, jstate.model_state, cfg)


def test_round_trip_through_the_port_is_exact(tmp_path):
    """export -> save -> load -> load_jax_params / load_jax_opt_state gives
    back every parameter, buffer and moment bit for bit, transposed kernels
    included."""
    cfg = dict(CFG, **VARIANTS["weight_norm"], decay=0.99,
               codebook_revival=True)
    _, _, tstate, _, _ = run_steps(cfg, 2)
    ckpt = load_checkpoint(save_port(tmp_path, tstate))
    assert isinstance(ckpt["opt_state"], tuple)
    (count, mu, _, _), rest = ckpt["opt_state"]
    assert count.dtype == np.int32 and count.shape == () and rest == ()
    w = tstate.model.encoder.conv_3.v
    assert mu["encoder"]["conv_3"]["v"].shape == tuple(w.shape)[::-1]
    model = load_jax_params(ConvVQVAE.from_config(cfg), ckpt["params"],
                            ckpt["model_state"])
    for (name, got), (_, want) in zip(model.state_dict().items(),
                                      tstate.model.state_dict().items()):
        assert torch.equal(got, want), name
    optimizer = make_optimizer(cfg["learning_rate"])
    fresh = optimizer.init(model.parameters())
    load_jax_opt_state(model, ckpt["opt_state"], fresh)
    assert fresh.count == tstate.opt_state.count
    for name in ("mu", "nu", "nu_max"):
        for got, want in zip(getattr(fresh, name),
                             getattr(tstate.opt_state, name)):
            assert torch.equal(got, want)


def test_filename_contract_prune_and_merge(tmp_path):
    """``{name}_{epoch}_checkpoint.pkl`` with epoch + 1 stored (PARITY #14),
    an atomic publish, pruning that keeps the first and the newest, and the
    merged loss history; the JAX package finds and merges the same files."""
    cfg = dict(CFG)
    _, _, tstate, _, _ = run_steps(cfg, 1)
    for epoch in range(5):
        save_port(tmp_path, tstate, epoch,
                  train_res_recon_error=[{"loss": float(epoch)}],
                  train_res_perplexity=[float(10 + epoch)])
    save_port(tmp_path / "other", tstate, 0)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    found = find_checkpoints(str(tmp_path), "exp")
    assert [e for e, _ in found] == [1, 2, 3, 4, 5]
    assert found == jckpt.find_checkpoints(str(tmp_path), "exp")
    losses, perplexities = merge_checkpoint_losses(str(tmp_path), "exp")
    assert [entry["loss"] for entry in losses] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert perplexities == [10.0, 11.0, 12.0, 13.0, 14.0]
    assert (losses, perplexities) == jckpt.merge_checkpoint_losses(
        str(tmp_path), "exp")
    with open(found[0][1], "rb") as f:
        assert pickle.load(f)["epoch"] == 1     # plain pickle: numpy only
    prune_checkpoints(str(tmp_path), "exp", keep_last=2)
    assert [e for e, _ in find_checkpoints(str(tmp_path), "exp")] == [1, 4, 5]
    prune_checkpoints(str(tmp_path), "exp", keep_last=1, keep_first=False)
    assert [e for e, _ in find_checkpoints(str(tmp_path), "exp")] == [5]
    assert find_checkpoints(str(tmp_path / "missing"), "exp") == []
