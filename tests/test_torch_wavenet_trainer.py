"""PyTorch port: WaveNet-VQ-VAE training against the JAX package's
``make_wavenet_train_step`` and ``WaveNetTrainer``.

Three steps of the port's step against JAX's jitted step from the same
tree, on the same batches, with JAX's draws recomputed from its key splits
(``train/wavenet_trainer.py:62-68`` and ``:98-110``) and fed to the port:
the teacher-forcing input mask of ``ar_input_dropout``, the jitter and the
dropout masks, and revival's permutation. The variants: plain, with
``ar_input_dropout``, with revival (counts from the one-hot of the code
indices), and the bf16 decoder.

The loop and the cross-package resume are in
tests/test_torch_wavenet_resume.py.

Tolerances, from the spread measured over two seeds of every variant (the
largest, in brackets). f32, after 3 steps at lr 2e-4: metrics rtol 1e-5
(6.2e-07), parameters atol 2e-6 (2.5e-07). The bf16 decoder: metrics rtol
1e-4 (2.9e-06); parameters: every element within 6 lr, the most three
Adam steps can part by when a gradient element near zero takes another
sign in each package's bf16 rounding (5.8e-04), and at most 2% of the
elements further apart than 5e-5 (0.8%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_wavenet_train import (
    B,
    T_LAT,
    WN_CFG,
    batch_arrays,
    both_models,
    jax_decoder_draws,
    numpy_tree,
)
from vqvae_speech_tpu.train import wavenet_trainer as jwt
from vqvae_speech_tpu_torch.convert import export_jax_params
from vqvae_speech_tpu_torch.train import (
    create_wavenet_train_state,
    make_optimizer,
    make_wavenet_train_step,
)

VARIANTS = {
    "plain": {},
    "ar_input_dropout": {"ar_input_dropout": 0.3},
    # a fast usage EMA, so that codes fall under the threshold and are
    # re-seeded within the three steps
    "revival": {"codebook_revival": True, "revival_threshold": 0.1,
                "revival_usage_decay": 0.5},
    "bf16_decoder": {"compute_dtype": "bfloat16", "use_jitter": True},
}
TOL = {"f32": dict(metrics=1e-5, params=2e-6),
       "bf16": dict(metrics=1e-4, params=6 * WN_CFG["learning_rate"])}


def jax_step_draws(rng, cfg, wcfg):
    """What one JAX WaveNet step draws from ``state.rng``: (ar_keep,
    jitter, dropout masks, revival perm)."""
    rng, sub = jax.random.split(rng)
    ar_keep = None
    if cfg.get("ar_input_dropout"):
        sub, dkey = jax.random.split(sub)
        ar_keep = torch.from_numpy(np.array(jax.random.bernoulli(
            dkey, 1.0 - cfg["ar_input_dropout"], (B, cfg["length"]))))
    jitter, masks = jax_decoder_draws(sub, cfg, wcfg, cfg["length"])
    perm = None
    if cfg.get("codebook_revival"):
        _, rev_key = jax.random.split(rng)
        perm = torch.from_numpy(np.array(
            jax.random.permutation(rev_key, B * T_LAT)))
    return dict(ar_keep=ar_keep, jitter_masks=jitter, dropout_masks=masks,
                revival_perm=perm)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_steps_follow_jax(variant):
    cfg = dict(WN_CFG, **VARIANTS[variant])
    params, state, wcfg, model = both_models(cfg)
    joptimizer = optax.amsgrad(cfg["learning_rate"])
    jstate = jwt.WaveNetTrainState(params, state, joptimizer.init(params),
                                   jax.random.PRNGKey(11))
    dtype = jnp.bfloat16 if cfg.get("compute_dtype") else None
    jstep = jwt.make_wavenet_train_step(cfg, wcfg, joptimizer,
                                        use_pallas=False, compute_dtype=dtype)
    optimizer = make_optimizer(cfg["learning_rate"])
    tstate = create_wavenet_train_state(model, optimizer, device="cpu")
    tstep = make_wavenet_train_step(cfg, model.decoder.cfg, optimizer)
    tol = TOL["bf16" if dtype else "f32"]
    revived = 0.0
    for i in range(3):
        batch = batch_arrays(cfg, seed=i)
        draws = jax_step_draws(jstate.rng, cfg, wcfg)
        jstate, want = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, got = tstep(tstate, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, **draws)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].item(), float(want[name]),
                                       rtol=tol["metrics"], atol=1e-7,
                                       err_msg=f"step {i} {name}")
        revived += float(want.get("revived_codes", 0.0))
    assert tstate.opt_state.count == 3
    got_params, got_state = export_jax_params(tstate.model)
    got = dict(jax.tree_util.tree_flatten_with_path(got_params)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(
        numpy_tree(jstate.params))[0])
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, rtol=0,
                                   atol=tol["params"],
                                   err_msg=jax.tree_util.keystr(path))
    diffs = np.concatenate([np.abs(got[p] - v).ravel()
                            for p, v in want.items()])
    assert (diffs > 5e-5).mean() <= (0.02 if dtype else 0.0)
    if cfg.get("codebook_revival"):
        assert revived > 0
        np.testing.assert_allclose(
            got_state["revival"]["usage"],
            np.asarray(jstate.model_state["revival"]["usage"]), rtol=1e-5,
            atol=1e-7)
