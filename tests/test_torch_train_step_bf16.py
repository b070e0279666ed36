"""PyTorch port: the flagship's train step at ``compute_dtype: bfloat16``
against the JAX package's, through the Pallas codebook search.

The JAX step's bf16 semantics for the search are the Pallas path's: the
trainer's docstring promises f32 distances (``train/trainer.py:72-74``),
and ``_vq_search_pallas_fwd`` upcasts the bf16 latents and codebook to f32
(``ops/vq.py:172``). The port feeds K1 f32 copies of the bf16-rounded rows,
the same computation. JAX's own bf16 step with ``use_pallas=True`` cannot
take a gradient: its custom VJP returns f32 cotangents for the bf16 primals
and ``jax.grad`` stops on the dtype mismatch. So the JAX side here runs the
Pallas kernel (in interpret mode, as tests/test_vq.py runs it) behind an
explicit f32 cast of both inputs, ``vq_search_pallas(flat.astype(f32),
codebook.astype(f32))``, patched in for the test only: the same forward,
and the cast's transpose hands the cotangents back in bf16. Below
``_PALLAS_MIN_ROWS`` and on the CPU the JAX step would take the XLA
search, whose distances are bf16 (``ops/vq.py:69-76``): a deviation of the
JAX package from its own docstring that the port does not copy.

Three steps, gradient and EMA quantizer, from the same tree on the same
batches with JAX's jitter draws. Tolerances, from the spread measured over
three seeds of each (the largest, in brackets): the bf16-valued metrics
(the VQ terms and perplexity) rtol 2**-6, two bf16 ulps (6.4e-03); the f32
reconstruction loss and total rtol 1e-3 (2.1e-04); parameters every
element within 6 lr (5.2e-04) and at most 2% of them further apart than
5e-5 (0.5%); the EMA statistics rtol 1e-3 + atol 1e-3 (ema_w 3.5e-04 at
|ema_w| ~3; every EMA statistic within a quarter of its bound). Each
step's code indices equal JAX's except near-ties: rows whose two candidate
codes' f32 distances are within 2% of ||z||^2 + 1 (the bf16 latents of the
two frameworks differ by a few ulps), at most one of the 96 rows a step;
JAX's codes there are its latents searched as the kernel searches them (in
numpy: eager Pallas calls in interpret mode are left to the jitted step).
Measured: no row differed at any step of the three seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import vqvae_speech_tpu.models.vq as jax_vq
from tests.test_torch_train_step import (
    B,
    CFG,
    T_LAT,
    VARIANTS,
    batches,
    both_sides,
    jax_batch,
    jax_step_draws,
    numpy_tree,
    torch_batch,
)
from vqvae_speech_tpu.models.encoder import convolutional_encoder_apply
from vqvae_speech_tpu.nn import conv1d
from vqvae_speech_tpu.ops.vq import reference_flatten, vq_search_pallas
from vqvae_speech_tpu_torch.convert import export_jax_params
from vqvae_speech_tpu_torch.nn.cast import cast_call
from vqvae_speech_tpu_torch.ops.vq import reference_flatten as port_flatten
from vqvae_speech_tpu_torch.ops.vq import vq_distances

BF16_ULPS2 = 2.0 ** -6
NEAR_TIE = 2e-2


def pallas_f32(flat, codebook, use_pallas=None):
    return vq_search_pallas(flat.astype(jnp.float32),
                            codebook.astype(jnp.float32))


@jax.jit
def _jax_bf16_latents(params, x):
    """The JAX step's bf16 pre-VQ latents (``conv_vqvae_encode``'s first two
    ops on the cast tree), jitted as the step is."""
    params = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), params)
    z = convolutional_encoder_apply(params["encoder"],
                                    x.astype(jnp.bfloat16),
                                    CFG["num_residual_layers"])
    return conv1d(params["pre_vq_conv"], z, padding=1)


def _pallas_search(flat, codebook):
    """The Pallas kernel's search on these rows, in numpy: f32 distances
    ``||z||^2 + ||e||^2 - 2 z.e`` of the f32 rows, argmin (first index on
    ties)."""
    d = (np.square(flat).sum(1, keepdims=True) + np.square(codebook).sum(1)
         - 2.0 * flat @ codebook.T)
    return d.argmin(1), d


def count_near_ties(jstate, model, batch, cfg):
    """Both packages' codes of ``batch`` on their current parameters at bf16:
    JAX's latents searched as its Pallas kernel searches them, against the
    port's forward (K1's plain twin on the CPU). They must agree except at
    near-ties (see the module docstring); returns how many rows differ."""
    z = _jax_bf16_latents(jstate.params, jnp.asarray(batch["input_features"]))
    flat = np.asarray(reference_flatten(
        z, cfg["embedding_dim"]).astype(jnp.float32))
    codebook = (jstate.model_state["vq"]["codebook"] if model.vq.ema
                else jstate.params["vq"]["codebook"].astype(jnp.bfloat16))
    want, _ = _pallas_search(flat, np.asarray(codebook.astype(jnp.float32)))
    model.eval()        # no jitter, no EMA update
    with torch.no_grad():
        out = cast_call(model, torch.bfloat16, (torch.from_numpy(
            batch["input_features"]).to(torch.bfloat16),))
    model.train()
    got = out.encoding_indices[:, 0].numpy()
    diff = np.flatnonzero(got != want)
    if len(diff):
        flat = port_flatten(out.pre_vq_latents.transpose(1, 2),
                            cfg["embedding_dim"]).float()
        cb = model.vq.codebook.detach()
        if not model.vq.ema:        # the parameter is searched in bf16
            cb = cb.to(torch.bfloat16)
        d = vq_distances(flat, cb.float()).numpy()[diff]
        gap = np.abs(d[np.arange(len(diff)), got[diff]]
                     - d[np.arange(len(diff)), want[diff]])
        zz = np.square(flat.numpy()[diff]).sum(1)
        assert (gap <= NEAR_TIE * (zz + 1)).all(), (gap, zz)
    return len(diff)


@pytest.mark.parametrize("variant", ["jitter12", "ema"])
def test_three_bf16_steps_follow_jax_through_pallas(variant, monkeypatch):
    monkeypatch.setattr(jax_vq, "vq_search", pallas_f32)
    cfg = dict(CFG, **VARIANTS[variant], compute_dtype="bfloat16")
    jstate, jstep, tstate, tstep = both_sides(cfg, use_pallas=True)
    lr = cfg["learning_rate"]
    ties = 0
    for batch in batches(cfg, 3):
        masks, perm = jax_step_draws(jstate.rng, cfg, B * T_LAT)
        ties += count_near_ties(jstate, tstate.model, batch, cfg)
        with pltpu.force_tpu_interpret_mode():
            jstate, want = jstep(jstate, jax_batch(batch))
        tstate, got = tstep(tstate, torch_batch(batch), jitter_masks=masks,
                            revival_perm=perm)
        assert set(got) == set(want)
        for name in want:
            rtol = 1e-3 if name in ("reconstruction_loss", "loss") \
                else BF16_ULPS2
            assert got[name].dtype == torch.float32
            np.testing.assert_allclose(got[name].item(), float(want[name]),
                                       rtol=rtol, atol=1e-7, err_msg=name)
    assert ties <= 3
    params, state = export_jax_params(tstate.model)
    got = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(
        numpy_tree(jstate.params))[0])
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_allclose(got[path], value, rtol=0, atol=6 * lr,
                                   err_msg=jax.tree_util.keystr(path))
    diffs = np.concatenate([np.abs(got[p] - v).ravel()
                            for p, v in want.items()])
    assert (diffs > 5e-5).mean() <= 0.02
    for name, value in numpy_tree(jstate.model_state["vq"]).items():
        assert state["vq"][name].dtype == np.float32
        np.testing.assert_allclose(state["vq"][name], value, rtol=1e-3,
                                   atol=1e-3, err_msg=name)
