"""PyTorch port: VectorQuantizer (gradient and EMA variants) against the
JAX package's ``vector_quantizer_apply(..., use_pallas=False)``.

Tolerances: indices and encodings exact; quantized, distances and the EMA
state within rtol 1e-5 / atol 1e-5 (the same f32 ops in another framework);
losses and perplexity within rtol 1e-5.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vqvae_speech_tpu.models.vq import vector_quantizer_apply
from vqvae_speech_tpu_torch.models import VectorQuantizer

B, T, D = 2, 24, 16


def _assert_same(got, want):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.encodings.numpy(),
                                  np.asarray(want.encodings))
    np.testing.assert_allclose(got.quantized.detach().numpy(),
                               np.asarray(want.quantized), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.distances.detach().numpy(),
                               np.asarray(want.distances), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.perplexity.item(), float(want.perplexity),
                               rtol=1e-5)
    assert set(got.losses) == set(want.losses)
    for name in want.losses:
        np.testing.assert_allclose(got.losses[name].item(),
                                   float(want.losses[name]), rtol=1e-5)


@pytest.mark.parametrize("training", [True, False])
def test_gradient_variant_matches_jax(training):
    rng = np.random.default_rng(3)
    K = 11
    z = rng.standard_normal((B, T, D)).astype(np.float32)
    cb = rng.uniform(-1 / K, 1 / K, (K, D)).astype(np.float32)
    vq = VectorQuantizer(K, D, commitment_cost=0.25).train(training)
    with torch.no_grad():
        vq.codebook.copy_(torch.from_numpy(cb))
    got = vq(torch.from_numpy(z.transpose(0, 2, 1).copy()))
    want = vector_quantizer_apply({"codebook": jnp.asarray(cb)}, {},
                                  jnp.asarray(z), commitment_cost=0.25,
                                  decay=0.0, training=training,
                                  use_pallas=False)
    _assert_same(got, want)
    assert got.new_state is None and want.new_state is None


@pytest.mark.parametrize("training", [True, False])
def test_ema_variant_matches_jax_over_three_steps(training):
    """Three calls: the EMA update runs before quantize, with Laplace
    smoothing after the decay; in eval the state stays frozen."""
    rng = np.random.default_rng(4)
    K, decay = 29, 0.99
    state = {"codebook": rng.standard_normal((K, D)).astype(np.float32),
             "ema_cluster_size": np.zeros(K, np.float32),
             "ema_w": rng.standard_normal((K, D)).astype(np.float32)}
    vq = VectorQuantizer(K, D, commitment_cost=0.25, decay=decay)
    vq.train(training)
    for name, value in state.items():
        getattr(vq, name).copy_(torch.from_numpy(value))
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    for _ in range(3):
        z = rng.standard_normal((B, T, D)).astype(np.float32)
        got = vq(torch.from_numpy(z.transpose(0, 2, 1).copy()))
        want = vector_quantizer_apply({}, jstate, jnp.asarray(z),
                                      commitment_cost=0.25, decay=decay,
                                      training=training, use_pallas=False)
        _assert_same(got, want)
        jstate = want.new_state
        for name in state:
            np.testing.assert_allclose(got.new_state[name].numpy(),
                                       np.asarray(jstate[name]),
                                       rtol=1e-5, atol=1e-5)
    if not training:
        np.testing.assert_array_equal(vq.codebook.numpy(), state["codebook"])


def test_straight_through_and_codebook_gradient():
    """d(sum 2*q_st)/dz is the identity path (plus the commitment term), and
    the gradient-variant codebook receives the q-latent gradient."""
    rng = np.random.default_rng(5)
    K = 16
    vq = VectorQuantizer(K, D, commitment_cost=0.25)
    z = torch.from_numpy(rng.standard_normal((B, D, 8)).astype(np.float32))
    z.requires_grad_()
    out = vq(z)
    (out.quantized.sum() * 2.0 + out.vq_loss).backward()
    assert bool(((z.grad - 2.0).abs() < 1.0).all())
    assert bool((vq.codebook.grad != 0).any())
