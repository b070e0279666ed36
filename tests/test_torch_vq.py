"""PyTorch port: VectorQuantizer (gradient and EMA variants) against the
JAX package's ``vector_quantizer_apply(..., use_pallas=False)``.

Tolerances: indices and encodings exact; quantized, distances and the EMA
state within rtol 1e-5 / atol 1e-5 (the same f32 ops in another framework);
losses and perplexity within rtol 1e-5.
"""
from unittest import mock

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from vqvae_speech_tpu.models.vq import vector_quantizer_apply
from vqvae_speech_tpu_torch.models import VectorQuantizer
from vqvae_speech_tpu_torch.models import vq as vq_module
from vqvae_speech_tpu_torch.ops.vq import vq_search

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


@pytest.mark.parametrize("decay", [0.0, 0.99])
def test_training_forward_builds_no_n_by_k_tensor(decay):
    """A training forward (and its backward) calls neither ``vq_distances``
    nor ``F.one_hot`` and clones no codebook: with the search's precomputed
    result standing in for the kernel, every tensor the quantizer hands out
    is smaller than N x K. ``encodings`` and ``distances`` are
    built when first read, and match the eager ones."""
    rng = np.random.default_rng(6)
    K = 200
    vq = VectorQuantizer(K, D, commitment_cost=0.25, decay=decay).train()
    z = torch.from_numpy(rng.standard_normal((B, D, T)).astype(np.float32))
    z.requires_grad_()
    N = B * T
    assert N * K > max(z.numel(), K * D)
    codebook_before = vq.codebook.detach().clone()

    # the search's result for this very input, computed beforehand: the
    # stand-in for the kernel, which builds no (N, K) tensor either
    res = vq_search(z.permute(1, 2, 0).reshape(-1, D), vq.codebook)
    made = []
    real_clone = torch.Tensor.clone

    def watched_clone(self, *a, **kw):
        made.append(tuple(self.shape))
        return real_clone(self, *a, **kw)

    with mock.patch.object(vq_module, "vq_search", lambda flat, cb: res), \
            mock.patch.object(vq_module, "vq_distances") as distances, \
            mock.patch.object(torch.Tensor, "clone", watched_clone):
        # one_hot is patched around the forward only: the gradient variant's
        # backward rebuilds the one-hot for its codebook product, as JAX's does
        with mock.patch.object(F, "one_hot") as one_hot:
            out = vq(z)
            assert not one_hot.called
        (out.quantized.sum() + out.vq_loss).backward()
        assert not distances.called
    assert (K, D) not in made
    for value in vars(out).values():
        if isinstance(value, torch.Tensor):
            assert value.numel() < N * K

    # read afterwards, the lazy views are the eager ones of the same call
    assert out.encodings.shape == out.distances.shape == (B, T, K)
    flat = z.detach().permute(1, 2, 0).reshape(-1, D)
    want_d = (flat.square().sum(1, keepdim=True)
              + codebook_before.square().sum(1)
              - 2.0 * flat @ codebook_before.t())
    torch.testing.assert_close(out.distances.reshape(-1, K), want_d)
    assert torch.equal(out.encodings.reshape(-1, K).argmax(1),
                       out.indices[:, 0].long())
    assert torch.equal(out.encodings.sum((0, 1)), out.counts)
    assert out.encodings is out.encodings    # built once


def test_new_state_is_not_changed_by_the_next_step():
    """F2: step n's ``new_state``, kept across step n+1, still holds step
    n's values (JAX returns fresh arrays)."""
    rng = np.random.default_rng(8)
    K, decay = 13, 0.99
    state = {"codebook": rng.standard_normal((K, D)).astype(np.float32),
             "ema_cluster_size": np.zeros(K, np.float32),
             "ema_w": rng.standard_normal((K, D)).astype(np.float32)}
    vq = VectorQuantizer(K, D, commitment_cost=0.25, decay=decay).train()
    for name, value in state.items():
        getattr(vq, name).copy_(torch.from_numpy(value))
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    kept, jkept = [], []
    for _ in range(3):
        z = rng.standard_normal((B, T, D)).astype(np.float32)
        kept.append(vq(torch.from_numpy(z.transpose(0, 2, 1).copy())).new_state)
        jstate = vector_quantizer_apply({}, jstate, jnp.asarray(z),
                                        commitment_cost=0.25, decay=decay,
                                        training=True,
                                        use_pallas=False).new_state
        jkept.append(jstate)
    for got, want in zip(kept, jkept):
        for name in state:
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]),
                                       rtol=1e-5, atol=1e-5)
    assert not np.allclose(kept[0]["codebook"].numpy(),
                           kept[2]["codebook"].numpy())
    # the module's buffers are the newest state, and still buffers
    assert kept[2]["codebook"] is vq.codebook
    assert set(dict(vq.named_buffers())) == set(state)


def test_search_backward_skips_absent_gradients():
    """No zero ``g_dw`` is materialised: with only ``quantized`` in the loss
    the flat input gets no gradient from the search, and with only ``dw``
    the codebook gets none."""
    rng = np.random.default_rng(9)
    flat = torch.from_numpy(rng.standard_normal((40, D)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((7, D)).astype(np.float32))
    f, c = flat.clone().requires_grad_(), cb.clone().requires_grad_()
    vq_search(f, c).quantized.square().sum().backward()
    assert f.grad is None and c.grad is not None
    f, c = flat.clone().requires_grad_(), cb.clone().requires_grad_()
    res = vq_search(f, c)
    (res.dw * res.dw).sum().backward()
    assert c.grad is None
    torch.testing.assert_close(f.grad, 2 * res.dw.detach()[res.indices.long()])
