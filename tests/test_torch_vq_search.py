"""PyTorch port: codebook search against the JAX package's Pallas kernel.

The JAX side runs its Pallas kernel in TPU interpret mode on the CPU (the
idiom of tests/test_vq.py); the port's CPU path is the plain PyTorch chain.
The CUDA kernel itself is held to the plain chain on the card by
tests/test_torch_vq_kernel.py, which imports no JAX.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vqvae_speech_tpu.ops.vq import _vq_search_pallas_fwd, vq_search_pallas
from vqvae_speech_tpu_torch.ops import vq_search, vq_search_torch
from vqvae_speech_tpu_torch.ops.vq import reference_flatten, reference_unflatten


@pytest.mark.parametrize("N,K", [(96, 44), (600, 128), (48, 29)])
def test_plain_search_matches_pallas_interpret(N, K):
    """Indices and counts exact; quantized within 1e-5; dw within 1e-4."""
    rng = np.random.default_rng(2)
    flat = rng.standard_normal((N, 64)).astype(np.float32)
    cb = rng.standard_normal((K, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _vq_search_pallas_fwd(jnp.asarray(flat), jnp.asarray(cb),
                                     tile_n=256)
    got = vq_search_torch(torch.from_numpy(flat), torch.from_numpy(cb))
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.dw.numpy(), np.asarray(want.dw),
                               rtol=1e-4, atol=1e-4)


def test_autograd_function_matches_pallas_vjp():
    """The port's custom backward equals the JAX custom VJP (interpret mode)
    on a loss that touches every differentiable output."""
    rng = np.random.default_rng(7)
    flat = rng.standard_normal((72, 16)).astype(np.float32)
    cb = rng.standard_normal((11, 16)).astype(np.float32)

    def jax_loss(f, c):
        res = vq_search_pallas(f, c)
        return (jnp.sum(jnp.square(res.quantized))
                + 0.5 * jnp.sum(res.dw * res.dw) + jnp.sum(res.counts))

    with pltpu.force_tpu_interpret_mode():
        want_val, (want_gf, want_gc) = jax.value_and_grad(
            jax_loss, argnums=(0, 1))(jnp.asarray(flat), jnp.asarray(cb))

    tf = torch.from_numpy(flat).requires_grad_()
    tc = torch.from_numpy(cb).requires_grad_()
    res = vq_search(tf, tc)
    loss = (res.quantized.square().sum() + 0.5 * (res.dw * res.dw).sum()
            + res.counts.sum())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_val), rtol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_gf),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want_gc),
                               rtol=1e-4, atol=1e-5)


def test_reference_flatten_is_the_reference_view():
    """The port's flatten is the reference's literal permute(1, 2, 0) view of
    (B, C, T), and unflatten inverts it."""
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((3, 8, 10)).astype(np.float32))
    flat = reference_flatten(z)
    np.testing.assert_array_equal(
        flat.numpy(), z.permute(1, 2, 0).contiguous().view(-1, 8).numpy())
    np.testing.assert_array_equal(reference_unflatten(flat, 3, 8, 10).numpy(),
                                  z.numpy())
