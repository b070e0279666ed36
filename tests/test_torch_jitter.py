"""PyTorch port: ``nn.layers.jitter`` against the JAX package's.

The JAX function draws its two masks from a key (``nn/layers.py:105-108``);
the test recomputes them from the same key splits and hands them to the port.
Values are copies of input frames, so every comparison is exact; gradients
are sums of ones and compared exactly too.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vqvae_speech_tpu.nn.layers import jitter as jax_jitter
from vqvae_speech_tpu_torch.nn import jitter, jitter_masks


def jax_masks(key, T, probability, inverted):
    k_rep, k_dir = jax.random.split(key)
    p_replace = (1.0 - probability) if inverted else probability
    replace = jax.random.bernoulli(k_rep, p_replace, (T,))
    direction = jnp.where(jax.random.bernoulli(k_dir, 0.5, (T,)), 1, -1)
    return (torch.from_numpy(np.array(replace)),
            torch.from_numpy(np.array(direction).astype(np.int64)))


@pytest.mark.parametrize("T", [1, 2, 3, 24])
@pytest.mark.parametrize("inverted", [True, False])
@pytest.mark.parametrize("detach", [True, False])
def test_values_and_gradients_match_jax(T, inverted, detach):
    """T=1 is the clamped-gather trap: JAX reads row 0 where a literal
    torch gather would raise."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((3, T, 5)).astype(np.float32)
    w = rng.standard_normal((3, T, 5)).astype(np.float32)
    key = jax.random.PRNGKey(11 + T)

    def f(xj):
        return jnp.sum(jax_jitter(key, xj, 0.3, inverted, detach) * w)

    want = jax_jitter(key, jnp.asarray(x), 0.3, inverted, detach)
    want_grad = jax.grad(f)(jnp.asarray(x))

    replace, direction = jax_masks(key, T, 0.3, inverted)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    got = jitter(xt, 0.3, inverted, detach, replace=replace,
                 direction=direction)
    (got * torch.from_numpy(w.transpose(0, 2, 1).copy())).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy().transpose(0, 2, 1),
                                  np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy().transpose(0, 2, 1),
                                  np.asarray(want_grad))


def test_detached_replacements_carry_no_gradient():
    """PARITY #34: a replaced frame reads the ORIGINAL tensor, detached; the
    live gather routes its gradient to the source frame instead."""
    x = torch.arange(12.0).reshape(1, 2, 6).requires_grad_()
    replace = torch.tensor([True, False, True, False, False, True])
    direction = torch.tensor([1, 1, -1, 1, -1, 1])
    out = jitter(x, replace=replace, direction=direction)
    # t=0 -> 1, t=2 -> 1, t=5 (last) -> 4
    assert out[0, 0].tolist() == [1.0, 1.0, 1.0, 3.0, 4.0, 4.0]
    out.sum().backward()
    assert x.grad[0, 0].tolist() == [0.0, 1.0, 0.0, 1.0, 1.0, 0.0]
    x.grad = None
    jitter(x, detach_replacements=False, replace=replace,
           direction=direction).sum().backward()
    assert x.grad[0, 0].tolist() == [0.0, 3.0, 0.0, 1.0, 2.0, 0.0]


def test_own_draws_are_shared_across_batch_and_channels():
    """One draw a timestep; ``inverted`` replaces with probability 1 - p
    (PARITY #5); the generator makes the draw reproducible."""
    T = 4000
    for inverted, rate in ((True, 0.88), (False, 0.12)):
        replace, direction = jitter_masks(
            T, 0.12, inverted, torch.Generator().manual_seed(0))
        assert replace.shape == direction.shape == (T,)
        assert abs(replace.float().mean().item() - rate) < 0.02
        assert set(direction.tolist()) == {-1, 1}
        assert abs(direction.float().mean().item()) < 0.06
    x = torch.randn(3, 4, 50)
    a = jitter(x, generator=torch.Generator().manual_seed(5))
    b = jitter(x, generator=torch.Generator().manual_seed(5))
    c = jitter(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # every (batch, channel) row took the same source frame per timestep
    src = (a[0, 0][:, None] == x[0, 0][None, :]).float().argmax(1)
    for bi in range(3):
        for ci in range(4):
            assert torch.equal(a[bi, ci], x[bi, ci][src])
