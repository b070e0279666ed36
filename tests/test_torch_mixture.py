"""PyTorch port: the discretized mixture of logistics (models/wavenet/
mixture.py) against the JAX package's.

The loss: the same f32 formulas (softplus as logaddexp(x, 0), as
jax.nn.softplus computes it), on targets inside (-1, 1) and at both edges.
The reduced loss at 256 classes within 1e-6 relative of JAX's (measured:
equal). Per element, f32 itself limits the agreement: log(cdf_plus -
cdf_min) cancels, so a one-ulp difference in a sigmoid (torch's differs
from XLA's in 0.4% of elements) grows by up to 1 / cdf_delta; JAX's own f32
loss is up to 1.4e-5 (256 classes) and 2.7e-4 (65536) relative off the same
formula evaluated in float64. So per element (and reduced at 65536 classes)
the port is held to be as close to that float64 loss as JAX's f32 loss is,
and within twice JAX's distance to it of JAX. The sampler on JAX's own draws,
recomputed from its key splits (k_sel for the Gumbel-max mixture choice,
k_u for u): the component choice equal and the samples within 1e-6 (JAX's
u is f64 under the tests' x64, the port's f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models.wavenet import mixture as jax_mixture
from vqvae_speech_tpu_torch.models.wavenet import mixture


def mixture_output(B, T, nr_mix, seed):
    rng = np.random.default_rng(seed)
    y_hat = rng.standard_normal((B, T, 3 * nr_mix)).astype(np.float32)
    y_hat[..., 2 * nr_mix:] -= 2.0          # log scales around e^-2
    y = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
    y[:, :3, 0] = [-1.0, 1.0, 0.9995]       # both edges and one near
    return y_hat, y


@pytest.mark.parametrize("num_classes,log_scale_min", [(256, -7.0),
                                                       (65536, -9.0)])
def test_loss_matches_jax(num_classes, log_scale_min):
    y_hat, y = mixture_output(3, 40, 10, seed=0)
    for reduce in (True, False):
        def jax_loss(dtype):
            return np.asarray(jax_mixture.discretized_mix_logistic_loss(
                jnp.asarray(y_hat, dtype), jnp.asarray(y, dtype),
                num_classes, log_scale_min, reduce))

        want, exact = jax_loss(jnp.float32), jax_loss(jnp.float64)
        got = mixture.discretized_mix_logistic_loss(
            torch.from_numpy(y_hat), torch.from_numpy(y), num_classes,
            log_scale_min, reduce).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        if reduce and num_classes == 256:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        jax_err = np.abs(want - exact).max()
        assert np.abs(got - exact).max() <= jax_err
        assert np.abs(got - want).max() <= 2 * jax_err


def test_log_sum_exp_and_log_prob_match_jax():
    x = np.random.default_rng(1).standard_normal((4, 7, 10)).astype(
        np.float32) * 30
    for name in ("log_sum_exp", "log_prob_from_logits"):
        want = np.asarray(getattr(jax_mixture, name)(jnp.asarray(x)))
        got = getattr(mixture, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sampler_on_jax_draws_matches_jax():
    y_hat, _ = mixture_output(2, 50, 10, seed=2)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_mixture.sample_from_discretized_mix_logistic(
        key, jnp.asarray(y_hat), -7.0))
    k_sel, k_u = jax.random.split(key)
    gumbel = np.array(jax.random.gumbel(k_sel, (2, 50, 10), jnp.float32))
    u = np.array(jax.random.uniform(k_u, (2, 50), minval=1e-5,
                                    maxval=1.0 - 1e-5))
    got = mixture.sample_from_discretized_mix_logistic(
        torch.from_numpy(y_hat), -7.0, gumbel=torch.from_numpy(gumbel),
        u=torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() <= 1.0


def test_sampler_concentrates_on_a_sharp_component():
    """One sharp component at mean 0.5 (the JAX package's statistics test):
    2000 draws from a torch.Generator concentrate there."""
    y = torch.zeros(1, 2000, 9)
    y[..., 0] = 10.0
    y[..., 3] = 0.5
    y[..., 6] = -5.0
    gen = torch.Generator().manual_seed(0)
    s = mixture.sample_from_discretized_mix_logistic(y, generator=gen)
    assert abs(float(s.mean()) - 0.5) < 0.01 and float(s.std()) < 0.05
    again = mixture.sample_from_discretized_mix_logistic(
        y, generator=torch.Generator().manual_seed(0))
    assert torch.equal(s, again)


def test_draws_are_in_range_and_checked():
    gen = torch.Generator().manual_seed(3)
    u = mixture.logistic_uniform((100000,), gen)
    assert float(u.min()) >= 1e-5 and float(u.max()) < 1 - 1e-5
    g = mixture.gumbel_noise((100000,), gen)
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.02      # Euler's constant
    y = torch.zeros(1, 2, 9)
    with pytest.raises(ValueError, match="both"):
        mixture.sample_from_discretized_mix_logistic(y, u=torch.zeros(1, 2))
    with pytest.raises(ValueError, match="Generator"):
        mixture.sample_from_discretized_mix_logistic(y)
