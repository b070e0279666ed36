"""PyTorch port: the ClariNet losses (``models/clarinet/loss.py``) against
the JAX package's, on the same seeded numpy inputs.

Tolerances: elementwise functions rtol 1e-6 (f32, the same formulas; a
sample near zero, a sum that cancels, atol 2e-7);
means and the STFT magnitude rtol 1e-5 (rfft and reductions in another
order); the frame loss's gradient within 1e-5 of its largest element (the
first frames are all padding: |rfft(0)| has a zero gradient in both
packages). JAX runs with x64 off, as the JAX package runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vocoder_train import one_torch_thread  # noqa: F401
from vqvae_speech_tpu.models.clarinet import loss as jax_loss
from vqvae_speech_tpu_torch.models.clarinet import loss


def draws(*shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def both(fn_jax, fn_port, *arrays, **kw):
    with jax.enable_x64(False):
        want = fn_jax(*map(jnp.asarray, arrays), **kw)
    got = fn_port(*map(torch.from_numpy, arrays), **kw)
    return got, want


def test_gaussian_loss():
    y_hat, y = draws((2, 300, 2), (2, 300, 1))
    y_hat[..., 1] = 4 * y_hat[..., 1] - 5      # some log_std below -7
    assert (y_hat[..., 1] < -7).any()
    got, want = both(jax_loss.gaussian_loss, loss.gaussian_loss, y_hat, y)
    assert got.shape == (2, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sample_from_gaussian_on_fed_noise():
    """JAX draws inside (``normal(key, mean.shape)``); the port takes the
    same draws through ``noise=`` and clips to the same band."""
    (y_hat,) = draws((2, 300, 2))
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(False):
        want = jax_loss.sample_from_gaussian(key, jnp.asarray(y_hat),
                                             scale_factor=0.8)
        noise = np.array(jax.random.normal(key, (2, 300, 1)))
    got = loss.sample_from_gaussian(torch.from_numpy(y_hat), scale_factor=0.8,
                                    noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=2e-7)
    assert got.abs().max() == pytest.approx(0.8)
    drawn = loss.sample_from_gaussian(torch.from_numpy(y_hat),
                                      generator=torch.Generator()
                                      .manual_seed(0))
    again = loss.sample_from_gaussian(torch.from_numpy(y_hat),
                                      generator=torch.Generator()
                                      .manual_seed(0))
    assert drawn.shape == (2, 300, 1) and torch.equal(drawn, again)


@pytest.mark.parametrize("regularization", [True, False])
def test_kl_gaussians_and_kl_loss(regularization):
    mu_q, logs_q, mu_p, logs_p = draws((2, 99, 1), (2, 99, 1), (2, 99, 1),
                                       (2, 99, 1), seed=1)
    logs_q[0, :5] = -9.0                        # below log_std_min
    arrays = (mu_q, logs_q, mu_p, logs_p)
    got, want = both(jax_loss.kl_gaussians, loss.kl_gaussians, *arrays,
                     regularization=regularization)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    if regularization:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
    else:
        assert got[1] is None and want[1] is None
    got, want = both(jax_loss.kl_loss, loss.kl_loss, *arrays,
                     regularization=regularization)
    for g, w in zip(got, want):
        assert g.dim() == 0
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("filter_length,hop_length", [(1024, 256), (64, 16)])
def test_stft_magnitude(filter_length, hop_length):
    (x,) = draws((2, 3000), seed=2, scale=0.3)
    got, want = both(jax_loss.stft_magnitude, loss.stft_magnitude, x,
                     filter_length=filter_length, hop_length=hop_length)
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_stft_frame_loss_and_its_gradient():
    xs, xt = draws((2, 2047), (2, 2047), seed=3, scale=0.3)
    with jax.enable_x64(False):
        want, want_grad = jax.value_and_grad(jax_loss.stft_frame_loss)(
            jnp.asarray(xs), jnp.asarray(xt))
    s = torch.from_numpy(xs).requires_grad_(True)
    got = loss.stft_frame_loss(s, torch.from_numpy(xt))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    assert np.isfinite(s.grad.numpy()).all()
    np.testing.assert_allclose(s.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())
