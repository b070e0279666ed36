"""PyTorch port: mu-law companding against the JAX package.

Bins must be bit-equal to JAX's (both compute in f32 with the same
``floor((y + 1) * mu / 2)`` binning and ``[-1, mu - 1]`` clip); the decode
within 1e-6 absolute (``mu ** |y|`` in two libraries' f32 pow).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.ops.mu_law import mu_law_decode as jax_decode
from vqvae_speech_tpu.ops.mu_law import mu_law_encode as jax_encode
from vqvae_speech_tpu_torch.ops import mu_law_decode, mu_law_encode


def waves(kind, n=8192, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "in_range":
        return rng.uniform(-1, 1, n).astype(np.float32)
    if kind == "speech_like":
        return (0.3 * np.sin(np.arange(n) / 7.0)
                + 0.01 * rng.standard_normal(n)).astype(np.float32)
    if kind == "edges":
        # every bin edge of the companded axis, pulled back through the
        # compander, and its float neighbours
        mu = 256
        y = 2 * np.arange(mu, dtype=np.float64) / mu - 1
        x = (np.sign(y) / mu * (mu ** np.abs(y) - 1)).astype(np.float32)
        x = np.concatenate([x, np.nextafter(x, np.float32(2)),
                            np.nextafter(x, np.float32(-2)),
                            np.float32([-1, 0, 1, 0.5, -0.5, -0.0])])
        return x.astype(np.float32)
    if kind == "out_of_range":
        return np.concatenate([rng.uniform(-4, 4, n),
                               [-1e3, 1e3, -1.0001, 1.0001]]).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["in_range", "speech_like", "edges",
                                  "out_of_range"])
@pytest.mark.parametrize("mu", [256, 64])
def test_encode_bins_equal_jax(kind, mu):
    x = waves(kind)
    want = np.asarray(jax_encode(jnp.asarray(x), mu))
    got = mu_law_encode(torch.from_numpy(x), mu)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= -1 and got.max() <= mu - 1


@pytest.mark.parametrize("mu", [256, 64])
def test_decode_matches_jax(mu):
    bins = np.arange(-1, mu, dtype=np.int32)
    want = np.asarray(jax_decode(jnp.asarray(bins), mu))
    got = mu_law_decode(torch.from_numpy(bins), mu)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_roundtrip_stays_within_a_bin():
    x = waves("in_range", seed=3)
    back = mu_law_decode(mu_law_encode(torch.from_numpy(x))).numpy()
    assert np.abs(back - x).max() < 0.05
    assert np.abs(back).max() <= 1.0
