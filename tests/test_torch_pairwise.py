"""PyTorch port: ``ops/pairwise.py`` (the evaluator's pairwise distances)
against the JAX package's ``ops/pairwise.py`` on the same f32 inputs,
within rtol 1e-5 / atol 1e-5 (the same f32 expression in another framework),
and in itertools order: ``pdist`` is ``combinations`` (upper triangle,
row-major), ``cdist`` raveled is ``product`` (PARITY #9)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.ops import pairwise as jpairwise
from vqvae_speech_tpu_torch.ops import pairwise as tpairwise


@pytest.mark.parametrize("n, m, d", [(7, 4, 5), (24, 44, 64), (1, 3, 8)])
def test_pairwise_matches_jax(n, m, d):
    rng = np.random.default_rng(n * 100 + m)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    got_c = tpairwise.cdist(torch.from_numpy(x), torch.from_numpy(y))
    want_c = jpairwise.cdist(jnp.asarray(x), jnp.asarray(y))
    assert got_c.shape == (n, m) and got_c.dtype == torch.float32
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    got_p = tpairwise.pdist(torch.from_numpy(x))
    want_p = jpairwise.pdist(jnp.asarray(x))
    assert got_p.shape == (n * (n - 1) // 2,)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-5)


def test_pairwise_is_in_itertools_order():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    y = rng.standard_normal((4, 5)).astype(np.float32)
    got = tpairwise.pdist(torch.from_numpy(x)).numpy()
    want = [np.linalg.norm(a - b) for a, b in itertools.combinations(x, r=2)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got_c = tpairwise.cdist(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want_c = [np.linalg.norm(a - b) for a, b in itertools.product(x, y)]
    np.testing.assert_allclose(got_c.ravel(), want_c, rtol=1e-4, atol=1e-5)


def test_coincident_rows_give_zero_not_nan():
    x = torch.ones(3, 4)
    assert torch.equal(tpairwise.pdist(x), torch.zeros(3))
