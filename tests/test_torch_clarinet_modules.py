"""PyTorch port: models/clarinet/modules.py against the JAX package on the
same weight-normed parameters and inputs (numpy seeds).

Tolerance: atol 1e-5 (f32 convolutions of at most 3 * 16 terms in another
summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models.clarinet import modules as jax_modules
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models.clarinet import modules

ATOL = 1e-5


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("k,d,causal,mode", [
    (3, 1, True, "SAME"), (3, 9, True, "SAME"), (2, 4, True, "SAME"),
    (3, 2, False, "SAME"), (5, 3, False, "SAME"), (1, 1, True, "SAME"),
    (8, 1, True, "SAME"), (3, 2, True, "VALID")])
def test_conv_apply_matches_jax(k, d, causal, mode):
    rng = np.random.default_rng(k * 10 + d)
    p = convert._clarinet_conv(rng, 6, 10, k)
    x = normal(rng, 2, 50, 6)
    want = np.asarray(jax_modules.conv_apply(as_jax(p), jnp.asarray(x), k, d,
                                             causal, mode))
    got = modules.conv_apply(convert._resolved_conv(p, "cpu"),
                             torch.from_numpy(x), k, d, causal, mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k,d,causal", [(3, 3, True), (2, 2, True),
                                        (3, 4, False)])
def test_resblock_apply_matches_jax(k, d, causal):
    rng = np.random.default_rng(k + d)
    p = convert._resblock_tree(rng, 8, 16, 12, k, 5)
    x, c = normal(rng, 2, 40, 8), normal(rng, 2, 40, 5)
    want = jax_modules.resblock_apply(as_jax(p), jnp.asarray(x),
                                      jnp.asarray(c), k, d, causal)
    tp = {n: convert._resolved_conv(p[n], "cpu") for n in p}
    got = modules.resblock_apply(tp, torch.from_numpy(x), torch.from_numpy(c),
                                 k, d, causal)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("scales,rows", [((2, 2), 7 * 4), ((4, 3), 7 * 12 + 1),
                                         ((16, 16), 7 * 256)])
def test_upsample_apply_matches_jax(scales, rows):
    """An asymmetric random kernel (a symmetric one would hide a missing
    frequency flip and the per-tensor weight norm), with a gain that is not
    the kernel's norm and a non-zero bias; one odd scale (T*s + 1 rows)."""
    rng = np.random.default_rng(sum(scales))
    stages = convert._upsample_tree(rng, scales)
    for p in stages:
        p["g"] = (p["g"] * 1.7).astype(np.float32)
        p["b"] = normal(rng, 1) * 0.1
    c = normal(rng, 2, 7, 5)
    want = np.asarray(jax_modules.upsample_apply(as_jax(stages),
                                                 jnp.asarray(c), scales))
    got = modules.upsample_apply(convert.load_upsample_params(stages, "cpu"),
                                 torch.from_numpy(c), scales).numpy()
    assert got.shape == want.shape == (2, rows, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
