"""PyTorch port: the plain fused-chain versions (ops/fused_resblock.py)
against the JAX package's Pallas kernels in interpret mode, and against the
port's own resblock stack, on the same parameters and inputs.

Tolerance: rtol/atol 2e-5, the bound the JAX package's own tests hold its
kernels to (tests/test_fused_resblock.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.ops import fused_resblock as jax_fused
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models.clarinet.modules import resblock_apply
from vqvae_speech_tpu_torch.ops import fused_resblock as fused

TOL = dict(rtol=2e-5, atol=2e-5)
C, G, S, CIN = 16, 32, 16, 8


def chain(layers, k, T, seed):
    """(numpy resblock trees, the port's resolved blocks, x (T, C),
    c (T, cin))."""
    rng = np.random.default_rng(seed)
    trees = [convert._resblock_tree(rng, C, G, S, k, CIN)
             for _ in range(layers)]
    blocks = [{n: convert._resolved_conv(p[n], "cpu") for n in p}
              for p in trees]
    x = rng.standard_normal((T, C)).astype(np.float32)
    c = rng.standard_normal((T, CIN)).astype(np.float32)
    return trees, blocks, x, c


def jax_stacked(trees):
    return jax_fused.stack_block_weights(
        jax.tree_util.tree_map(jnp.asarray, trees), compute_dtype=jnp.float32)


def resblock_stack(blocks, x, c, k, dilations, causal):
    h, skip = torch.from_numpy(x)[None], 0.0
    for p, d in zip(blocks, dilations):
        h, s = resblock_apply(p, h, torch.from_numpy(c)[None], k, d, causal)
        skip = skip + s
    return h[0], skip[0]


def assert_close(got, want):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


def test_stacked_layout_matches_jax():
    trees, blocks, _, _ = chain(3, 3, 8, seed=0)
    want = jax_stacked(trees)
    got = fused.stack_block_weights(blocks)
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert got[name].is_contiguous()
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("layers,k,T", [(3, 3, 100), (3, 2, 77), (4, 3, 256)])
def test_causal_chain_matches_jax_kernel_and_resblocks(layers, k, T):
    trees, blocks, x, c = chain(layers, k, T, seed=layers + k)
    stacked = fused.stack_block_weights(blocks)
    want = jax_fused.fused_block_chain(
        jnp.asarray(x), jnp.asarray(c), jax_stacked(trees), layers=layers,
        kernel_size=k, interpret=True)
    got = fused.fused_block_chain_torch(
        torch.from_numpy(x), torch.from_numpy(c), stacked, layers, k)
    assert_close(got, want)
    assert_close(got, resblock_stack(blocks, x, c, k,
                                     [k ** l for l in range(layers)], True))
    # the dispatching wrapper takes the plain chain for a CPU tensor
    again = fused.fused_block_chain(
        torch.from_numpy(x), torch.from_numpy(c), stacked, layers, k)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("layers,k,tile,T", [(4, 3, 64, 176), (3, 2, 8, 45),
                                             (3, 3, 32, 100)])
def test_tiled_chain_matches_jax_tiled_kernel(layers, k, tile, T):
    """T is not a tile multiple, and the JAX kernel carries its tails
    across several tiles; the port's result depends on no tiling."""
    trees, blocks, x, c = chain(layers, k, T, seed=10 + layers + k)
    stacked = fused.stack_block_weights(blocks)
    want = jax_fused.fused_block_chain_tiled(
        jnp.asarray(x), jnp.asarray(c), jax_stacked(trees), layers=layers,
        kernel_size=k, tile=tile, interpret=True)
    got = fused.fused_block_chain_tiled_torch(
        torch.from_numpy(x), torch.from_numpy(c), stacked, layers, k)
    assert_close(got, want)
    again = fused.fused_block_chain_tiled(
        torch.from_numpy(x), torch.from_numpy(c), stacked, layers, k)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("dilations,tile,T", [
    ((1, 2), 32, 96), ((1, 2), 32, 83), ((1, 2), 64, 40),
    ((1, 2, 4, 8), 48, 160),                 # the deep-dilation case
    ((4, 1, 16), 32, 50)])
def test_nc_chain_matches_jax_kernel_and_resblocks(dilations, tile, T):
    layers, k = len(dilations), 3
    trees, blocks, x, c = chain(layers, k, T, seed=20 + layers + T)
    stacked = fused.stack_block_weights(blocks)
    want = jax_fused.fused_block_chain_nc(
        jnp.asarray(x), jnp.asarray(c), jax_stacked(trees), layers=layers,
        kernel_size=k, dilations=dilations, tile=tile, interpret=True)
    got = fused.fused_block_chain_nc_torch(
        torch.from_numpy(x), torch.from_numpy(c), stacked, layers, k,
        dilations)
    assert_close(got, want)
    assert_close(got, resblock_stack(blocks, x, c, k, dilations, False))
    again = fused.fused_block_chain_nc(
        torch.from_numpy(x), torch.from_numpy(c), stacked, layers, k,
        dilations)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_nc_chain_default_dilations_are_powers_of_k():
    trees, blocks, x, c = chain(2, 3, 40, seed=5)
    stacked = fused.stack_block_weights(blocks)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    got = fused.fused_block_chain_nc_torch(xt, ct, stacked, 2, 3)
    want = fused.fused_block_chain_nc_torch(xt, ct, stacked, 2, 3, (1, 3))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_chain_shorter_than_its_reach():
    """Taps that fall wholly outside [0, T) read zeros."""
    trees, blocks, x, c = chain(4, 3, 20, seed=6)     # lags up to 54 > T
    stacked = fused.stack_block_weights(blocks)
    got = fused.fused_block_chain_torch(
        torch.from_numpy(x), torch.from_numpy(c), stacked, 4, 3)
    assert_close(got, resblock_stack(blocks, x, c, 3, [1, 3, 9, 27], True))


def test_wrappers_refuse_mismatched_arguments():
    _, blocks, x, c = chain(3, 3, 16, seed=7)
    stacked = fused.stack_block_weights(blocks)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    with pytest.raises(ValueError, match="3 layers of kernel 3"):
        fused.fused_block_chain(xt, ct, stacked, layers=6, kernel_size=3)
    with pytest.raises(ValueError, match="3 layers of kernel 3"):
        fused.fused_block_chain_tiled(xt, ct, stacked, layers=3, kernel_size=2)
    with pytest.raises(ValueError, match="2 dilations for 3 layers"):
        fused.fused_block_chain_nc(xt, ct, stacked, layers=3, kernel_size=3,
                                   dilations=(1, 2))
