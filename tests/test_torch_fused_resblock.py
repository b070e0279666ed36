"""PyTorch port: the plain fused-chain versions (ops/fused_resblock.py)
against the JAX package's Pallas kernels in interpret mode, and against the
port's own resblock stack, on the same parameters and inputs.

Tolerance: rtol/atol 2e-5, the bound the JAX package's own tests hold its
kernels to (tests/test_fused_resblock.py).

The CUDA kernel multiplies on the tensor cores in error-compensated TF32
(three TF32 products a f32 product). Its arithmetic has a plain twin,
``fused_block_chain_tf32_torch``; the tests below hold that twin to the same
JAX kernels within the same tolerance, show that ONE TF32 product a f32
product would not do, and pin the layout the kernel reads its weights in.
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


RAGGED = (20, 136, 12, 19)      # C, G, S, cin off every tile of the kernel


def chain(layers, k, T, seed, widths=(C, G, S, CIN)):
    """(numpy resblock trees, the port's resolved blocks, x (T, C),
    c (T, cin))."""
    rng = np.random.default_rng(seed)
    ch, gate, skip, cin = widths
    trees = [convert._resblock_tree(rng, ch, gate, skip, k, cin)
             for _ in range(layers)]
    blocks = [{n: convert._resolved_conv(p[n], "cpu") for n in p}
              for p in trees]
    x = rng.standard_normal((T, ch)).astype(np.float32)
    c = rng.standard_normal((T, cin)).astype(np.float32)
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


# ---- the kernel's arithmetic: error-compensated TF32 ----


def test_split_tf32_rounds_to_nearest_and_compensates():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(64) * 1e-30,
        [0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
         1.0 + 2.0 ** -12]]).astype(np.float32))
    hi, lo = fused.split_tf32(a)
    for part in (hi, lo):                 # TF32 values: 13 low bits clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # nearest: within half a TF32 unit (2^-11 relative); ties go away from 0
    assert bool(((a - hi).abs() <= a.abs() * 2.0 ** -11).all())
    assert hi[-3].item() == 1.0 + 2.0 ** -10
    assert hi[-2].item() == -(1.0 + 2.0 ** -10)
    assert hi[-1].item() == 1.0
    # hi + lo carries 21-22 bits of a
    assert bool(((a - (hi + lo)).abs() <= a.abs() * 2.0 ** -21).all())
    # a value that is a TF32 value already has no lo part
    again_hi, again_lo = fused.split_tf32(hi)
    assert torch.equal(again_hi, hi) and not bool(again_lo.any())


@pytest.mark.parametrize("which,layers,k,T,widths", [
    ("chain", 3, 3, 100, (C, G, S, CIN)),
    ("chain", 3, 2, 81, RAGGED),
    ("tiled", 4, 3, 176, (C, G, S, CIN)),
    ("tiled", 3, 3, 81, RAGGED),
    ("nc", 2, 3, 96, (C, G, S, CIN)),
    ("nc", 4, 3, 160, (C, G, S, CIN)),       # dilations 1, 2, 4, 8
    ("nc", 2, 3, 81, RAGGED),
])
def test_split_tf32_chain_matches_jax_kernels(which, layers, k, T, widths):
    """The chain with every product as hi@lo + lo@hi + hi@hi against the
    JAX package's Pallas kernels in interpret mode, within the tolerance
    the plain f32 chains are held to."""
    trees, blocks, x, c = chain(layers, k, T, seed=30 + layers + T, widths=widths)
    stacked = fused.stack_block_weights(blocks)
    jx, jc, js = jnp.asarray(x), jnp.asarray(c), jax_stacked(trees)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    if which == "nc":
        dil = tuple(2 ** i for i in range(layers))
        want = jax_fused.fused_block_chain_nc(
            jx, jc, js, layers=layers, kernel_size=k, dilations=dil, tile=32,
            interpret=True)
        got = fused.fused_block_chain_tf32_torch(xt, ct, stacked, layers, k,
                                                 dil, causal=False)
    elif which == "tiled":
        want = jax_fused.fused_block_chain_tiled(
            jx, jc, js, layers=layers, kernel_size=k, tile=64, interpret=True)
        got = fused.fused_block_chain_tf32_torch(xt, ct, stacked, layers, k)
    else:
        want = jax_fused.fused_block_chain(
            jx, jc, js, layers=layers, kernel_size=k, interpret=True)
        got = fused.fused_block_chain_tf32_torch(xt, ct, stacked, layers, k)
    assert_close(got, want)


def test_single_pass_tf32_is_not_enough():
    """Why the kernel takes three TF32 products a f32 product: at the IAF
    student's width one product (hi @ hi) is off the f32 chain by at least
    ten times what the split version is, and by more than the tolerance
    the kernel is held to on the card (rtol 1e-4, atol 2e-4)."""
    widths = (128, 256, 128, 80)
    _, blocks, x, c = chain(6, 3, 256, seed=40, widths=widths)
    stacked = fused.stack_block_weights(blocks)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    exact = fused.fused_block_chain_torch(
        xt.double(), ct.double(), {n: w.double() for n, w in stacked.items()},
        6, 3)
    errs = {}
    for passes in (1, 3):
        got = fused.fused_block_chain_tf32_torch(xt, ct, stacked, 6, 3,
                                                 passes=passes)
        errs[passes] = max(float((g.double() - w).abs().max())
                           for g, w in zip(got, exact))
    f32 = max(float((g.double() - w).abs().max()) for g, w in zip(
        fused.fused_block_chain_torch(xt, ct, stacked, 6, 3), exact))
    assert errs[1] >= 10 * errs[3], errs
    assert errs[1] > 2e-4, errs
    assert errs[3] <= 4 * f32 + 1e-6, (errs, f32)
    with pytest.raises(ValueError, match="passes must be 1 or 3"):
        fused.fused_block_chain_tf32_torch(xt, ct, stacked, 6, 3, passes=2)


@pytest.mark.parametrize("layers,k,widths", [(3, 3, (C, G, S, CIN)),
                                             (2, 2, RAGGED)])
def test_prepared_weight_layout(layers, k, widths):
    """The layout the kernel reads: reduction index contiguous, each tap and
    the conditioning padded to a multiple of 8 with zeros, hi + lo == w to
    f32 rounding, both parts TF32 values."""
    _, blocks, _, _ = chain(layers, k, 8, seed=50, widths=widths)
    stacked = fused.stack_block_weights(blocks)
    ch, gate, skip, cin = widths
    c8, cin8, g8 = -(-ch // 8) * 8, -(-cin // 8) * 8, -(-gate // 8) * 8
    prepared = fused.prepared_chain_weights_torch(stacked)
    assert prepared["wgate"].shape == (2, layers, 2 * gate, k * c8 + cin8)
    assert prepared["wproj"].shape == (2, layers, ch + skip, g8)
    for part in prepared.values():
        assert part.is_contiguous()
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    wgate = prepared["wgate"].sum(0)
    wproj = prepared["wproj"].sum(0)
    for j in range(k):
        tap = wgate[:, :, j * c8:(j + 1) * c8]
        np.testing.assert_allclose(tap[:, :gate, :ch].numpy(),
                                   stacked["wf"][:, j].transpose(1, 2).numpy(),
                                   rtol=2.0 ** -21, atol=0)
        np.testing.assert_allclose(tap[:, gate:, :ch].numpy(),
                                   stacked["wg"][:, j].transpose(1, 2).numpy(),
                                   rtol=2.0 ** -21, atol=0)
        assert not bool(tap[:, :, ch:].any())
    cond = wgate[:, :, k * c8:]
    np.testing.assert_allclose(cond[:, :gate, :cin].numpy(),
                               stacked["wfc"].transpose(1, 2).numpy(),
                               rtol=2.0 ** -21, atol=0)
    np.testing.assert_allclose(cond[:, gate:, :cin].numpy(),
                               stacked["wgc"].transpose(1, 2).numpy(),
                               rtol=2.0 ** -21, atol=0)
    assert not bool(cond[:, :, cin:].any())
    np.testing.assert_allclose(wproj[:, :ch, :gate].numpy(),
                               stacked["wres"].transpose(1, 2).numpy(),
                               rtol=2.0 ** -21, atol=0)
    np.testing.assert_allclose(wproj[:, ch:, :gate].numpy(),
                               stacked["wskip"].transpose(1, 2).numpy(),
                               rtol=2.0 ** -21, atol=0)
    assert not bool(wproj[:, :, gate:].any())


def test_prepare_block_chain_on_the_cpu_is_the_stacked_weights():
    """Only CUDA weights are bound to the kernel; the dispatching functions
    take what prepare_block_chain returns either way."""
    _, blocks, x, c = chain(3, 3, 40, seed=60)
    stacked = fused.stack_block_weights(blocks)
    prepared = fused.prepare_block_chain(stacked)
    assert prepared is stacked
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    for g, w in zip(fused.fused_block_chain_tiled(xt, ct, prepared, 3, 3),
                    fused.fused_block_chain_tiled_torch(xt, ct, stacked, 3, 3)):
        assert torch.equal(g, w)
