"""PyTorch port: the FloWaveNet reverse pass against the JAX package, on the
same numpy parameters (non-zero zero convs, non-trivial ActNorms), noise and
mel. The JAX side's ``use_fused`` runs its Pallas non-causal chain kernel in
interpret mode.

Tolerance: atol 1e-5 (a few dozen small f32 conv layers and affine
couplings, in another summation order).

At bf16 a coupling net, run by JAX op by op, is bit-equal to the port's.
The JAX reverse pass runs each block's flows inside ``lax.scan``, whose body
XLA compiles and fuses, keeping f32 between fused bf16 ops where the port
rounds after each: measured over three seeds, 10-20% of the samples differ,
by at most 0.0098 of the wave's peak and 0.00028 of it on average. Held to
2^-5 (0.031) and 2^-10 (0.00098) of the peak.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models.flowavenet import model as jax_flow
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models.flowavenet import model as flow

ATOL = 1e-5
SMALL = dict(cin_channel=8, n_block=3, n_flow=2, n_layer=2,
             block_per_split=3, filter_size=16, upsample_scales=(4, 4))
SPLIT = dict(SMALL, n_block=4, block_per_split=2)   # a split after block 1


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def model(kw, seed=0):
    cfg = flow.FlowavenetConfig(**kw)
    tree = convert.numpy_flowavenet_params(cfg, seed)
    return (tree, convert.load_flowavenet_params(tree, cfg, "cpu"), cfg,
            jax_flow.FlowavenetConfig(**dataclasses.asdict(cfg)))


def inputs(B, frames, cfg, seed):
    rng = np.random.default_rng(seed)
    T = frames * int(np.prod(cfg.upsample_scales))
    return ((0.8 * rng.standard_normal((B, T, 1))).astype(np.float32),
            rng.random((B, frames, cfg.cin_channel)).astype(np.float32))


@pytest.mark.parametrize("shape", [(1, 8, 1), (2, 16, 3), (3, 32, 8)])
def test_squeeze_and_unsqueeze_are_bit_equal(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    sq = flow._squeeze(torch.from_numpy(x))
    np.testing.assert_array_equal(sq.numpy(),
                                  np.asarray(jax_flow._squeeze(jnp.asarray(x))))
    assert torch.equal(flow._unsqueeze(sq), torch.from_numpy(x))
    np.testing.assert_array_equal(
        flow._unsqueeze(torch.from_numpy(x.reshape(shape[0], shape[1] // 2,
                                                   -1))).numpy(),
        np.asarray(jax_flow._unsqueeze(jnp.asarray(
            x.reshape(shape[0], shape[1] // 2, -1)))))


def test_block_channels_and_splits_match_jax():
    for kw in (SMALL, SPLIT, dict()):
        cfg, jcfg = flow.FlowavenetConfig(**kw), jax_flow.FlowavenetConfig(**kw)
        assert flow._block_channels(cfg) == jax_flow._block_channels(jcfg)
        assert ([cfg.split_at(i) for i in range(cfg.n_block)]
                == [jcfg.split_at(i) for i in range(cfg.n_block)])
    assert flow.FlowavenetConfig(**SPLIT).split_at(1)


@pytest.mark.parametrize("use_fused", [False, True])
def test_coupling_net_matches_jax(use_fused):
    cfg = flow.CouplingNetConfig(in_channels=2, out_channels=4, num_layers=2,
                                 residual_channels=16, gate_channels=16,
                                 skip_channels=16, cin_channels=6)
    jcfg = jax_flow.CouplingNetConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    tree = convert._coupling_net_tree(rng, cfg)
    params = convert._load_coupling_net(tree, cfg, "cpu")
    B = 1 if use_fused else 2
    x = rng.standard_normal((B, 37, 2)).astype(np.float32)
    c = rng.standard_normal((B, 37, 6)).astype(np.float32)
    want = jax_flow.coupling_net_apply(as_jax(tree), jcfg, jnp.asarray(x),
                                       jnp.asarray(c), use_fused=use_fused,
                                       interpret=True, fused_tile=16)
    got = flow.coupling_net_apply(params, cfg, torch.from_numpy(x),
                                  torch.from_numpy(c), use_fused=use_fused)
    assert tuple(got.shape) == want.shape == (B, 37, 4)
    assert float(got.abs().max()) > 1e-3        # the zero conv is not zero
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kw,use_fused,B", [
    (SMALL, False, 2), (SMALL, True, 1), (SPLIT, False, 2), (SPLIT, True, 1)])
def test_reverse_matches_jax(kw, use_fused, B):
    tree, params, cfg, jcfg = model(kw)
    z, mel = inputs(B, 8, cfg, seed=B)
    want = jax_flow.flowavenet_reverse(
        as_jax(tree), jcfg, jnp.asarray(z), jnp.asarray(mel),
        use_fused=use_fused, interpret=True)
    got = flow.flowavenet_reverse(params, cfg, torch.from_numpy(z),
                                  torch.from_numpy(mel), use_fused=use_fused)
    assert tuple(got.shape) == want.shape == z.shape
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the couplings really transform the noise
    assert float((got - torch.from_numpy(z)).abs().max()) > 0.05


def test_reverse_takes_upsampled_conditioning_as_is():
    tree, params, cfg, _ = model(SMALL, seed=2)
    z, mel = inputs(1, 8, cfg, seed=3)
    c_up = flow.flowavenet_upsample(params, torch.from_numpy(mel), cfg)
    assert c_up.shape[1] == z.shape[1]
    a = flow.flowavenet_reverse(params, cfg, torch.from_numpy(z),
                                torch.from_numpy(mel))
    b = flow.flowavenet_reverse(params, cfg, torch.from_numpy(z), c_up)
    assert torch.equal(a, b)


def test_fused_reverse_equals_plain_and_is_f32_only():
    _, params, cfg, _ = model(SPLIT, seed=4)
    z, mel = inputs(1, 8, cfg, seed=5)
    zt, mt = torch.from_numpy(z), torch.from_numpy(mel)
    plain = flow.flowavenet_reverse(params, cfg, zt, mt)
    fused = flow.flowavenet_reverse(params, cfg, zt, mt, use_fused=True)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="compute_dtype"):
        flow.flowavenet_reverse(params, cfg, zt, mt,
                                compute_dtype=torch.float16)
    net = params["blocks"][0]["flows"][0]["coupling"]
    net_cfg = flow._flow_net_cfg(cfg, 2, 16)
    with pytest.raises(ValueError, match="batch-1"):
        flow.coupling_net_apply(net, net_cfg, torch.zeros(2, 8, 1),
                                torch.zeros(2, 8, 8), use_fused=True)
    # the whole reverse pass refuses too: it never drops the flag
    z2, mel2 = inputs(2, 8, cfg, seed=6)
    with pytest.raises(ValueError, match="batch-1"):
        flow.flowavenet_reverse(params, cfg, torch.from_numpy(z2),
                                torch.from_numpy(mel2), use_fused=True)


def test_loader_refuses_a_tree_of_another_shape():
    tree, _, cfg, _ = model(SMALL)
    with pytest.raises(ValueError, match="blocks in the params"):
        convert.load_flowavenet_params(
            tree, dataclasses.replace(cfg, n_block=4), "cpu")
    with pytest.raises(ValueError, match="block 0 of the params"):
        convert.load_flowavenet_params(
            tree, dataclasses.replace(cfg, n_flow=3), "cpu")


# ---- bf16 ----

BF16 = torch.bfloat16


@pytest.mark.parametrize("use_fused", [False, True])
def test_bf16_coupling_net_matches_jax_bit_for_bit(use_fused):
    """Outside a scan JAX runs the net op by op, and the port's rounding
    follows it op by op: the same bits, plain and fused."""
    cfg = flow.CouplingNetConfig(in_channels=2, out_channels=4, num_layers=2,
                                 residual_channels=16, gate_channels=16,
                                 skip_channels=16, cin_channels=6)
    jcfg = jax_flow.CouplingNetConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    tree = convert._coupling_net_tree(rng, cfg)
    params = convert._load_coupling_net(tree, cfg, "cpu", compute_dtype=BF16)
    B = 1 if use_fused else 2
    x = rng.standard_normal((B, 37, 2)).astype(np.float32)
    c = rng.standard_normal((B, 37, 6)).astype(np.float32)
    jtree = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    want = jax_flow.coupling_net_apply(
        jtree, jcfg, jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(c).astype(jnp.bfloat16), use_fused=use_fused,
        interpret=True, fused_tile=16)
    got = flow.coupling_net_apply(params, cfg, torch.from_numpy(x).to(BF16),
                                  torch.from_numpy(c).to(BF16),
                                  use_fused=use_fused)
    assert got.dtype == BF16 and float(got.float().abs().max()) > 1e-3
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("kw,use_fused,B,seed", [
    (SMALL, False, 2, 0), (SMALL, True, 1, 0), (SPLIT, False, 2, 1),
    (SPLIT, True, 1, 1)])
def test_bf16_reverse_matches_jax(kw, use_fused, B, seed):
    """flowavenet_reverse(compute_dtype=bf16) on a tree loaded at bf16
    against JAX's on the same numpy tree, noise and mel (JAX's fused blocks
    through its Pallas kernel in interpret mode; at this width JAX fuses
    every block too)."""
    tree, _, cfg, jcfg = model(kw, seed)
    params = convert.load_flowavenet_params(tree, cfg, "cpu",
                                            compute_dtype=BF16)
    z, mel = inputs(B, 8, cfg, seed=B + seed)
    want = np.asarray(jax_flow.flowavenet_reverse(
        as_jax(tree), jcfg, jnp.asarray(z), jnp.asarray(mel),
        compute_dtype=jnp.bfloat16, use_fused=use_fused, interpret=True))
    got = flow.flowavenet_reverse(params, cfg, torch.from_numpy(z),
                                  torch.from_numpy(mel), compute_dtype=BF16,
                                  use_fused=use_fused)
    assert got.dtype == torch.float32 and tuple(got.shape) == z.shape
    assert bool(torch.isfinite(got).all())
    got = got.numpy()
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 2.0 ** -5 * peak
    assert np.abs(got - want).mean() <= 2.0 ** -10 * peak
    f32 = flow.flowavenet_reverse(convert.load_flowavenet_params(
        tree, cfg, "cpu"), cfg, torch.from_numpy(z), torch.from_numpy(mel),
        use_fused=use_fused).numpy()
    assert np.abs(got - f32).max() > 1e-3          # really bf16
