"""PyTorch port: the ClariNet Gaussian WaveNet core and the IAF student
against the JAX package, on the same numpy parameters, noise and
conditioning. The JAX side's ``use_fused`` runs its Pallas chain kernel in
interpret mode.

Tolerance: atol 1e-5 (a dozen small f32 conv layers and exp() of small
log-scales, in another summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models import clarinet as jax_clarinet
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models import clarinet

ATOL = 1e-5
SMALL = dict(num_blocks_student=(1, 2), num_layers=3, front_channels=8,
             residual_channels=16, gate_channels=32, skip_channels=16,
             kernel_size=3, cin_channels=8)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def student(kw=SMALL, seed=0):
    cfg = clarinet.StudentConfig(**kw)
    tree = convert.numpy_student_params(cfg, seed)
    return (tree, convert.load_student_params(tree, cfg, "cpu"), cfg,
            jax_clarinet.StudentConfig(**dataclasses.asdict(cfg)))


def inputs(B, T, cin, seed):
    rng = np.random.default_rng(seed)
    return ((0.8 * rng.standard_normal((B, T, 1))).astype(np.float32),
            rng.standard_normal((B, T, cin)).astype(np.float32))


def test_gaussian_wavenet_core_and_upsample_match_jax():
    cfg = clarinet.GaussianWaveNetConfig(
        num_blocks=2, num_layers=3, front_channels=8, residual_channels=16,
        gate_channels=32, skip_channels=16, cin_channels=8,
        upsample_scales=(4, 4))
    jcfg = jax_clarinet.GaussianWaveNetConfig(**dataclasses.asdict(cfg))
    tree = convert.numpy_gaussian_wavenet_params(cfg, seed=3)
    params = convert.load_gaussian_wavenet_params(tree, cfg, "cpu")
    assert cfg.receptive_field_size() == jcfg.receptive_field_size()
    rng = np.random.default_rng(4)
    mel = rng.random((2, 5, 8)).astype(np.float32)
    c_want = jax_clarinet.gaussian_wavenet_upsample(as_jax(tree),
                                                    jnp.asarray(mel), jcfg)
    c_got = clarinet.gaussian_wavenet_upsample(params, torch.from_numpy(mel),
                                               cfg)
    assert tuple(c_got.shape) == c_want.shape == (2, 80, 8)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_want), rtol=0,
                               atol=ATOL)
    x, _ = inputs(2, 80, 8, seed=5)
    want = jax_clarinet.gaussian_wavenet_core(as_jax(tree), jcfg,
                                              jnp.asarray(x), c_want)
    got = clarinet.gaussian_wavenet_core(params, cfg, torch.from_numpy(x),
                                         c_got)
    assert tuple(got.shape) == want.shape == (2, 80, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    fused = clarinet.gaussian_wavenet_core_fused(
        params, cfg, torch.from_numpy(x[:1]), c_got[:1])
    np.testing.assert_allclose(fused.numpy(), np.asarray(want[:1]), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("use_fused,B,T", [(False, 2, 96), (True, 1, 96),
                                           (True, 1, 50)])
def test_student_matches_jax(use_fused, B, T):
    tree, params, cfg, jcfg = student()
    z, c_up = inputs(B, T, cfg.cin_channels, seed=T + B)
    want = jax_clarinet.wavenet_student_apply(
        as_jax(tree), jcfg, jnp.asarray(z), jnp.asarray(c_up),
        use_fused=use_fused, interpret=True)
    got = clarinet.wavenet_student_apply(
        params, cfg, torch.from_numpy(z), torch.from_numpy(c_up),
        use_fused=use_fused)
    for g, w, shape in zip(got, want, ((B, T, 1), (B, T - 1, 1),
                                       (B, T - 1, 1))):
        assert tuple(g.shape) == w.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    wave = clarinet.wavenet_student_generate(
        params, cfg, torch.from_numpy(z), torch.from_numpy(c_up),
        use_fused=use_fused)
    assert wave.dtype == torch.float32 and torch.equal(wave, got[0])
    jax_wave = jax_clarinet.wavenet_student_generate(
        as_jax(tree), jcfg, jnp.asarray(z), jnp.asarray(c_up),
        use_fused=use_fused, interpret=True)
    np.testing.assert_allclose(wave.numpy(), np.asarray(jax_wave), rtol=0,
                               atol=ATOL)
    # the flows really transform the noise
    assert float((wave - torch.from_numpy(z)).abs().max()) > 0.05


def test_fused_student_equals_plain_student():
    _, params, cfg, _ = student(seed=1)
    z, c_up = inputs(1, 120, cfg.cin_channels, seed=9)
    plain = clarinet.wavenet_student_generate(
        params, cfg, torch.from_numpy(z), torch.from_numpy(c_up))
    fused = clarinet.wavenet_student_generate(
        params, cfg, torch.from_numpy(z), torch.from_numpy(c_up),
        use_fused=True)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=0, atol=ATOL)


def test_fused_student_is_batch_one_and_f32_only():
    _, params, cfg, _ = student()
    z, c_up = inputs(2, 40, cfg.cin_channels, seed=2)
    with pytest.raises(ValueError, match="batch-1"):
        clarinet.wavenet_student_generate(
            params, cfg, torch.from_numpy(z), torch.from_numpy(c_up),
            use_fused=True)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        clarinet.wavenet_student_generate(
            params, cfg, torch.from_numpy(z), torch.from_numpy(c_up),
            compute_dtype=torch.bfloat16)
    acausal = dataclasses.replace(cfg.flow_config(0), causal=False)
    with pytest.raises(ValueError, match="causal chain only"):
        clarinet.gaussian_wavenet_core_fused(
            params["iafs"][0], acausal, torch.from_numpy(z[:1]),
            torch.from_numpy(c_up[:1]))


def test_loader_refuses_a_tree_of_another_depth():
    tree, _, cfg, _ = student()
    deeper = dataclasses.replace(cfg, num_layers=4)
    with pytest.raises(ValueError, match="resblocks in the params"):
        convert.load_student_params(tree, deeper, "cpu")
    with pytest.raises(ValueError, match="flows in the params"):
        convert.load_student_params(
            tree, dataclasses.replace(cfg, num_blocks_student=(1,)), "cpu")
