"""PyTorch port: the autoregressive WaveNet decode against the JAX package.

Greedy streams must be EQUAL to JAX's (its plain scan and its Pallas layer
stack in interpret mode), with logits within rtol/atol 1e-4 (the JAX
package's own bound between its fused and plain decodes,
tests/test_wavenet.py). The decode's logits also match the port's own
teacher-forced batch forward on the emitted stream (rtol/atol 1e-4: the
same f32 math as convolutions in another summation order). Sampling cannot
reproduce ``jax.random`` bits, so it is held to its distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vqvae_speech_tpu.models.wavenet import WaveNetConfig as JaxConfig
from vqvae_speech_tpu.models.wavenet import wavenet_init
from vqvae_speech_tpu.models.wavenet.incremental import (
    wavenet_incremental_generate as jax_generate,
)
from vqvae_speech_tpu_torch.convert import load_wavenet_params
from vqvae_speech_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetConfig,
    init_buffers,
    wavenet_incremental_generate,
)
from vqvae_speech_tpu_torch.ops._kernels import wavenet_step_cuda

CFG_KW = dict(
    out_channels=16, layers=4, stacks=2, residual_channels=8,
    gate_channels=12, skip_out_channels=10, kernel_size=3, dropout=0.0,
    cin_channels=6, gin_channels=4, n_speakers=3,
    upsample_conditional_features=True, upsample_scales=(2, 4),
    freq_axis_kernel_size=3, legacy=True)


def setup(seed=1, **overrides):
    kw = dict(CFG_KW, **overrides)
    jcfg, tcfg = JaxConfig(**kw), WaveNetConfig(**kw)
    params = wavenet_init(jax.random.PRNGKey(seed), jcfg)
    model = load_wavenet_params(
        WaveNet(tcfg), jax.tree_util.tree_map(np.asarray, params)).eval()
    return jcfg, tcfg, params, model


def onehot_inputs(emitted, n):
    """[onehot(127), onehot(emitted[:, :-1])]: the decode's own inputs (the
    first is all zeros when there are fewer than 128 bins, as in JAX)."""
    x = np.eye(n, dtype=np.float32)[emitted]
    first = np.zeros((emitted.shape[0], 1, n), np.float32)
    if n > 127:
        first[:, :, 127] = 1.0
    return np.concatenate([first, x[:, :-1]], axis=1)


@pytest.mark.parametrize("overrides,T", [
    ({}, 48),
    ({"legacy": False, "kernel_size": 2}, 24),
])
def test_greedy_matches_jax(overrides, T):
    jcfg, tcfg, params, model = setup(**overrides)
    rng = np.random.default_rng(0)
    B = 2
    c = rng.standard_normal((B, T // 8, 6)).astype(np.float32)
    g = np.array([2, 0])
    j_outs, j_em = jax_generate(params, jcfg, jax.random.PRNGKey(0), T,
                                c=jnp.asarray(c), g=jnp.asarray(g),
                                sample=False)
    with pltpu.force_tpu_interpret_mode():
        f_outs, f_em = jax_generate(params, jcfg, jax.random.PRNGKey(0), T,
                                    c=jnp.asarray(c), g=jnp.asarray(g),
                                    sample=False, use_fused_stack=True)
    np.testing.assert_array_equal(np.asarray(j_em), np.asarray(f_em))
    for fused in (False, True):
        outs, em = wavenet_incremental_generate(
            model, tcfg, T, c=torch.from_numpy(c), g=torch.from_numpy(g),
            sample=False, use_fused_stack=fused)
        assert em.dtype == torch.int32 and tuple(em.shape) == (B, T)
        assert tuple(outs.shape) == (B, T, 16)
        np.testing.assert_array_equal(em.numpy(), np.asarray(j_em))
        np.testing.assert_allclose(outs.numpy(), np.asarray(j_outs),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(outs.numpy(), np.asarray(f_outs),
                                   rtol=1e-4, atol=1e-4)


def test_unconditioned_greedy_matches_jax():
    jcfg, tcfg, params, model = setup(
        seed=5, cin_channels=-1, gin_channels=-1,
        upsample_conditional_features=False)
    j_outs, j_em = jax_generate(params, jcfg, jax.random.PRNGKey(0), 20,
                                sample=False)
    outs, em = wavenet_incremental_generate(model, tcfg, 20, sample=False,
                                            use_fused_stack=True)
    np.testing.assert_array_equal(em.numpy(), np.asarray(j_em))
    np.testing.assert_allclose(outs.numpy(), np.asarray(j_outs), rtol=1e-4,
                               atol=1e-4)


def test_initial_input_matches_jax():
    jcfg, tcfg, params, model = setup(seed=6)
    rng = np.random.default_rng(2)
    c = rng.standard_normal((2, 3, 6)).astype(np.float32)
    x0 = np.eye(16, dtype=np.float32)[[3, 11]]
    j_outs, j_em = jax_generate(params, jcfg, jax.random.PRNGKey(0), 24,
                                c=jnp.asarray(c), initial_input=jnp.asarray(x0),
                                sample=False)
    outs, em = wavenet_incremental_generate(
        model, tcfg, 24, c=torch.from_numpy(c),
        initial_input=torch.from_numpy(x0), sample=False, use_fused_stack=True)
    np.testing.assert_array_equal(em.numpy(), np.asarray(j_em))
    np.testing.assert_allclose(outs.numpy(), np.asarray(j_outs), rtol=1e-4,
                               atol=1e-4)


def test_decode_matches_teacher_forced_forward():
    _, tcfg, _, model = setup(seed=3)
    rng = np.random.default_rng(1)
    T, B = 40, 3
    c = torch.from_numpy(rng.standard_normal((B, T // 8, 6)).astype(np.float32))
    g = torch.tensor([1, 2, 0])
    before = wavenet_step_cuda.launches
    outs, em = wavenet_incremental_generate(model, tcfg, T, c=c, g=g,
                                            sample=False, use_fused_stack=True)
    assert wavenet_step_cuda.launches == before  # CPU: the plain chain
    x = torch.from_numpy(onehot_inputs(em.numpy(), 16))
    with torch.no_grad():
        forward = model(x, c, g)
    np.testing.assert_allclose(outs.numpy(), forward.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(em, outs.argmax(-1).to(torch.int32))


def constant_logit_model(logits):
    """A WaveNet whose logits are ``logits`` at every step, whatever the
    input: last_conv_2's direction scaled to zero, its bias the logits."""
    _, tcfg, _, model = setup(seed=4)
    with torch.no_grad():
        model.last_conv_2.g.zero_()
        model.last_conv_2.bias.copy_(torch.as_tensor(logits))
    return tcfg, model


def test_sampling_follows_a_sharp_logit():
    logits = np.zeros(16, np.float32)
    logits[5] = 40.0
    tcfg, model = constant_logit_model(logits)
    gen = torch.Generator().manual_seed(0)
    c = torch.zeros(4, 4, 6)
    _, em = wavenet_incremental_generate(model, tcfg, 32, c=c,
                                         g=torch.zeros(4, dtype=torch.long),
                                         sample=True, generator=gen)
    assert (em == 5).all()


def test_sampling_frequencies_match_softmax():
    """B * T = 4096 draws from fixed logits; each bin's frequency lies within
    5 standard errors, 5 * sqrt(p (1 - p) / N), of its softmax probability."""
    logits = np.linspace(-2.0, 1.0, 16).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum()
    tcfg, model = constant_logit_model(logits)
    B, T = 64, 64
    c = torch.zeros(B, T // 8, 6)
    g = torch.zeros(B, dtype=torch.long)
    gen = torch.Generator().manual_seed(7)
    _, em = wavenet_incremental_generate(model, tcfg, T, c=c, g=g,
                                         sample=True, generator=gen,
                                         use_fused_stack=True)
    n = em.numel()
    freq = np.bincount(em.numpy().ravel(), minlength=16) / n
    bound = 5 * np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= bound).all(), (freq, p, bound)
    # the same seed gives the same stream, another seed another one
    again = wavenet_incremental_generate(
        model, tcfg, T, c=c, g=g, sample=True,
        generator=torch.Generator().manual_seed(7), use_fused_stack=True)[1]
    other = wavenet_incremental_generate(
        model, tcfg, T, c=c, g=g, sample=True,
        generator=torch.Generator().manual_seed(8), use_fused_stack=True)[1]
    assert torch.equal(em, again) and not torch.equal(em, other)


def test_sampling_needs_a_generator():
    _, tcfg, _, model = setup()
    with pytest.raises(ValueError, match="Generator"):
        wavenet_incremental_generate(model, tcfg, 4, c=torch.zeros(1, 1, 6),
                                     sample=True)


@pytest.mark.parametrize("kwargs,match", [
    ({"weight_quant": "int8"}, "weight_quant"),
    ({"compute_dtype": torch.bfloat16}, "compute_dtype"),
])
def test_unported_decodes_raise(kwargs, match):
    _, tcfg, _, model = setup()
    with pytest.raises(NotImplementedError, match=match):
        wavenet_incremental_generate(model, tcfg, 4, c=torch.zeros(1, 1, 6),
                                     sample=False, **kwargs)


def test_short_conditioning_raises():
    """2 frames upsample to 16 samples: 17 steps cannot be conditioned."""
    _, tcfg, _, model = setup()
    with pytest.raises(ValueError, match="shorter"):
        wavenet_incremental_generate(model, tcfg, 17, c=torch.zeros(1, 2, 6),
                                     sample=False)
    with pytest.raises(ValueError, match="shorter"):
        model(torch.zeros(1, 17, 16), torch.zeros(1, 2, 6))


def test_scalar_input_raises():
    _, tcfg, _, model = setup(cin_channels=-1, gin_channels=-1,
                              upsample_conditional_features=False)
    scalar = WaveNetConfig(**dict(CFG_KW, scalar_input=True, cin_channels=-1,
                                  gin_channels=-1,
                                  upsample_conditional_features=False))
    with pytest.raises(NotImplementedError, match="scalar_input"):
        wavenet_incremental_generate(WaveNet(scalar).eval(), scalar, 4,
                                     sample=False)


def test_ring_holds_every_lag():
    """One (L, cap, B, C) ring; cap is the largest lag, (k-1) * 2**(n-1)."""
    cfg = WaveNetConfig(**dict(CFG_KW, layers=20, stacks=2))
    ring = init_buffers(cfg, 3, "cpu")
    assert tuple(ring.shape) == (20, 2 * 512, 3, 8) and not ring.any()
