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
    prepare_decode_weights as jax_prepare_decode_weights,
)
from vqvae_speech_tpu.models.wavenet.incremental import (
    wavenet_incremental_generate as jax_generate,
)
from vqvae_speech_tpu_torch.convert import load_wavenet_params
from vqvae_speech_tpu_torch.models.wavenet import incremental
from vqvae_speech_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetConfig,
    init_buffers,
    prepare_decode_weights,
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
    """The decode-step kernel is f32 only: a narrow configuration under
    use_fused_stack raises (as JAX asserts) and never quietly runs the
    per-layer path; an unknown one raises without it."""
    _, tcfg, _, model = setup()
    with pytest.raises(ValueError, match=match):
        wavenet_incremental_generate(model, tcfg, 4, c=torch.zeros(1, 1, 6),
                                     sample=False, use_fused_stack=True,
                                     **kwargs)
    unknown = {"weight_quant": "int4", "compute_dtype": torch.float16}
    name = next(iter(kwargs))
    with pytest.raises(ValueError, match=match):
        wavenet_incremental_generate(model, tcfg, 4, c=torch.zeros(1, 1, 6),
                                     sample=False, **{name: unknown[name]})


def test_short_conditioning_raises():
    """2 frames upsample to 16 samples: 17 steps cannot be conditioned."""
    _, tcfg, _, model = setup()
    with pytest.raises(ValueError, match="shorter"):
        wavenet_incremental_generate(model, tcfg, 17, c=torch.zeros(1, 2, 6),
                                     sample=False)
    with pytest.raises(ValueError, match="shorter"):
        model(torch.zeros(1, 17, 16), torch.zeros(1, 2, 6))


def test_scalar_input_raises():
    """The scalar input takes one channel: a one-hot first input raises;
    sampling it needs a generator."""
    scalar = WaveNetConfig(**dict(CFG_KW, scalar_input=True, cin_channels=-1,
                                  gin_channels=-1, out_channels=30,
                                  upsample_conditional_features=False))
    model = WaveNet(scalar).eval()
    with pytest.raises(ValueError, match="initial_input"):
        wavenet_incremental_generate(model, scalar, 4, sample=False,
                                     initial_input=torch.zeros(2, 30))
    with pytest.raises(ValueError, match="Generator"):
        wavenet_incremental_generate(model, scalar, 4, sample=True)
    _, em = wavenet_incremental_generate(model, scalar, 4, sample=False,
                                         initial_input=torch.zeros(2, 1))
    assert em.dtype == torch.float32 and tuple(em.shape) == (2, 4)


def test_ring_holds_every_lag():
    """One (L, cap, B, C) ring; cap is the largest lag, (k-1) * 2**(n-1)."""
    cfg = WaveNetConfig(**dict(CFG_KW, layers=20, stacks=2))
    ring = init_buffers(cfg, 3, "cpu")
    assert tuple(ring.shape) == (20, 2 * 512, 3, 8) and not ring.any()


# ---- the JAX decode's other configurations: int8, int8_block, bf16, and
# the scalar (mixture-of-logistics) input ----

# bf16 logits: one bf16 ulp at |x| in [0.5, 1) for the first step (the same
# inputs through both packages), two before the first near-tie (XLA keeps
# f32 between fused ops in its scan, torch rounds every op), and a near-tie
# within one
BF16_LOGIT_TOL, BF16_NEAR_TIE = 2 ** -8, 2 ** -8


def jax_resolved(params, jcfg):
    """{name: (L, ...) stacked} of the JAX decode's f32 weights, before any
    quantization: the port's resolved weights differ from these by an ulp
    here and there (the weight norm's sum in another order)."""
    plain = jax_prepare_decode_weights(params, jcfg)["layers"]
    return {name: torch.from_numpy(np.stack([np.asarray(lw[jname])
                                             for lw in plain]))
            for name, jname in (("wtap", "conv_w"), ("wskip", "skip_w"),
                                ("wout", "out_w"))}


@pytest.mark.parametrize("weight_quant,C", [
    ("int8", 8), ("int8_block", 8), ("int8", 256), ("int8_block", 256)])
def test_quantized_weights_bit_equal_jax(weight_quant, C):
    """C=256 gives two 128-row blocks a tap, C=8 one block (the fallback);
    the projections' input G/2 = 128 one block either way. On the same f32
    weights the int8 weights and the scales are bit-equal to JAX's; through
    each package's own weight norm the int8 weights are equal and the
    scales within 2**-21 relative (a few f32 ulps: XLA sums the norm's
    squares in another order than torch, 26-86% of the resolved weights
    differ from torch's by an ulp or two)."""
    jcfg, tcfg, params, model = setup(seed=2, residual_channels=C,
                                      gate_channels=256)
    jax_prep = jax_prepare_decode_weights(params, jcfg, weight_quant)
    with torch.no_grad():
        prep = prepare_decode_weights(model, tcfg, weight_quant)
        same = prepare_decode_weights(model, tcfg)
        same.update(jax_resolved(params, jcfg))
        exact = dict(same)
        for name, dims in (("wtap", (0, 1)), ("wskip", (0,)), ("wout", (0,))):
            pairs = [incremental._quantized(w, weight_quant, dims)
                     for w in same[name]]
            exact[name + "_int8"] = torch.stack([p[0] for p in pairs])
            exact[name + "_scale"] = torch.stack([p[1] for p in pairs])
    suffix = "_scale" if weight_quant == "int8" else "_bscale"
    for name, jname in (("wtap", "conv_w"), ("wskip", "skip_w"),
                        ("wout", "out_w")):
        assert prep[name + "_int8"].dtype == torch.int8
        for l, lw in enumerate(jax_prep["layers"]):
            want_w, want_s = np.asarray(lw[jname]), np.asarray(lw[jname + suffix])
            np.testing.assert_array_equal(exact[name + "_int8"][l].numpy(),
                                          want_w)
            np.testing.assert_array_equal(exact[name + "_scale"][l].numpy(),
                                          want_s)
            np.testing.assert_array_equal(prep[name + "_int8"][l].numpy(),
                                          want_w)
            np.testing.assert_allclose(prep[name + suffix][l].numpy(), want_s,
                                       rtol=2 ** -21, atol=0)
            # the values the products read are the int8 weights, exactly
            assert torch.equal(prep[name][l], prep[name + "_int8"][l].float())
    nb = 2 if (weight_quant, C) == ("int8_block", 256) else 1
    want = (4, 3, nb, 256) if weight_quant == "int8_block" else (4, 1, 256)
    assert tuple(prep["wtap" + suffix].shape) == want


@pytest.mark.parametrize("weight_quant", ["int8", "int8_block"])
def test_quantized_greedy_matches_jax(weight_quant):
    jcfg, tcfg, params, model = setup(seed=2, residual_channels=256)
    rng = np.random.default_rng(3)
    T, B = 32, 2
    c = rng.standard_normal((B, T // 8, 6)).astype(np.float32)
    g = np.array([1, 2])
    j_outs, j_em = jax_generate(params, jcfg, jax.random.PRNGKey(0), T,
                                c=jnp.asarray(c), g=jnp.asarray(g),
                                sample=False, weight_quant=weight_quant)
    outs, em = wavenet_incremental_generate(
        model, tcfg, T, c=torch.from_numpy(c), g=torch.from_numpy(g),
        sample=False, weight_quant=weight_quant)
    np.testing.assert_array_equal(em.numpy(), np.asarray(j_em))
    np.testing.assert_allclose(outs.numpy(), np.asarray(j_outs), rtol=1e-4,
                               atol=1e-4)


def scalar_setup(seed=3):
    return setup(seed=seed, scalar_input=True, out_channels=30)


def test_scalar_input_greedy_matches_jax():
    """The unclipped first channel fed back as the next input: samples
    within 1e-6 of JAX's (measured 4e-8), logits within 1e-5."""
    jcfg, tcfg, params, model = scalar_setup()
    rng = np.random.default_rng(4)
    T, B = 48, 2
    c = rng.standard_normal((B, T // 8, 6)).astype(np.float32)
    g = np.array([2, 0])
    for fused in (False, True):
        j_outs, j_em = jax_generate(params, jcfg, jax.random.PRNGKey(0), T,
                                    c=jnp.asarray(c), g=jnp.asarray(g),
                                    sample=False)
        outs, em = wavenet_incremental_generate(
            model, tcfg, T, c=torch.from_numpy(c), g=torch.from_numpy(g),
            sample=False, use_fused_stack=fused)
        assert em.dtype == torch.float32 and tuple(outs.shape) == (B, T, 30)
        np.testing.assert_allclose(em.numpy(), np.asarray(j_em), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(outs.numpy(), np.asarray(j_outs), rtol=0,
                                   atol=1e-5)
        assert torch.equal(em, outs[..., 0])          # unclipped


def test_scalar_input_sampling_draws_from_the_mixture():
    _, tcfg, _, model = scalar_setup()
    c = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 4, 6)).astype(np.float32))
    g = torch.tensor([0, 1, 2])
    runs = [wavenet_incremental_generate(
        model, tcfg, 32, c=c, g=g, sample=True, use_fused_stack=True,
        generator=torch.Generator().manual_seed(seed))[1] for seed in (0, 0, 1)]
    assert torch.isfinite(runs[0]).all() and runs[0].abs().max() <= 1.0
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("weight_quant", [None, "int8", "int8_block"])
def test_bf16_logits_follow_jax(weight_quant):
    """bf16 (alone and with int8 weights): the first step's logits within
    one bf16 ulp of JAX's, the greedy streams equal up to the first
    near-tie and the logits before it within two."""
    jcfg, tcfg, params, model = setup()
    rng = np.random.default_rng(0)
    T, B = 48, 2
    c = rng.standard_normal((B, T // 8, 6)).astype(np.float32)
    g = np.array([2, 0])
    j_outs, j_em = jax_generate(params, jcfg, jax.random.PRNGKey(0), T,
                                c=jnp.asarray(c), g=jnp.asarray(g),
                                sample=False, compute_dtype=jnp.bfloat16,
                                weight_quant=weight_quant)
    outs, em = wavenet_incremental_generate(
        model, tcfg, T, c=torch.from_numpy(c), g=torch.from_numpy(g),
        sample=False, compute_dtype=torch.bfloat16, weight_quant=weight_quant)
    assert outs.dtype == torch.float32 and em.dtype == torch.int32
    j_outs, j_em = np.asarray(j_outs), np.asarray(j_em)
    outs, em = outs.numpy(), em.numpy()
    np.testing.assert_allclose(outs[:, 0], j_outs[:, 0], rtol=0,
                               atol=BF16_LOGIT_TOL)
    for b in range(B):
        diff = np.flatnonzero(em[b] != j_em[b])
        flip = diff[0] if len(diff) else T
        if len(diff):
            top2 = np.sort(j_outs[b, flip])[-2:]
            assert top2[1] - top2[0] <= BF16_NEAR_TIE, (b, flip, top2)
        np.testing.assert_allclose(outs[b, :flip], j_outs[b, :flip], rtol=0,
                                   atol=2 * BF16_LOGIT_TOL)
