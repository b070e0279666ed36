"""PyTorch port: the ClariNet Gaussian WaveNet core and the IAF student
against the JAX package, on the same numpy parameters, noise and
conditioning. The JAX side's ``use_fused`` runs its Pallas chain kernel in
interpret mode.

Tolerance: atol 1e-5 (a dozen small f32 conv layers and exp() of small
log-scales, in another summation order).

At bf16 (``compute_dtype=torch.bfloat16``, the serving configuration) the
port rounds after every op as JAX does op by op, and loads the tree cast to
bf16 before the weight norm is resolved, as JAX's models cast it: measured
bit-equal to JAX's eager bf16 student, plain and fused. Held to: at least
99% of the samples equal and the rest within 2^-5 of the wave's peak (four
to eight bf16 ulps of it).
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
    with pytest.raises(ValueError, match="compute_dtype"):
        clarinet.wavenet_student_generate(
            params, cfg, torch.from_numpy(z), torch.from_numpy(c_up),
            compute_dtype=torch.float16)
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


# ---- bf16 ----

BF16 = torch.bfloat16


def assert_bf16_wave(got, want):
    """At least 99% of the samples equal, the rest within 2^-5 of the peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert (got != want).mean() <= 0.01, (got != want).mean()
    assert np.abs(got - want).max() <= 2.0 ** -5 * peak


@pytest.mark.parametrize("use_fused,B,T", [(False, 2, 96), (True, 1, 96),
                                           (True, 1, 50)])
def test_bf16_student_matches_jax(use_fused, B, T):
    """wavenet_student_generate(compute_dtype=bf16) on a tree loaded at bf16
    against JAX's on the same numpy tree, noise and conditioning; the
    fused path through the plain bf16 chain (the JAX side: its Pallas
    kernel in interpret mode)."""
    tree, _, cfg, jcfg = student()
    params = convert.load_student_params(tree, cfg, "cpu", compute_dtype=BF16)
    z, c_up = inputs(B, T, cfg.cin_channels, seed=T + B)
    want = jax_clarinet.wavenet_student_generate(
        as_jax(tree), jcfg, jnp.asarray(z), jnp.asarray(c_up),
        compute_dtype=jnp.bfloat16, use_fused=use_fused, interpret=True)
    got = clarinet.wavenet_student_generate(
        params, cfg, torch.from_numpy(z), torch.from_numpy(c_up),
        compute_dtype=BF16, use_fused=use_fused)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, 1)
    assert_bf16_wave(got.numpy(), want)
    f32 = clarinet.wavenet_student_generate(
        convert.load_student_params(tree, cfg, "cpu"), cfg,
        torch.from_numpy(z), torch.from_numpy(c_up), use_fused=use_fused)
    assert float((got - f32).abs().max()) > 1e-4     # really bf16


def test_bf16_weights_resolve_as_jax():
    """Cast, then resolve the weight norm in bf16 op by op: every conv and
    upsampling weight of the tree equals JAX's ``conv_weight`` (and its
    upsampler's norm) on the bf16-cast tree, in every element. Resolving the
    f32 tree and casting after would move a large share of them."""
    from vqvae_speech_tpu.nn.conv import conv_weight

    tcfg = clarinet.GaussianWaveNetConfig(
        num_blocks=1, num_layers=2, front_channels=32, residual_channels=128,
        gate_channels=256, skip_channels=128, cin_channels=80,
        upsample_scales=(16, 16))
    tree = convert.numpy_gaussian_wavenet_params(tcfg, seed=5)
    got = convert.load_gaussian_wavenet_params(tree, tcfg, "cpu",
                                               compute_dtype=BF16)

    def to_bf16(p):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)

    triples = [(got[n], tree[n]) for n in ("front_conv", "final_conv_1",
                                           "final_conv_2")]
    triples += [(b[n], t[n]) for b, t in zip(got["res_blocks"],
                                             tree["res_blocks"]) for n in b]
    moved = []
    for port, numpy_p in triples:
        jax_p = to_bf16(numpy_p)
        w = port["w"]
        assert w.dtype == BF16 and port["b"].dtype == BF16
        np.testing.assert_array_equal(
            w.float().permute(2, 1, 0).numpy(),
            np.asarray(conv_weight(jax_p).astype(jnp.float32)))
        np.testing.assert_array_equal(
            port["b"].float().numpy(), np.asarray(jax_p["b"].astype(jnp.float32)))
        f32_first = convert._resolved_conv(numpy_p, "cpu")["w"].to(BF16)
        moved.append((f32_first != w).float().mean().item())
    for port, numpy_p in zip(got["upsample_conv"], tree["upsample_conv"]):
        jax_p = to_bf16(numpy_p)
        v = jax_p["v"]
        want = jax_p["g"][0] * v / jnp.sqrt(jnp.sum(jnp.square(v)))
        np.testing.assert_array_equal(
            port["w"][0, 0].float().numpy(),
            np.asarray(want[:, :, 0, 0].astype(jnp.float32)))
    assert np.mean(moved) > 0.1, moved


def test_bf16_generate_casts_an_f32_tree_in():
    """A tree loaded in f32 is cast in (chains stacked again from the cast
    blocks): bf16 arithmetic, the same shapes, and close to the tree loaded
    at bf16, whose weights differ only by the order of cast and norm."""
    tree, params, cfg, _ = student(seed=2)
    loaded = convert.load_student_params(tree, cfg, "cpu", compute_dtype=BF16)
    z, c_up = inputs(1, 64, cfg.cin_channels, seed=4)
    zt, ct = torch.from_numpy(z), torch.from_numpy(c_up)
    for fused in (False, True):
        cast_in = clarinet.wavenet_student_generate(
            params, cfg, zt, ct, compute_dtype=BF16, use_fused=fused)
        want = clarinet.wavenet_student_generate(
            loaded, cfg, zt, ct, compute_dtype=BF16, use_fused=fused)
        peak = float(want.abs().max())
        assert float((cast_in - want).abs().max()) <= 2.0 ** -4 * peak
    from vqvae_speech_tpu_torch.models.clarinet.modules import cast_params
    cast = cast_params(params, BF16)
    chain = cast["iafs"][0]["chains"][0]
    assert chain["wf"].dtype == BF16 and chain["bf"].dtype == torch.float32
    again = cast_params(cast, BF16)
    assert again["iafs"][0]["chains"][0] is chain
    assert again["iafs"][0]["front_conv"]["w"] is cast["iafs"][0]["front_conv"]["w"]
