"""PyTorch port: the ClariNet teacher's batch forward
(``gaussian_wavenet_apply``) and its autoregressive synthesis
(``gaussian_wavenet_generate``) against the JAX package's, on the same
numpy weights (``convert.numpy_gaussian_wavenet_params``) and, for the
synthesis, JAX's own draws: its scan splits its key once a step
(``key, k_s = split(key)``) and draws ``normal(k_s, (B,))``, recomputed
here and fed through ``noise=``.

The port runs the layer stack of each step through
``ops.prepare_glu_stack_step`` (on the CPU its plain twin; on the card the
decode-step kernel: tests/test_torch_wavenet_kernel.py holds that one to
the plain stack).

Tolerances: the forward rtol 1e-5 / atol 1e-6; the synthesized waves within
1e-5 over 600 steps (measured 1.7e-6: each sample feeds the next steps, and
the two packages add the taps in another order). JAX runs with x64 off, as
the JAX package runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vocoder_train import one_torch_thread  # noqa: F401
from vqvae_speech_tpu.models.clarinet import wavenet as jax_wavenet
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models.clarinet import wavenet

# the vocoder CLI's --tiny teacher (k=2) and a k=3 stack of two blocks
# (dilations 1, 3, 9 twice), the paper's kernel size
WIDTHS = {
    "tiny": dict(num_blocks=1, num_layers=2, front_channels=4,
                 residual_channels=8, gate_channels=8, skip_channels=8,
                 kernel_size=2, cin_channels=80, upsample_scales=(16, 16)),
    "k3": dict(num_blocks=2, num_layers=3, front_channels=6,
               residual_channels=8, gate_channels=12, skip_channels=8,
               kernel_size=3, cin_channels=80, upsample_scales=(16, 16)),
}


def setup(name, seed=0):
    widths = WIDTHS[name]
    tree = convert.numpy_gaussian_wavenet_params(
        wavenet.GaussianWaveNetConfig(**widths), seed)
    c = np.random.default_rng(seed + 1).random((2, 3, 80)).astype(np.float32)
    return widths, tree, c


def jax_generate(widths, tree, c, T, seed, **kw):
    with jax.enable_x64(False):
        cfg = jax_wavenet.GaussianWaveNetConfig(**widths)
        key = jax.random.PRNGKey(seed)
        wave = jax_wavenet.gaussian_wavenet_generate(
            jax.tree_util.tree_map(jnp.asarray, tree), cfg, key, T,
            jnp.asarray(c), **kw)
        draws = []
        for _ in range(T):
            key, k_s = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(k_s, (c.shape[0],))))
    return np.asarray(wave), np.stack(draws)


@pytest.mark.parametrize("name", ["tiny", "k3"])
def test_apply_matches_jax(name):
    widths, tree, c = setup(name)
    x = (0.3 * np.random.default_rng(5).standard_normal((2, 768, 1))
         ).astype(np.float32)
    with jax.enable_x64(False):
        want = jax_wavenet.gaussian_wavenet_apply(
            jax.tree_util.tree_map(jnp.asarray, tree),
            jax_wavenet.GaussianWaveNetConfig(**widths), jnp.asarray(x),
            jnp.asarray(c))
    cfg = wavenet.GaussianWaveNetConfig(**widths)
    got = wavenet.gaussian_wavenet_apply(
        convert.load_gaussian_wavenet_params(tree, cfg, "cpu"), cfg,
        torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name,T,kw", [
    ("k3", 600, {}),
    ("tiny", 300, dict(log_std_min=-2.0, scale_factor=0.5)),
])
def test_generate_matches_jax_on_its_draws(name, T, kw):
    widths, tree, c = setup(name)
    want, noise = jax_generate(widths, tree, c, T, seed=3, **kw)
    cfg = wavenet.GaussianWaveNetConfig(**widths)
    params = convert.load_gaussian_wavenet_params(tree, cfg, "cpu")
    got = wavenet.gaussian_wavenet_generate(params, cfg, T,
                                            torch.from_numpy(c),
                                            noise=torch.from_numpy(noise),
                                            **kw)
    assert got.shape == (2, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the samples move (the model is not stuck at a clip) and stay in band
    limit = kw.get("scale_factor", 1.0)
    assert np.abs(want).max() <= limit and want.std() > 0.05
    plain = wavenet.gaussian_wavenet_generate(params, cfg, T,
                                              torch.from_numpy(c),
                                              noise=torch.from_numpy(noise),
                                              plain=True, **kw)
    assert torch.equal(plain, got)


def test_generate_draws_from_a_generator():
    widths, tree, c = setup("tiny")
    cfg = wavenet.GaussianWaveNetConfig(**widths)
    params = convert.load_gaussian_wavenet_params(tree, cfg, "cpu")

    def run(seed):
        return wavenet.gaussian_wavenet_generate(
            params, cfg, 256, torch.from_numpy(c),
            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_generate_refuses():
    widths, tree, c = setup("tiny")
    cfg = wavenet.GaussianWaveNetConfig(**widths)
    params = convert.load_gaussian_wavenet_params(tree, cfg, "cpu")
    with pytest.raises(ValueError, match="noise has shape"):
        wavenet.gaussian_wavenet_generate(params, cfg, 10, torch.from_numpy(c),
                                          noise=torch.zeros(10, 3))
    with pytest.raises(ValueError, match="fewer than"):
        wavenet.gaussian_wavenet_generate(params, cfg, 3 * 256 + 1,
                                          torch.from_numpy(c))
    bf16 = convert.load_gaussian_wavenet_params(tree, cfg, "cpu",
                                                compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        wavenet.gaussian_wavenet_generate(bf16, cfg, 10, torch.from_numpy(c))
