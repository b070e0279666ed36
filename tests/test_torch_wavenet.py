"""PyTorch port: the WaveNet batch forward, the local-conditioning upsampler
and the numpy parameter trees against the JAX package, at the small widths
of tests/test_wavenet_torch_parity.py.

Tolerances: logits within rtol 1e-4 / atol 1e-5 (a few f32 conv layers in
another framework's summation order); the upsampler within rtol 1e-5 /
atol 1e-6 (six single-channel stages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models.wavenet import WaveNetConfig as JaxConfig
from vqvae_speech_tpu.models.wavenet import wavenet_apply, wavenet_init
from vqvae_speech_tpu.models.wavenet.model import _upsample_lc
from vqvae_speech_tpu_torch.convert import load_wavenet_params, numpy_wavenet_params
from vqvae_speech_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetConfig,
    receptive_field_size,
)

CFG_KW = dict(
    out_channels=16, layers=4, stacks=2, residual_channels=8,
    gate_channels=12, skip_out_channels=10, kernel_size=3, dropout=0.0,
    cin_channels=6, gin_channels=4, n_speakers=3,
    upsample_conditional_features=True, upsample_scales=(2, 4),
    freq_axis_kernel_size=3, legacy=True)


def configs(**overrides):
    kw = dict(CFG_KW, **overrides)
    return JaxConfig(**kw), WaveNetConfig(**kw)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port(cfg, params):
    return load_wavenet_params(WaveNet(cfg), numpy_tree(params)).eval()


def test_config_mirrors_jax():
    jcfg, tcfg = configs()
    assert ([f.name for f in dataclasses.fields(WaveNetConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert dataclasses.asdict(WaveNetConfig()) == dataclasses.asdict(JaxConfig())
    assert [tcfg.dilation(l) for l in range(4)] == [1, 2, 1, 2]
    assert tcfg.layers_per_stack == jcfg.layers_per_stack == 2
    assert receptive_field_size(20, 2, 3) == 2 * 2 * 1023 + 1


@pytest.mark.parametrize("legacy", [True, False])
def test_forward_matches_wavenet_apply(legacy):
    jcfg, tcfg = configs(legacy=legacy)
    params = wavenet_init(jax.random.PRNGKey(1), jcfg)
    model = port(tcfg, params)
    B, T = 2, 48
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, 16)).astype(np.float32)
    c = rng.standard_normal((B, T // 8, 6)).astype(np.float32)
    g = np.array([0, 2])
    want = np.asarray(wavenet_apply(params, jcfg, jnp.asarray(x),
                                    c=jnp.asarray(c), g=jnp.asarray(g)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(c),
                    torch.from_numpy(g)).numpy()
        probs = model(torch.from_numpy(x), torch.from_numpy(c),
                      torch.from_numpy(g), softmax=True).numpy()
    assert got.shape == (B, T, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_forward_without_conditioning_matches():
    jcfg, tcfg = configs(cin_channels=-1, gin_channels=-1,
                         upsample_conditional_features=False)
    params = wavenet_init(jax.random.PRNGKey(2), jcfg)
    model = port(tcfg, params)
    x = np.random.default_rng(1).standard_normal((1, 20, 16)).astype(np.float32)
    want = np.asarray(wavenet_apply(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("init", ["asymmetric", "averaging"])
def test_upsample_lc_matches_jax(init):
    """An asymmetric random ``v`` exposes a missing or extra frequency flip
    and a per-channel norm, which the symmetric averaging init hides."""
    jcfg, tcfg = configs(upsample_scales=(2, 2, 2, 2, 2, 12))
    params = numpy_tree(wavenet_init(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)
    if init == "asymmetric":
        for p in params["upsample_conv"]:
            p["v"] = rng.standard_normal(p["v"].shape).astype(np.float32)
            p["g"] = np.float32([1.7])
            p["b"] = np.float32([0.05])
    model = port(tcfg, params)
    c = rng.standard_normal((2, 5, 6)).astype(np.float32)
    want = np.asarray(_upsample_lc(params, jnp.asarray(c), jcfg))
    with torch.no_grad():
        got = model.upsample_lc(torch.from_numpy(c)).numpy()
    assert got.shape == want.shape == (2, 5 * 384, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).max() > 0.01


def test_training_mode_raises():
    """Training mode is ported: dropout needs fed masks or a generator
    (tests/test_torch_wavenet_train.py holds it to JAX's); the wrong number
    of masks raises."""
    _, tcfg = configs(dropout=0.05)
    model = WaveNet(tcfg).train()
    masks = model.dropout_masks((1, 8, tcfg.residual_channels),
                                torch.Generator().manual_seed(0))
    assert len(masks) == tcfg.layers
    with pytest.raises(ValueError, match="dropout masks"):
        model(torch.zeros(1, 8, tcfg.out_channels), dropout_masks=masks[1:])


@pytest.mark.parametrize("overrides", [
    {},
    {"cin_channels": -1, "gin_channels": -1,
     "upsample_conditional_features": False},
    {"use_speaker_embedding": False, "kernel_size": 2},
])
def test_numpy_wavenet_params_has_the_jax_tree(overrides):
    jcfg, tcfg = configs(**overrides)
    want = jax.eval_shape(lambda k: wavenet_init(k, jcfg), jax.random.PRNGKey(0))
    got = numpy_wavenet_params(tcfg, seed=0)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    # the upsample stages carry the averaging fill, the biases are zero
    for p in got.get("upsample_conv", []):
        np.testing.assert_array_equal(p["v"], np.float32(1.0 / 3))
        np.testing.assert_allclose(p["g"], np.sqrt(np.square(p["v"]).sum()))
    assert not got["first_conv"]["b"].any()
    # a loaded tree runs through the port
    model = load_wavenet_params(WaveNet(tcfg), got).eval()
    c = torch.zeros(1, 2, 6) if tcfg.cin_channels > 0 else None
    with torch.no_grad():
        out = model(torch.zeros(1, 8, 16), c,
                    torch.zeros(1, dtype=torch.long)
                    if tcfg.use_speaker_embedding and tcfg.gin_channels > 0
                    else None)
    assert torch.isfinite(out).all()


def test_numpy_init_follows_conv_init_std():
    """_conv_init: v ~ N(0, sqrt((1 - dropout) / (k * in))); the dilated
    conv takes the config's dropout (0.05 by default)."""
    cfg = WaveNetConfig(out_channels=256, layers=2, stacks=1,
                        residual_channels=256, gate_channels=256,
                        skip_out_channels=64)
    tree = numpy_wavenet_params(cfg, seed=0)
    v = tree["conv_layers"][0]["conv"]["v"]
    np.testing.assert_allclose(v.std(), np.sqrt(0.95 / (3 * 256)), rtol=0.02)
    g = tree["conv_layers"][0]["conv"]["g"]
    np.testing.assert_allclose(g, np.sqrt(np.square(v).sum((0, 1))), rtol=1e-6)
