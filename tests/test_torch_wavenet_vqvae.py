"""PyTorch port: WaveNetVQVAE (encoder -> k1 pre-VQ conv -> VQ -> k2 mixer ->
WaveNet) against the JAX package at small widths.

Codes must be exact; logits within rtol 1e-4 / atol 1e-5 (f32 convolutions
in another framework's summation order, as in test_torch_wavenet.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models.encoder import convolutional_encoder_apply
from vqvae_speech_tpu.models.vq import vector_quantizer_apply
from vqvae_speech_tpu.models.wavenet_vqvae import (
    wavenet_vqvae_apply,
    wavenet_vqvae_init,
)
from vqvae_speech_tpu.nn import conv1d
from vqvae_speech_tpu_torch.convert import (
    load_wavenet_vqvae_params,
    numpy_wavenet_vqvae_params,
)
from vqvae_speech_tpu_torch.models import WaveNetVQVAE

CFG = dict(
    input_features_type="mfcc", input_features_filters=13,
    augment_input_features=True, sampling_rate=16000,
    num_hiddens=16, num_residual_layers=2, residual_channels=8,
    embedding_dim=8, num_embeddings=5, commitment_cost=0.25, decay=0.0,
    use_kaiming_normal=False, use_jitter=False, jitter_probability=0.12,
    quantize=16, n_loop=2, n_layers=4, filter_size=3, gate_channels=12,
    skip_out_channels=10, global_condition_dim=4, local_condition_dim=6)
N_SPEAKERS = 3


def config(**overrides):
    return dict(CFG, **overrides)


def jax_model(cfg, seed=0):
    params, state, wcfg = wavenet_vqvae_init(jax.random.PRNGKey(seed), cfg,
                                             N_SPEAKERS)
    tree = jax.tree_util.tree_map(np.asarray, (params, state))
    model = load_wavenet_vqvae_params(WaveNetVQVAE(cfg, N_SPEAKERS),
                                      *tree).eval()
    return params, state, wcfg, model


def inputs(B, T_feat, T_samp, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T_feat, 39)).astype(np.float32)
    bins = rng.integers(0, 16, (B, T_samp))
    onehot = np.eye(16, dtype=np.float32)[bins]
    return feats, onehot, np.arange(B) % N_SPEAKERS


def jax_codes_to_lc(params, state, cfg, feats):
    """scripts/wavenet_vqvae_e2e_tpu.py:codes_to_lc."""
    z = convolutional_encoder_apply(params["encoder"], feats,
                                    cfg["num_residual_layers"])
    z = conv1d(params["pre_vq_conv"], z, padding=0)
    vq_out = vector_quantizer_apply(
        params["vq"], state["vq"], z, commitment_cost=cfg["commitment_cost"],
        decay=cfg["decay"], training=False)
    return (conv1d(params["decoder"]["conv_1"], vq_out.quantized, padding=0),
            vq_out.indices)


@pytest.mark.parametrize("decay", [0.0, 0.99])
def test_eval_forward_matches_jax(decay):
    cfg = config(decay=decay)
    params, state, wcfg, model = jax_model(cfg)
    feats, onehot, spk = inputs(2, 16, 200)
    want = wavenet_vqvae_apply(params, state, wcfg, jnp.asarray(feats),
                               jnp.asarray(onehot), jnp.asarray(spk), cfg,
                               training=False, use_pallas=False)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(onehot),
                    torch.from_numpy(spk))
    np.testing.assert_array_equal(got.encoding_indices.numpy(),
                                  np.asarray(want.encoding_indices))
    assert got.reconstructed_x.shape == (2, 200, 16)
    np.testing.assert_allclose(got.reconstructed_x.numpy(),
                               np.asarray(want.reconstructed_x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.vq_loss.numpy(), np.asarray(want.vq_loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.perplexity.numpy(),
                               np.asarray(want.perplexity), rtol=1e-5)
    np.testing.assert_allclose(got.pre_vq_latents.numpy(),
                               np.asarray(want.pre_vq_latents),
                               rtol=1e-4, atol=1e-5)


def test_local_conditioning_is_batch1_per_item_and_matches_jax():
    cfg = config()
    params, state, _, model = jax_model(cfg, seed=1)
    feats, _, _ = inputs(3, 20, 1, seed=2)
    lc, codes = model.local_conditioning(torch.from_numpy(feats))
    assert codes.shape == (3, 11)           # 20 frames -> 11 latents
    assert lc.shape == (3, 10, 6)           # the k2 mixer drops one
    assert codes.dtype == torch.int32
    for b in range(3):
        lc1, codes1 = model.local_conditioning(torch.from_numpy(feats[b:b + 1]))
        torch.testing.assert_close(lc[b:b + 1], lc1, rtol=1e-6, atol=1e-6)
        assert torch.equal(codes[b:b + 1], codes1)
        want_lc, want_codes = jax_codes_to_lc(params, state, cfg,
                                              jnp.asarray(feats[b:b + 1]))
        np.testing.assert_array_equal(codes1.numpy().ravel(),
                                      np.asarray(want_codes).ravel())
        np.testing.assert_allclose(lc1.numpy(), np.asarray(want_lc),
                                   rtol=1e-4, atol=1e-5)


def test_training_forward_raises():
    """The training forward is ported (tests/test_torch_wavenet_train.py
    holds it to JAX's); with no draws it drops nothing and equals the eval
    forward, and fed dropout masks change the logits."""
    model = WaveNetVQVAE(config(), N_SPEAKERS)
    feats, onehot, spk = inputs(1, 16, 8)
    args = (torch.from_numpy(feats), torch.from_numpy(onehot),
            torch.from_numpy(spk))
    with torch.no_grad():
        trained = model.train()(*args).reconstructed_x
        evaluated = model.eval()(*args).reconstructed_x
        assert torch.equal(trained, evaluated)
        wavenet = model.decoder.wavenet
        masks = wavenet.dropout_masks(
            (1, onehot.shape[1], wavenet.cfg.residual_channels),
            torch.Generator().manual_seed(0))
        dropped = model.train()(*args, dropout_masks=masks).reconstructed_x
    assert not torch.equal(dropped, evaluated)


@pytest.mark.parametrize("overrides", [
    {},
    {"decay": 0.99, "codebook_revival": True},
    {"use_kaiming_normal": True, "filter_size": 2},
])
def test_numpy_params_have_the_jax_tree(overrides):
    cfg = config(**overrides)
    want = jax.eval_shape(lambda k: wavenet_vqvae_init(k, cfg, N_SPEAKERS)[:2],
                          jax.random.PRNGKey(0))
    params, state, wcfg = numpy_wavenet_vqvae_params(cfg, N_SPEAKERS, seed=0)
    got = (params, state)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    _, _, jax_wcfg = wavenet_vqvae_init(jax.random.PRNGKey(0), cfg, N_SPEAKERS)
    assert wcfg.__dict__ == jax_wcfg.__dict__
    # the tree loads and runs through the port
    model = load_wavenet_vqvae_params(WaveNetVQVAE(cfg, N_SPEAKERS), params,
                                      state).eval()
    feats, onehot, spk = inputs(1, 16, 64)
    with torch.no_grad():
        out = model(torch.from_numpy(feats), torch.from_numpy(onehot),
                    torch.from_numpy(spk))
    assert torch.isfinite(out.reconstructed_x).all()
