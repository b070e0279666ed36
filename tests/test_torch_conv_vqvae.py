"""PyTorch port: ConvVQVAE encode and eval forward against the JAX package,
with params made by ``conv_vqvae_init`` and carried across by
``convert.load_jax_params``.

Tolerances: codes exact; latents within rtol 1e-4 / atol 1e-5;
reconstruction within rtol/atol 1e-4 (eight f32 conv layers in another
framework's summation order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vqvae_speech_tpu.models import conv_vqvae_apply, conv_vqvae_encode, conv_vqvae_init
from vqvae_speech_tpu_torch.convert import load_jax_params, numpy_params
from vqvae_speech_tpu_torch.models import ConvVQVAE

CFG = dict(
    input_features_filters=13,
    augment_input_features=True,
    output_features_filters=13,
    augment_output_features=True,
    num_hiddens=32,
    num_residual_layers=2,
    residual_channels=32,
    embedding_dim=16,
    num_embeddings=11,
    commitment_cost=0.25,
    decay=0.0,
    use_kaiming_normal=False,
    use_jitter=False,
    jitter_probability=0.12,
    use_speaker_conditioning=False,
)

VARIANTS = {
    "gradient": {},
    "ema": {"decay": 0.99},
    "weight_norm": {"use_kaiming_normal": True},
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(cfg, params, state):
    return load_jax_params(ConvVQVAE.from_config(cfg), _numpy_tree(params),
                           _numpy_tree(state)).eval()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encode_and_forward_match_jax(variant):
    cfg = dict(CFG, **VARIANTS[variant])
    params, state = conv_vqvae_init(jax.random.PRNGKey(0), cfg)
    model = _port(cfg, params, state)
    x = np.random.default_rng(0).standard_normal((2, 47, 39)).astype(np.float32)

    want_vq, want_z = conv_vqvae_encode(params, state, jnp.asarray(x), cfg,
                                        training=False, use_pallas=False,
                                        return_latents=True)
    want = conv_vqvae_apply(params, state, jnp.asarray(x), cfg,
                            training=False, use_pallas=False)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got_z = model.latents(xt).transpose(1, 2)
        got_vq = model.encode(xt)
        got = model(xt)

    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_vq.indices.numpy(),
                                  np.asarray(want_vq.indices))
    np.testing.assert_array_equal(got.encoding_indices.numpy(),
                                  np.asarray(want.encoding_indices))
    assert got.quantized.shape == want.quantized.shape == (2, 24, 16)
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized),
                               rtol=1e-4, atol=1e-5)
    assert got.reconstructed_x.shape == want.reconstructed_x.shape == (2, 47, 39)
    np.testing.assert_allclose(got.reconstructed_x.numpy(),
                               np.asarray(want.reconstructed_x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.vq_loss.item(), float(want.vq_loss),
                               rtol=1e-4)
    np.testing.assert_allclose(got.perplexity.item(), float(want.perplexity),
                               rtol=1e-5)


@pytest.mark.parametrize("T,T_lat", [(47, 24), (48, 25), (191, 96)])
def test_output_lengths(T, T_lat):
    """Encoder: ceil((T+1)/2) latents; decoder 2T'+3 frames, trimmed to T."""
    params, state = numpy_params(CFG, seed=1)
    model = load_jax_params(ConvVQVAE.from_config(CFG), params, state).eval()
    with torch.no_grad():
        out = model(torch.zeros(1, T, 39))
        recon = model.decoder(out.quantized.transpose(1, 2))
    assert out.quantized.shape == (1, T_lat, 16)
    assert recon.shape == (1, 39, 2 * T_lat + 3)
    assert out.reconstructed_x.shape == (1, T, 39)


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["revival"])
def test_numpy_params_has_the_jax_tree(variant):
    """numpy_params: same tree structure, shapes and dtypes as
    conv_vqvae_init, with no JAX needed."""
    cfg = dict(CFG, **VARIANTS.get(variant, {"codebook_revival": True}))
    want = conv_vqvae_init(jax.random.PRNGKey(0), cfg)
    got = numpy_params(cfg, seed=0)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(_numpy_tree(want)))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert isinstance(g, np.ndarray)
        assert g.shape == w.shape and g.dtype == np.float32 == w.dtype


def test_unported_options_raise():
    """Jitter and speaker conditioning are ported; what still raises is the
    train step's ``compute_dtype`` and ``mesh``, and a conditioned decoder
    called without speaker ids."""
    from vqvae_speech_tpu_torch.train import make_optimizer, make_train_step

    with pytest.raises(NotImplementedError):
        make_train_step(dict(CFG, compute_dtype="bfloat16"),
                        make_optimizer(1e-3))
    with pytest.raises(NotImplementedError):
        make_train_step(CFG, make_optimizer(1e-3), mesh=object())
    model = ConvVQVAE.from_config(dict(CFG, use_speaker_conditioning=True,
                                       num_speakers=3))
    with pytest.raises(ValueError):
        model(torch.zeros(1, 47, 39))
    model = ConvVQVAE.from_config(dict(CFG, use_jitter=True)).train()
    assert model(torch.zeros(1, 47, 39)).reconstructed_x.shape == (1, 47, 39)


VARIANTS_TRAIN = {
    "jitter": {"use_jitter": True},
    "jitter_live": {"use_jitter": True, "jitter_gradient_detach": False},
    "speaker": {"use_speaker_conditioning": True, "num_speakers": 4},
    "speaker_jitter_ema": {"use_speaker_conditioning": True, "num_speakers": 4,
                           "use_jitter": True, "decay": 0.99},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS_TRAIN))
def test_training_forward_matches_jax(variant):
    """The training forward with jitter (the JAX side's masks, recomputed
    from its key) and speaker conditioning: reconstruction within rtol/atol
    1e-4, losses rtol 1e-4, and the speaker table loads through
    ``load_jax_params`` / ``numpy_params``."""
    cfg = dict(CFG, **VARIANTS_TRAIN[variant])
    params, state = conv_vqvae_init(jax.random.PRNGKey(0), cfg)
    model = load_jax_params(ConvVQVAE.from_config(cfg), _numpy_tree(params),
                            _numpy_tree(state)).train()
    x = np.random.default_rng(0).standard_normal((3, 47, 39)).astype(np.float32)
    ids = (np.array([2, 0, 3], np.int32)
           if cfg["use_speaker_conditioning"] else None)
    key = jax.random.PRNGKey(4)
    want = conv_vqvae_apply(params, state, jnp.asarray(x), cfg, training=True,
                            rng=key, use_pallas=False,
                            speaker_ids=None if ids is None
                            else jnp.asarray(ids))
    k_rep, k_dir = jax.random.split(key)
    masks = (torch.from_numpy(np.array(jax.random.bernoulli(k_rep, 0.88, (24,)))),
             torch.from_numpy(np.array(jnp.where(
                 jax.random.bernoulli(k_dir, 0.5, (24,)), 1, -1)).astype(np.int64)))
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    None if ids is None else torch.from_numpy(ids),
                    jitter_masks=masks)
    np.testing.assert_array_equal(got.encoding_indices.numpy(),
                                  np.asarray(want.encoding_indices))
    np.testing.assert_allclose(got.reconstructed_x.numpy(),
                               np.asarray(want.reconstructed_x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.vq_loss.item(), float(want.vq_loss),
                               rtol=1e-4)
    np.testing.assert_allclose(got.pre_vq_latents.numpy(),
                               np.asarray(want.pre_vq_latents),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.encodings.numpy(),
                                  np.asarray(want.encodings))
    np.testing.assert_allclose(got.counts.numpy(),
                               np.asarray(want.encodings).sum((0, 1)))
    if cfg["use_speaker_conditioning"]:
        np_params, np_state = numpy_params(cfg, seed=3)
        assert (jax.tree_util.tree_structure(np_params)
                == jax.tree_util.tree_structure(_numpy_tree(params)))
        assert np_params["decoder"]["speaker_embedding"]["table"].shape == (4, 40)
        assert np_params["decoder"]["conv_1"]["w"].shape == (3, 16 + 40, 32)
        load_jax_params(ConvVQVAE.from_config(cfg), np_params, np_state)
