"""PyTorch port: the WaveNet-VQ-VAE training forward against the JAX
package's ``wavenet_vqvae_apply(training=True)``.

Both sides load the same tree (``convert.numpy_wavenet_vqvae_params``,
``wavenet_vqvae_init``'s structure drawn from numpy), its LC upsample
kernels replaced by asymmetric random ones (the averaging init is symmetric
and would hide a flip of the frequency axis). The JAX side draws its jitter
and dropout masks from its key; the port is handed the same masks,
recomputed here from the key splits (``wavenet_decoder.py:57-60``,
``wavenet/model.py:165-168`` and ``:255-256``). The logits, the VQ terms
and then the gradients of the trainer's loss (cross-entropy + VQ loss) are
compared leaf by leaf, with dropout off (no draws) and on, with jitter, and
with the EMA quantizer.

Tolerances, f32: logits rtol 1e-4 / atol 1e-5, gradients rtol 1e-4 /
atol 1e-6 (one graph in two frameworks' summation orders). The bf16 decoder
(``decoder_compute_dtype``): the port's bf16 logits within twice the
distance of JAX's bf16 logits from the f32 ones (measured over four seeds
and both bf16 cases: port to JAX 0.0029-0.0059, JAX bf16 to f32
0.0038-0.0071, at |logits| up to 0.54; JAX's XLA fuses the bf16 ops and
keeps f32 in between, the port rounds op by op), and the VQ terms equal
(the encoder and the VQ stay f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_training import TINY_CFG
from vqvae_speech_tpu.models.wavenet_decoder import (
    wavenet_config_from as jax_wavenet_config_from,
)
from vqvae_speech_tpu.models.wavenet_vqvae import wavenet_vqvae_apply
from vqvae_speech_tpu.ops.mu_law import mu_law_encode as jax_mu_law_encode
from vqvae_speech_tpu_torch.convert import (
    jax_param_leaves,
    load_wavenet_vqvae_params,
    numpy_wavenet_vqvae_params,
)
from vqvae_speech_tpu_torch.models import WaveNetVQVAE

WN_CFG = dict(
    TINY_CFG,
    decoder_type="wavenet",
    normalize=False,
    num_epochs=1,
    batch_size=2,
    length=1920,
    input_features_dim=11,  # 1920 samples -> 11 frames
    output_features_dim=11,
    quantize=32,
    num_hiddens=16,
    embedding_dim=8,
    num_embeddings=7,
    residual_channels=8,
    n_loop=2,
    n_layers=4,
    filter_size=2,
    gate_channels=8,
    skip_out_channels=8,
    global_condition_dim=6,
    local_condition_dim=16,
    num_speakers=4,
    learning_rate=2e-4,
)
B = 2
T_LAT = 6          # 11 frames through the encoder's stride-2 conv


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def both_models(cfg, seed=0):
    """The JAX (params, state, wavenet_cfg) and the port's model on the
    same tree, the LC upsample kernels asymmetric."""
    params, state, _ = numpy_wavenet_vqvae_params(cfg, cfg["num_speakers"],
                                                  seed)
    wcfg = jax_wavenet_config_from(cfg, cfg["num_speakers"])
    rng = np.random.default_rng(seed + 100)
    for stage in params["decoder"]["wavenet"]["upsample_conv"]:
        stage["v"] = rng.uniform(0.1, 1.0, stage["v"].shape).astype(
            np.float32)
        stage["b"] = rng.uniform(-0.05, 0.05, (1,)).astype(np.float32)
    model = load_wavenet_vqvae_params(
        WaveNetVQVAE(cfg, cfg["num_speakers"]), params, state).train()
    return (jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), wcfg, model)


def batch_arrays(cfg, seed=0):
    rng = np.random.default_rng(seed)
    T = cfg["length"]
    audio = np.clip(0.3 * rng.standard_normal((B, T + 1)), -1, 1).astype(
        np.float32)
    feats = rng.standard_normal(
        (B, cfg["input_features_dim"], 39)).astype(np.float32)
    speakers = rng.integers(0, cfg["num_speakers"], (B,)).astype(np.int32)
    return {"preprocessed_audio": audio, "input_features": feats,
            "speaker_id": speakers}


def jax_decoder_draws(key, cfg, wcfg, T):
    """What ``wavenet_decoder_apply`` draws from ``key`` in training: the
    jitter's (replace, direction) when ``use_jitter``, then one dropout
    mask a layer (B, T, residual_channels)."""
    jitter = None
    if cfg.get("use_jitter"):
        k_jit, key = jax.random.split(key)
        k_rep, k_dir = jax.random.split(k_jit)
        replace = jax.random.bernoulli(
            k_rep, 1.0 - cfg["jitter_probability"], (T_LAT,))
        direction = jnp.where(jax.random.bernoulli(k_dir, 0.5, (T_LAT,)),
                              1, -1)
        jitter = (torch.from_numpy(np.array(replace)),
                  torch.from_numpy(np.asarray(direction).astype(np.int64)))
    keep = 1.0 - wcfg.dropout
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        k, keep, (B, T, wcfg.residual_channels))))
        for k in jax.random.split(key, wcfg.layers)]
    return jitter, masks


def teacher_forcing(audio, quantize):
    q = np.array(jax_mu_law_encode(jnp.asarray(audio), quantize))
    return np.eye(quantize, dtype=np.float32)[q[:, :-1]], q[:, 1:]


def jax_loss_and_out(params, state, wcfg, cfg, batch, key, x_dec, target,
                     dtype=None):
    def loss_fn(p):
        out = wavenet_vqvae_apply(
            p, state, wcfg, jnp.asarray(batch["input_features"]),
            jnp.asarray(x_dec), jnp.asarray(batch["speaker_id"]), cfg,
            training=True, rng=key, use_pallas=False,
            decoder_compute_dtype=dtype)
        logp = jax.nn.log_softmax(out.reconstructed_x, axis=-1)
        ce = -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(target)[..., None], axis=-1))
        return ce + out.vq_loss, out
    return loss_fn


def torch_loss(out, target):
    logp = F.log_softmax(out.reconstructed_x, dim=-1)
    return -torch.mean(torch.take_along_dim(
        logp, torch.as_tensor(target).long()[..., None], -1)) + out.vq_loss


VARIANTS = {
    "dropout_off": ({}, False),
    "dropout": ({}, True),
    "jitter": ({"use_jitter": True}, True),
    "ema": ({"decay": 0.99, "use_jitter": True}, True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_training_forward_and_gradients_follow_jax(variant):
    overrides, draws = VARIANTS[variant]
    cfg = dict(WN_CFG, **overrides)
    params, state, wcfg, model = both_models(cfg)
    batch = batch_arrays(cfg)
    x_dec, target = teacher_forcing(batch["preprocessed_audio"],
                                    cfg["quantize"])
    key = jax.random.PRNGKey(5) if draws else None
    jitter, masks = (jax_decoder_draws(key, cfg, wcfg, cfg["length"])
                     if draws else (None, None))

    loss_fn = jax_loss_and_out(params, state, wcfg, cfg, batch, key, x_dec,
                               target)
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    out = model(torch.from_numpy(batch["input_features"]),
                torch.from_numpy(x_dec),
                torch.from_numpy(batch["speaker_id"]),
                jitter_masks=jitter, dropout_masks=masks)
    np.testing.assert_allclose(out.reconstructed_x.detach().numpy(),
                               np.asarray(jout.reconstructed_x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out.encoding_indices.numpy(),
                                  np.asarray(jout.encoding_indices))
    for name, value in jout.losses.items():
        np.testing.assert_allclose(out.losses[name].item(), float(value),
                                   rtol=1e-5, err_msg=name)
    if cfg["decay"] > 0:
        for name, value in jout.new_state["vq"].items():
            np.testing.assert_allclose(out.new_state["vq"][name].numpy(),
                                       np.asarray(value), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
    loss = torch_loss(out, target)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    want = dict(jax.tree_util.tree_flatten_with_path(numpy_tree(jgrads))[0])
    leaves = jax_param_leaves(model)
    assert len(leaves) == len(want)
    grads = torch.autograd.grad(loss, [leaf.tensor for leaf in leaves],
                                allow_unused=True)
    for leaf, g in zip(leaves, grads):
        # the last layer's residual output feeds nothing: JAX's gradient
        # of its conv1x1_out is zero, autograd's is None
        g = torch.zeros_like(leaf.tensor) if g is None else g
        key_path = tuple(jax.tree_util.SequenceKey(k) if isinstance(k, int)
                         else jax.tree_util.DictKey(k) for k in leaf.path)
        g = g.numpy().transpose(leaf.perm) if leaf.is_kernel else g.numpy()
        np.testing.assert_allclose(g, want[key_path], rtol=1e-4, atol=1e-6,
                                   err_msg=str(leaf.path))
    # the LC upsample trains: its weight norm's g and v get gradients
    stage = want[tuple(jax.tree_util.DictKey(k) if isinstance(k, str)
                       else jax.tree_util.SequenceKey(k) for k in
                       ("decoder", "wavenet", "upsample_conv", 0, "v"))]
    assert np.abs(stage).max() > 0


def test_dropout_drawn_from_a_generator_drops_a_share_of_inputs():
    """Without fed masks the module draws its own from the generator: about
    ``dropout`` of each layer's inputs, a different draw each layer, and
    the same draws again from the same seed."""
    cfg = dict(WN_CFG)
    _, _, wcfg, model = both_models(cfg)
    wavenet = model.decoder.wavenet
    masks = wavenet.dropout_masks((B, 1920, 8), torch.Generator().manual_seed(3))
    again = wavenet.dropout_masks((B, 1920, 8),
                                  torch.Generator().manual_seed(3))
    assert len(masks) == wcfg.layers
    dropped = [1.0 - m.float().mean().item() for m in masks]
    assert all(0.03 < d < 0.07 for d in dropped), dropped
    assert not torch.equal(masks[0], masks[1])
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    with pytest.raises(ValueError, match="dropout masks"):
        batch = batch_arrays(cfg)
        x_dec, _ = teacher_forcing(batch["preprocessed_audio"], 32)
        model(torch.from_numpy(batch["input_features"]),
              torch.from_numpy(x_dec), torch.from_numpy(batch["speaker_id"]),
              dropout_masks=masks[:2])


@pytest.mark.parametrize("variant", ["dropout", "jitter"])
def test_bf16_decoder_forward_follows_jax(variant):
    overrides, _ = VARIANTS[variant]
    cfg = dict(WN_CFG, **overrides)
    params, state, wcfg, model = both_models(cfg, seed=1)
    batch = batch_arrays(cfg, seed=1)
    x_dec, target = teacher_forcing(batch["preprocessed_audio"],
                                    cfg["quantize"])
    key = jax.random.PRNGKey(9)
    jitter, masks = jax_decoder_draws(key, cfg, wcfg, cfg["length"])
    loss_fn = jax_loss_and_out(params, state, wcfg, cfg, batch, key, x_dec,
                               target, dtype=jnp.bfloat16)
    _, jout = jax.jit(loss_fn)(params)
    args = (torch.from_numpy(batch["input_features"]),
            torch.from_numpy(x_dec), torch.from_numpy(batch["speaker_id"]))
    with torch.no_grad():
        f32 = model(*args, jitter_masks=jitter,
                    dropout_masks=masks).reconstructed_x.numpy()
    out = model(*args, jitter_masks=jitter, dropout_masks=masks,
                decoder_compute_dtype=torch.bfloat16)
    assert out.reconstructed_x.dtype == torch.float32
    got = out.reconstructed_x.detach().numpy()
    want = np.asarray(jout.reconstructed_x)
    spread = np.abs(want - f32).max()
    assert 0 < np.abs(got - want).max() <= 2 * spread
    for name, value in jout.losses.items():
        np.testing.assert_allclose(out.losses[name].item(), float(value),
                                   rtol=1e-5, err_msg=name)
    # the gradients reach the f32 parameters as f32
    loss = torch_loss(out, target)
    grads = torch.autograd.grad(
        loss, [model.decoder.wavenet.first_conv.v, model.encoder.conv_1.weight])
    assert all(g.dtype == torch.float32 and g.abs().max() > 0 for g in grads)
