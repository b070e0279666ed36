"""PyTorch port: speaker conditioning (``models/global_conditioning.py``) and
the speaker-conditioned, jittered decoder against the JAX package's.

Tolerances: the lookup is exact; the decoder within rtol/atol 1e-5 (five f32
conv layers in another framework's summation order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vqvae_speech_tpu.models.decoder import (
    GIN_CHANNELS as JAX_GIN,
    deconvolutional_decoder_apply,
    deconvolutional_decoder_init,
)
from vqvae_speech_tpu.models.global_conditioning import (
    global_conditioning_apply,
    global_conditioning_init,
)
from vqvae_speech_tpu_torch.convert import _load_conv, _load_stack
from vqvae_speech_tpu_torch.models.decoder import (
    GIN_CHANNELS,
    DeconvolutionalDecoder,
)
from vqvae_speech_tpu_torch.models.global_conditioning import GlobalConditioning


@pytest.mark.parametrize("expand", [True, False])
def test_lookup_matches_jax(expand):
    params = global_conditioning_init(jax.random.PRNGKey(0), 7, 40)
    ids = np.array([3, 0, 6, 3], np.int32)
    want = global_conditioning_apply(params, jnp.asarray(ids), 9, expand)
    module = GlobalConditioning(7, 40)
    with torch.no_grad():
        module.table.copy_(torch.from_numpy(np.asarray(params["table"])))
    got = module(torch.from_numpy(ids), 9, expand)
    assert got.shape == (4, 40, 9 if expand else 1)
    np.testing.assert_array_equal(got.detach().numpy().transpose(0, 2, 1),
                                  np.asarray(want))


def test_table_is_persistent_learnable_and_small():
    module = GlobalConditioning(2000, 40,
                                generator=torch.Generator().manual_seed(0))
    assert isinstance(module.table, torch.nn.Parameter)
    assert abs(module.table.std().item() - 0.1) < 0.005
    ids = torch.tensor([5, 5])
    assert torch.equal(module(ids, 3), module(ids, 3))
    module(ids, 3).sum().backward()
    assert module.table.grad[5].abs().sum() > 0
    assert module.table.grad[4].abs().sum() == 0
    # a fresh table per call (the reference's quirk) only when asked for
    fresh = module(ids, 3, resample_generator=torch.Generator().manual_seed(1))
    assert not torch.equal(fresh, module(ids, 3))
    assert abs(fresh.std().item() - 0.1) < 0.08


@pytest.mark.parametrize("training,use_jitter", [(True, True), (True, False),
                                                 (False, True)])
def test_conditioned_decoder_matches_jax(training, use_jitter):
    """Jitter runs BEFORE the speaker concat (JAX models/decoder.py:73-79),
    and only in training."""
    assert GIN_CHANNELS == JAX_GIN == 40
    D, hid, out_ch, n_spk, T = 16, 32, 39, 5, 12
    params = deconvolutional_decoder_init(
        jax.random.PRNGKey(1), D, out_ch, hid, 2, hid,
        use_speaker_conditioning=True, num_speakers=n_spk)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, T, D)).astype(np.float32)
    ids = np.array([4, 1, 1], np.int32)
    key = jax.random.PRNGKey(2)
    want = deconvolutional_decoder_apply(
        params, jnp.asarray(x), training=training, num_residual_layers=2,
        use_jitter=use_jitter, jitter_probability=0.12, jitter_key=key,
        speaker_ids=jnp.asarray(ids))

    dec = DeconvolutionalDecoder(D, out_ch, hid, 2, hid,
                                 use_speaker_conditioning=True,
                                 use_jitter=use_jitter, num_speakers=n_spk)
    for name in ("conv_1", "conv_trans_1", "conv_trans_2", "conv_trans_3"):
        _load_conv(getattr(dec, name), params[name])
    _load_stack(dec.residual_stack, params["residual_stack"])
    with torch.no_grad():
        dec.speaker_embedding.table.copy_(
            torch.from_numpy(params["speaker_embedding"]["table"]))
    dec.train(training)
    k_rep, k_dir = jax.random.split(key)
    masks = (torch.from_numpy(np.array(jax.random.bernoulli(k_rep, 0.88, (T,)))),
             torch.from_numpy(np.array(jnp.where(
                 jax.random.bernoulli(k_dir, 0.5, (T,)), 1, -1)).astype(np.int64)))
    with torch.no_grad():
        got = dec(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                  torch.from_numpy(ids), jitter_masks=masks)
    assert got.shape == (3, out_ch, 2 * T + 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="speaker_ids"):
        dec(torch.from_numpy(x.transpose(0, 2, 1).copy()))
