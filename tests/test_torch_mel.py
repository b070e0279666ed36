"""PyTorch port: ops/mel.py against the JAX package on the same waves.

Tolerances: the filterbank is the same numpy f64 code (exact); the power
spectrum goes through an f32 rfft in both packages (rtol 1e-4 plus an atol of
1e-4 of the largest power); the normalized log-mel is a log of that, clipped
into [0, 1]: atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.ops import mel as jax_mel
from vqvae_speech_tpu_torch.ops import mel


def waves(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 22050.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    return (tone + 0.1 * rng.standard_normal(shape)).astype(np.float32)


def test_filterbank_is_the_jax_packages():
    for kw in (dict(), dict(sr=16000, n_fft=512, n_mels=40, fmin=0.0,
                            fmax=8000.0)):
        np.testing.assert_array_equal(mel.mel_filterbank_slaney(**kw),
                                      jax_mel.mel_filterbank_slaney(**kw))


@pytest.mark.parametrize("shape,n_fft,hop", [((4000,), 1024, 256),
                                             ((2, 3000), 512, 128)])
def test_stft_power_matches_jax(shape, n_fft, hop):
    y = waves(shape)
    want = np.asarray(jax_mel.stft_power(jnp.asarray(y), n_fft, hop))
    got = mel.stft_power(torch.from_numpy(y), n_fft, hop).numpy()
    assert got.shape == want.shape == shape[:-1] + (1 + shape[-1] // hop,
                                                    1 + n_fft // 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())


@pytest.mark.parametrize("shape", [(5120,), (3, 2048)])
def test_normalized_log_mel_matches_jax(shape):
    y = waves(shape, seed=1)
    want = np.asarray(jax_mel.normalized_log_mel(jnp.asarray(y)))
    got = mel.normalized_log_mel(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == shape[:-1] + (1 + shape[-1] // 256, 80)
    assert got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_melspectrogram_matches_jax():
    y = waves((4096,), seed=2)
    want = np.asarray(jax_mel.melspectrogram(jnp.asarray(y)))
    got = mel.melspectrogram(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
