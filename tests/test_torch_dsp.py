"""PyTorch port: speech features against the JAX package (rfft branch)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vqvae_speech_tpu.ops import dsp as jdsp
from vqvae_speech_tpu_torch.ops import dsp as tdsp


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("name", ["mfcc", "logfbank"])
@pytest.mark.parametrize("n", [4000, 7680])
def test_speech_features_match_jax(name, n):
    """f32 waves, batch of 2, with delta and delta-delta: rtol/atol 1e-4."""
    waves = np.stack([_wave(n, 0), _wave(n, 1)])
    want = np.asarray(jdsp.speech_features(name, jnp.asarray(waves), 16000,
                                           13, True))
    got = tdsp.speech_features(name, torch.from_numpy(waves), 16000, 13, True)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_silent_frames_keep_the_eps_floor():
    """All-zero input hits the f32 eps floors on energy and filterbank (log
    stays finite), as in the JAX package. The cepstra of a constant log(eps)
    are zero up to rounding in the DCT matmul, hence atol 1e-4 here too."""
    waves = np.zeros((1, 4000), np.float32)
    want = np.asarray(jdsp.speech_features("mfcc", jnp.asarray(waves), 16000,
                                           13, False))
    got = tdsp.speech_features("mfcc", torch.from_numpy(waves), 16000, 13, False)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_num_frames_and_constants_are_the_jax_ones():
    assert tdsp.num_frames(7680, 400, 160) == jdsp.num_frames(7680, 400, 160) == 47
    np.testing.assert_array_equal(tdsp.mel_filterbank(26, 512, 16000),
                                  jdsp.mel_filterbank(26, 512, 16000))
    np.testing.assert_array_equal(tdsp._dct2_ortho_matrix(26, 13),
                                  jdsp._dct2_ortho_matrix(26, 13))
    np.testing.assert_array_equal(tdsp._lifter_vector(13, 22),
                                  jdsp._lifter_vector(13, 22))
