"""PyTorch port: the wav loader against the JAX package's, on tracked VCTK
utterances. The JAX package peak-normalizes in its native ingest (a
multiply by the f32 reciprocal of the peak), which the port reproduces bit
for bit; without the native library it divides, which is within one f32
ulp of the same values (atol 6e-8 on [-1, 1])."""
import glob
import os

import numpy as np
import pytest

from vqvae_speech_tpu import native
from vqvae_speech_tpu.data import audio as jaudio
from vqvae_speech_tpu_torch.data import audio as taudio

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = sorted(glob.glob(os.path.join(
    REPO_ROOT, "quality_parity", "raw", "VCTK-Corpus", "wav48", "p300",
    "p300_00*.wav")))


@pytest.mark.parametrize("path", WAVS[:4], ids=os.path.basename)
def test_load_and_preprocess_matches_jax(path):
    want, want_t = jaudio.load_and_preprocess(path, 16000)
    got, got_t = taudio.load_and_preprocess(path, 16000)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got_t == want_t
    if native.available():
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)


def test_trim_silence_matches_jax():
    rng = np.random.default_rng(0)
    y = np.concatenate([1e-4 * rng.standard_normal(5000),
                        rng.standard_normal(8000),
                        1e-4 * rng.standard_normal(3000)]).astype(np.float32)
    got, got_bounds = taudio.trim_silence(y)
    want, want_bounds = jaudio.trim_silence(y)
    assert got_bounds == want_bounds
    np.testing.assert_array_equal(got, want)
    silent, bounds = taudio.trim_silence(np.zeros(4000, np.float32))
    assert bounds == (0, 4000) and len(silent) == 4000
