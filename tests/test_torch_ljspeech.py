"""PyTorch port: the LJSpeech pipeline (``data/ljspeech.py``) against the
JAX package's on the synthetic mini-corpus of tests/test_ljspeech_vocoder.py
(1 s tones at 22050 Hz plus noise).

Tolerances: the audio arrays bit-equal (the same numpy and scipy code, and
mu-law bins from the same f32 formula); the mel frames within 1e-5 (a
torch and a JAX FFT: measured ~1e-6 on values in [0, 1]); train.txt, the
split and the loader's crops (the same numpy generator) equal.
"""
import os

import numpy as np
import pytest

from tests.test_ljspeech_vocoder import _mini_ljspeech
from tests.test_torch_vocoder_train import one_torch_thread  # noqa: F401
from vqvae_speech_tpu.data import ljspeech as jax_ljspeech
from vqvae_speech_tpu_torch.data import ljspeech

MEL_ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lj"))
    _mini_ljspeech(root, n=6)
    return root


def both_preprocessed(root, input_type):
    out = {}
    for name, module in (("jax", jax_ljspeech), ("port", ljspeech)):
        d = os.path.join(root, f"{name}_{input_type}")
        meta = module.preprocess(root, d, input_type=input_type)
        out[name] = (d, meta)
    return out


@pytest.mark.parametrize("input_type", ["raw", "mulaw-quantize"])
def test_preprocess_writes_the_jax_files(corpus, input_type):
    out = both_preprocessed(corpus, input_type)
    (jdir, jmeta), (pdir, pmeta) = out["jax"], out["port"]
    assert pmeta == jmeta and len(pmeta) == 6
    with open(os.path.join(jdir, "train.txt")) as f, \
            open(os.path.join(pdir, "train.txt")) as g:
        assert f.read() == g.read()
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for audio, mel, steps, _ in pmeta:
        a, b = np.load(os.path.join(pdir, audio)), np.load(
            os.path.join(jdir, audio))
        assert a.dtype == b.dtype == (np.int16 if input_type != "raw"
                                      else np.float32)
        np.testing.assert_array_equal(a, b)
        m, n = np.load(os.path.join(pdir, mel)), np.load(
            os.path.join(jdir, mel))
        assert m.dtype == np.float32 and m.shape == n.shape
        assert len(a) == steps == m.shape[0] * ljspeech.HOP_LENGTH
        np.testing.assert_allclose(m, n, rtol=0, atol=MEL_ATOL)


def test_silence_indices_match():
    rng = np.random.default_rng(0)
    q = np.full(500, 128, np.int32)
    q[40:460] = rng.integers(0, 256, 420)
    q[41:60] = 128
    for args in ((2, 128), (5, 128), (0, 100)):
        assert (ljspeech.start_and_end_indices(q, *args)
                == jax_ljspeech.start_and_end_indices(q, *args))
    silent = np.full(10, 128)
    assert ljspeech.start_and_end_indices(silent) == (0, 10)


def test_split_and_loader_batches_equal_jax(corpus):
    pdir = os.path.join(corpus, "loader_port")
    ljspeech.preprocess(corpus, pdir)
    for train in (True, False):
        got = ljspeech.LJSpeechDataset(pdir, train=train, test_size=0.34)
        want = jax_ljspeech.LJSpeechDataset(pdir, train=train,
                                            test_size=0.34)
        assert got.audio_paths == want.audio_paths
        assert got.lengths == want.lengths
        assert len(got) == (4 if train else 2)
    ds = ljspeech.LJSpeechDataset(pdir, train=True, test_size=0.34)
    jds = jax_ljspeech.LJSpeechDataset(pdir, train=True, test_size=0.34)
    # crops shorter than the clips (random starts) and longer (padding)
    for steps in (2048, 6400, 30000):
        got = ljspeech.LJSpeechLoader(ds, 2, seed=3, max_time_steps=steps)
        want = jax_ljspeech.LJSpeechLoader(jds, 2, seed=3,
                                           max_time_steps=steps)
        assert len(got) == len(want) == 2
        for _ in range(2):                      # two epochs
            for a, b in zip(got, want):
                assert a.keys() == b.keys() == {"x", "y", "c"}
                for k in a:
                    assert a[k].dtype == np.float32
                    np.testing.assert_array_equal(a[k], b[k])
                frames = (steps - steps % 256) // 256
                assert a["x"].shape == (2, frames * 256, 1)
                assert a["c"].shape == (2, frames, 80)
