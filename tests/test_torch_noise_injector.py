"""The port's host augmentation (data/noise_injector.py,
data/spectrogram_dataset.py) against the JAX package's, on the tracked VCTK
subset (quality_parity/raw) and on the speech-like signal of
tests/test_aux.py, under the same ``np.random.Generator`` seeds: WSOLA
(numpy and native), ``augment_tempo_gain``, ``NoiseInjector`` and
``SpectrogramDataset`` items, all bit-equal. The port's augmentation takes
the numpy WSOLA whether or not its C++ library is present, so it is held
against JAX's with JAX's library hidden (JAX defaults to the C++ form).

The two WSOLA forms agree with each other only to JAX's own tolerance
(tests/test_aux.py: rtol 1e-4, atol 1e-5, equal lengths): the C++ window is
computed in f32, numpy's in f64 and rounded, and their samples part by an
ulp (1.2e-7 on the tracked wavs).
"""
import glob
import os

import numpy as np
import pytest

from vqvae_speech_tpu import native as jax_native
from vqvae_speech_tpu.data import noise_injector as jax_noise
from vqvae_speech_tpu.data import spectrogram_dataset as jax_spect
from vqvae_speech_tpu_torch import native
from vqvae_speech_tpu_torch.data import noise_injector, spectrogram_dataset
from vqvae_speech_tpu_torch.data.audio import load_wav

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = sorted(glob.glob(os.path.join(
    REPO_ROOT, "quality_parity", "raw", "VCTK-Corpus", "wav48", "*",
    "*.wav")))
TEMPOS = (0.4, 0.85, 0.95, 1.1, 1.15)


@pytest.fixture(scope="module")
def both_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("native library unavailable (no g++?)")


def _speech_like():
    sr = 16000
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * 0.8)) / sr
    phase = 2 * np.pi * np.cumsum(150 * (1 + 0.2 * t)) / sr
    return (0.5 * np.sin(phase) + 0.2 * np.sin(2 * phase)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _signals():
    return [_speech_like()] + [load_wav(w) for w in WAVS[::100]]


def test_wsola_numpy_bit_equal_to_jax():
    for x in _signals():
        for tempo in TEMPOS:
            got = noise_injector.wsola_time_stretch(x, tempo,
                                                    use_native=False)
            want = jax_noise.wsola_time_stretch(x, tempo, use_native=False)
            np.testing.assert_array_equal(got, want)
    for x in (np.zeros(0, np.float32), np.ones(100, np.float32)):
        np.testing.assert_array_equal(
            noise_injector.wsola_time_stretch(x, 1.2, use_native=False), x)


def test_wsola_native_bit_equal_to_jax_native(both_native):
    x = _speech_like()
    for signal in _signals():
        for tempo in TEMPOS:
            np.testing.assert_array_equal(
                native.wsola_time_stretch_native(signal, tempo),
                jax_native.wsola_time_stretch_native(signal, tempo))
        # the C++ form on request, JAX's by default
        np.testing.assert_array_equal(
            noise_injector.wsola_time_stretch(signal, 0.9, use_native=True),
            jax_noise.wsola_time_stretch(signal, 0.9))
    # odd lengths x irrational-ish tempos: the buffer-sizing contract
    for n in (12801, 13007):
        for tempo in np.linspace(0.35, 1.6, 9):
            got = native.wsola_time_stretch_native(x[:n], float(tempo))
            want = noise_injector.wsola_time_stretch(x[:n], float(tempo),
                                                     use_native=False)
            assert got.shape == want.shape, (n, tempo)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(native.wsola_time_stretch_native(x, 1.0),
                                  x)


@pytest.mark.parametrize("port_library", [True, False])
def test_augment_tempo_gain_bit_equal_to_jax(port_library, monkeypatch):
    """Both packages' augmentation under one generator seed, through JAX's
    numpy WSOLA (its library hidden): the port's takes numpy whether its own
    library is present or hidden."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    if port_library:
        monkeypatch.setattr(native, "_load", lambda: pytest.fail(
            "the default WSOLA reached the C++ library"))
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    x = load_wav(WAVS[0])
    for seed in range(3):
        got = noise_injector.augment_tempo_gain(
            x, rng=np.random.default_rng(seed))
        want = jax_noise.augment_tempo_gain(x, rng=np.random.default_rng(seed))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _noise_dir(tmp_path):
    """Two tracked wavs, one of them in a subdirectory."""
    root = tmp_path / "noise"
    (root / "sub").mkdir(parents=True)
    for src, dst in ((WAVS[1], root / "a.wav"),
                     (WAVS[2], root / "sub" / "b.wav")):
        os.symlink(src, dst)
    return str(root)


def test_noise_injector_bit_equal_to_jax(tmp_path):
    root = _noise_dir(tmp_path)
    got = noise_injector.NoiseInjector(root, noise_levels=(0.1, 0.6),
                                       rng=np.random.default_rng(4))
    want = jax_noise.NoiseInjector(root, noise_levels=(0.1, 0.6),
                                   rng=np.random.default_rng(4))
    assert got.paths == want.paths and len(got.paths) == 2
    # a long and a short clean signal (the noise is looped for the latter)
    for clean in (load_wav(WAVS[3]), np.tile(load_wav(WAVS[4]), 3)):
        for _ in range(3):
            a = got.inject_noise(clean.copy())
            b = want.inject_noise(clean.copy())
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    silent = np.zeros(1000, np.float32)
    np.testing.assert_array_equal(
        got.inject_noise_sample(silent, got.paths[0], 0.5),
        want.inject_noise_sample(silent, want.paths[0], 0.5))


def test_noise_injector_refuses_missing_or_empty_dirs(tmp_path):
    with pytest.raises(IOError):
        noise_injector.NoiseInjector(str(tmp_path / "nope"))
    with pytest.raises(IOError):
        noise_injector.NoiseInjector(None)
    (tmp_path / "empty").mkdir()
    with pytest.raises(IOError):
        noise_injector.NoiseInjector(str(tmp_path / "empty"))


def _manifest(tmp_path, n=4):
    lines = []
    for i, wav in enumerate(WAVS[:n]):
        txt = tmp_path / f"t{i}.txt"
        txt.write_text(f"utterance {i}\n", encoding="utf-8")
        lines.append(f"{wav},{txt}")
    path = tmp_path / "manifest.csv"
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


@pytest.mark.parametrize("augment,normalize", [(False, False), (True, True)])
def test_spectrogram_dataset_bit_equal_to_jax(tmp_path, augment, normalize,
                                              monkeypatch):
    # JAX's augmentation on its numpy WSOLA, the port's default
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    manifest = _manifest(tmp_path)
    got = spectrogram_dataset.SpectrogramDataset(
        manifest, normalize=normalize, augment=augment,
        rng=np.random.default_rng(5))
    want = jax_spect.SpectrogramDataset(
        manifest, normalize=normalize, augment=augment,
        rng=np.random.default_rng(5))
    assert len(got) == len(want) == 4
    for i in range(4):
        (gs, gt), (ws, wt) = got[i], want[i]
        assert gt == wt == f"utterance {i}"
        assert gs.shape[0] == 161
        np.testing.assert_array_equal(gs, ws)
