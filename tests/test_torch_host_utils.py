"""The port's remaining host modules against the JAX package's:
utils/errors.py, utils/workspace.py, utils/logger.py::create_file_logger,
utils/profiling.py::trace and ::annotate (on the CPU), native.py (the C++
ingest, equal to the JAX package's native functions on the tracked VCTK
subset, and its numpy fallbacks), and the two examples that are not demos:
examples/encode_wav.py (codes equal to the JAX example's on a checkpoint JAX
trained, built as tests/test_demos.py builds it) and
examples/serve_vocoder.py at ``--tiny`` (waves within 1e-5 of JAX's
server's, the tolerance of tests/test_torch_parallel_serve.py, on checkpoints
JAX's vocoder trainer wrote, with JAX's draws fed through ``noises=``)."""
import argparse
import glob
import json
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import serve_vocoder as jax_serve_vocoder
from examples.encode_wav import main as jax_encode_main
from tests.test_torch_vocoder_train import one_torch_thread  # noqa: F401
from vqvae_speech_tpu import native as jax_native
from vqvae_speech_tpu.train import vocoder as jax_vocoder
from vqvae_speech_tpu.utils import errors as jax_errors
from vqvae_speech_tpu.utils import logger as jax_logger
from vqvae_speech_tpu.utils import workspace as jax_workspace
from vqvae_speech_tpu_torch import convert, native
from vqvae_speech_tpu_torch.data.audio import load_and_preprocess, load_wav
from vqvae_speech_tpu_torch.examples import serve_vocoder
from vqvae_speech_tpu_torch.examples.encode_wav import main as encode_main
from vqvae_speech_tpu_torch.models.clarinet import (
    GaussianWaveNetConfig,
    StudentConfig,
)
from vqvae_speech_tpu_torch.utils import errors, logger, workspace
from vqvae_speech_tpu_torch.utils.profiling import annotate, trace

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = sorted(glob.glob(os.path.join(
    REPO_ROOT, "quality_parity", "raw", "VCTK-Corpus", "wav48", "*",
    "*.wav")))


def test_only_throws_matches_jax():
    for mod in (errors, jax_errors):
        @mod.only_throws(ValueError)
        def f(kind):
            if kind == "value":
                raise ValueError("v")
            if kind == "key":
                raise KeyError("k")
            return kind

        assert f("ok") == "ok"
        with pytest.raises(ValueError):
            f("value")
        with pytest.raises(mod.InvalidRaiseException,
                           match="got KeyError, expected ValueError, from f"):
            f("key")
        assert f.__name__ == "f"


def test_clean_room_matches_jax(tmp_path):
    assert workspace.RUN_SUBDIRS == jax_workspace.RUN_SUBDIRS
    for sub in workspace.RUN_SUBDIRS + ("keep",):
        (tmp_path / sub / "x").mkdir(parents=True)
    workspace.clean_room(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["keep"]
    workspace.clean_room(str(tmp_path))   # nothing left to remove


def test_create_file_logger_matches_jax(tmp_path):
    got = logger.create_file_logger("port_host_utils", str(tmp_path / "a"),
                                    max_bytes=4096, backup_count=2)
    want = jax_logger.create_file_logger("jax_host_utils",
                                         str(tmp_path / "b"),
                                         max_bytes=4096, backup_count=2)
    try:
        assert logger.create_file_logger("port_host_utils",
                                          str(tmp_path / "a")) is got
        for lg in (got, want):
            (h,) = lg.handlers
            assert (h.maxBytes, h.backupCount, lg.level) == (4096, 2,
                                                             logging.INFO)
        assert (got.handlers[0].formatter._fmt
                == want.handlers[0].formatter._fmt)
        got.info("hello %d", 3)
        got.handlers[0].flush()
        text = (tmp_path / "a" / "port_host_utils.log").read_text()
        assert text.rstrip().endswith("INFO port_host_utils: hello 3")
    finally:
        for lg in (got, want):
            for h in list(lg.handlers):
                h.close()
                lg.removeHandler(h)


def test_trace_and_annotate_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "tr")) as t:
        with annotate("port_region"):
            torch.ones(64).cumsum(0)
    assert os.path.dirname(t.path) == str(tmp_path / "tr")
    with open(t.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "port_region" in names
    assert t.events == []           # no card: host activity only


@pytest.fixture(scope="module")
def both_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("native library unavailable (no g++?)")


def test_native_matches_jax_native_on_the_corpus(both_native):
    for wav in WAVS[::20]:
        y = load_wav(wav)
        assert native.rms_trim_bounds(y) == jax_native.rms_trim_bounds(y)
        assert (native.rms_trim_bounds(y, 1024, 256, 30.0)
                == jax_native.rms_trim_bounds(y, 1024, 256, 30.0))
        np.testing.assert_array_equal(native.peak_normalize(y),
                                      jax_native.peak_normalize(y))
        for mu in (256, 65536):
            np.testing.assert_array_equal(
                native.mu_law_encode_native(y, mu),
                jax_native.mu_law_encode_native(y, mu))
    z = np.zeros(16, np.float32)
    np.testing.assert_array_equal(native.peak_normalize(z), z)


def test_native_fallbacks_match_the_library(both_native, monkeypatch):
    """Without the library, the port's numpy and torch paths give what the
    library gives, and so does load_and_preprocess."""
    signals = [load_wav(w) for w in WAVS[::80]]
    lib = [(native.rms_trim_bounds(y), native.peak_normalize(y),
            native.mu_law_encode_native(y)) for y in signals]
    loaded = [load_and_preprocess(w) for w in WAVS[::80]]
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    assert native.wsola_time_stretch_native(signals[0], 0.9) is None
    for y, (bounds, peak, mu) in zip(signals, lib):
        assert native.rms_trim_bounds(y) == bounds
        np.testing.assert_array_equal(native.peak_normalize(y), peak)
        np.testing.assert_array_equal(native.mu_law_encode_native(y), mu)
    for w, (audio, trim) in zip(WAVS[::80], loaded):
        got_audio, got_trim = load_and_preprocess(w)
        np.testing.assert_array_equal(got_audio, audio)
        assert got_trim == trim


def test_encode_wav_matches_jax_example(tmp_path, capsys):
    from tests.test_eval import _full_setup
    from vqvae_speech_tpu.data.vctk import VCTK

    root, _, _ = _full_setup(tmp_path)
    wav = VCTK(root, shuffle_seed=0).audios[0]
    args = ["--wav", wav,
            "--experiments_path", os.path.join(root, "experiments"),
            "--experiment_name", "ev",
            "--normalizer_path", os.path.join(root, "stats.pickle")]
    assert jax_encode_main(args + ["--out", str(tmp_path / "jax.npy")]) == 0
    capsys.readouterr()
    assert encode_main(args + ["--out", str(tmp_path / "port.npy"),
                               "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    want, got = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert got.shape == (24,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert printed.splitlines()[1] == " ".join(str(int(c)) for c in want)


# ---- serve_vocoder --tiny ----

def _jax_checkpoint(path, tree):
    """A checkpoint written by the JAX package's vocoder trainer."""
    state = jax_vocoder.create_vocoder_state(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, tree),
        jax_vocoder.make_vocoder_optimizer(1e-3, 1.0))
    trainer = jax_vocoder.VocoderTrainer(None, state, None,
                                         os.path.dirname(path),
                                         os.path.basename(path))
    return trainer.save(0, 0.0)


def test_serve_vocoder_tiny_matches_jax(tmp_path, capsys):
    teacher = convert.numpy_gaussian_wavenet_params(GaussianWaveNetConfig(
        num_blocks=1, num_layers=2, front_channels=4, residual_channels=8,
        gate_channels=8, skip_channels=8, kernel_size=2, cin_channels=80,
        upsample_scales=(16, 16)), 1)
    student = convert.numpy_student_params(StudentConfig(
        num_blocks_student=(1, 1), num_layers=2, front_channels=4,
        residual_channels=8, gate_channels=8, skip_channels=8,
        kernel_size=3, cin_channels=80), 2)
    t_path = _jax_checkpoint(str(tmp_path / "ck" / "teacher"), teacher)
    s_path = _jax_checkpoint(str(tmp_path / "ck" / "student"), student)
    rng = np.random.default_rng(0)
    mel_paths = []
    for i, n in enumerate((20, 40, 33)):
        mel_paths.append(str(tmp_path / f"m{i}.npy"))
        np.save(mel_paths[-1], rng.random((n, 80)).astype(np.float32))
    argv = ["--kind", "iaf_student", "--checkpoint", s_path,
            "--teacher_checkpoint", t_path, "--mels", *mel_paths,
            "--out_dir", str(tmp_path / "synth"), "--tiny"]
    conds = [np.load(p) for p in mel_paths]

    jax_args = argparse.Namespace(
        kind="iaf_student", checkpoint=s_path, teacher_checkpoint=t_path,
        buckets=[32, 64, 128], max_batch=8, temp=0.8, bf16=False, tiny=True)
    with jax.enable_x64(False):
        want = jax_serve_vocoder.build_server(jax_args).synthesize(conds,
                                                                   seed=0)
        key = jax.random.PRNGKey(0)
        noises = [np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), (b * 256, 1), jnp.float32))
            for i, b in enumerate((32, 64, 64))]
    server = serve_vocoder.build_server(
        serve_vocoder.parse_args(argv + ["--device", "cpu"]))
    got = server.synthesize(conds, seed=0, noises=noises)
    for c, g, w in zip(conds, got, want):
        assert g.bucket == w.bucket and g.wave.shape == (c.shape[0] * 256,)
        np.testing.assert_allclose(g.wave, w.wave, rtol=0, atol=1e-5)
    assert server.stats["launches"] == 2   # buckets 32 and 64, max_batch 8

    assert serve_vocoder.main(argv + ["--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "launches: 2" in printed
    for i, n in enumerate((20, 40, 33)):
        from scipy.io import wavfile
        rate, wave = wavfile.read(str(tmp_path / "synth" / f"m{i}.wav"))
        assert rate == 22050 and wave.shape == (n * 256,)
    with open(s_path, "rb") as f:
        assert set(pickle.load(f)) >= {"params", "ema_params"}
