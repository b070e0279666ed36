"""PyTorch port: the data modules against the JAX package's.

The copies (``data/textgrid.py``, ``data/vctk.py``, ``data/feature_store.py``,
``utils/logger.py`` and ``data/audio.py::pad_or_random_crop``) must give what
the JAX package gives, bit for bit, on the tracked VCTK subset
(``quality_parity/raw``: 8 speakers, 400 wavs, TextGrids and transcripts).
The synthetic store's waves, speakers and metadata are equal; its features
come from the port's ``ops.speech_features`` and are held to the MFCC
tolerance of ``tests/test_torch_dsp.py`` (rtol/atol 1e-4).
"""
import glob
import os
import pickle

import numpy as np
import pytest

from vqvae_speech_tpu.data import audio as jaudio
from vqvae_speech_tpu.data import feature_store as jstore
from vqvae_speech_tpu.data import synthetic as jsynthetic
from vqvae_speech_tpu.data import textgrid as jtextgrid
from vqvae_speech_tpu.data import vctk as jvctk
from vqvae_speech_tpu.utils import logger as jlogger
from vqvae_speech_tpu_torch.data import audio as taudio
from vqvae_speech_tpu_torch.data import feature_store as tstore
from vqvae_speech_tpu_torch.data import synthetic as tsynthetic
from vqvae_speech_tpu_torch.data import textgrid as ttextgrid
from vqvae_speech_tpu_torch.data import vctk as tvctk
from vqvae_speech_tpu_torch.utils import logger as tlogger

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_ROOT = os.path.join(REPO_ROOT, "quality_parity")
CORPUS = os.path.join(CORPUS_ROOT, "raw", "VCTK-Corpus")
TEXTGRIDS = sorted(glob.glob(os.path.join(CORPUS, "phonemes", "*", "*.TextGrid")))
# a dozen utterances over six speakers (9600 samples each: cropped to 7681)
WAVS = [os.path.join(CORPUS, "wav48", f"p30{s}", f"p30{s}_{i:03d}.wav")
        for s in range(6) for i in (s, 40 + s)]


def _grid(tg):
    return [(t.name, [(iv.minTime, iv.maxTime, iv.mark) for iv in t])
            for t in tg.tiers]


def test_textgrid_reader_equals_jax_on_the_corpus():
    assert len(TEXTGRIDS) == 400
    for path in TEXTGRIDS:
        want, got = jtextgrid.read_textgrid(path), ttextgrid.read_textgrid(path)
        assert _grid(got) == _grid(want), path
        assert (ttextgrid.leading_silence_duration(path)
                == jtextgrid.leading_silence_duration(path))
        assert ttextgrid.phoneme_marks(path) == jtextgrid.phoneme_marks(path)


def _silence_textgrid(path, silences=(0.125, 0.0625)):
    """A two-tier TextGrid whose phoneme tier opens with 'sil' intervals."""
    marks, t = [], 0.0
    for d in silences:
        marks.append((t, t + d, "sil"))
        t += d
    marks += [(t, t + 0.25, "AH"), (t + 0.25, t + 0.5, "sil")]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {t + 0.5}", "tiers? <exists>", "size = 2",
             "item []:"]
    for number, (name, tier) in enumerate(
            (("words", [(0.0, t + 0.5, "utt")]), ("phonemes", marks)), 1):
        lines += [f"    item [{number}]:", '        class = "IntervalTier"',
                  f'        name = "{name}"', "        xmin = 0",
                  f"        xmax = {t + 0.5}",
                  f"        intervals: size = {len(tier)}"]
        for i, (lo, hi, mark) in enumerate(tier, 1):
            lines += [f"        intervals [{i}]:", f"            xmin = {lo}",
                      f"            xmax = {hi}", f'            text = "{mark}"']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_textgrid_leading_silence_equals_jax(tmp_path):
    path = str(tmp_path / "p301_007.TextGrid")
    _silence_textgrid(path)
    assert _grid(ttextgrid.read_textgrid(path)) == _grid(
        jtextgrid.read_textgrid(path))
    got = ttextgrid.leading_silence_duration(path)
    assert got == jtextgrid.leading_silence_duration(path) == 0.1875
    assert ttextgrid.leading_silence_duration(path, tier_index=2) == 0.0


@pytest.mark.parametrize("n, length, seed", [(100, 160, 0), (160, 160, 0),
                                             (1000, 160, 3), (7681, 7681, 1),
                                             (20000, 7681, 5)])
def test_pad_or_random_crop_equals_jax(n, length, seed):
    audio = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
    want, want_start = jaudio.pad_or_random_crop(
        audio, length, np.random.default_rng(seed))
    got, got_start = taudio.pad_or_random_crop(
        audio, length, np.random.default_rng(seed))
    assert got_start == want_start
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shuffle_seed", [0, 1234])
def test_vctk_manifest_speakers_and_split_equal_jax(shuffle_seed):
    want = jvctk.VCTK(CORPUS_ROOT, ratio=0.8, shuffle_seed=shuffle_seed)
    got = tvctk.VCTK(CORPUS_ROOT, ratio=0.8, shuffle_seed=shuffle_seed)
    assert len(got.audios) == 400
    assert (got.audios_train, got.audios_val) == (want.audios_train,
                                                  want.audios_val)
    assert len(got.audios_train) == 320
    assert got.speaker_dic == want.speaker_dic == {
        f"p30{i}": i for i in range(8)}
    assert got.utterences == want.utterences and len(got.utterences) == 400
    assert tvctk.make_manifest(CORPUS) == jvctk.make_manifest(CORPUS)
    assert all(tvctk.textgrid_path_for_wav(w) == jvctk.textgrid_path_for_wav(w)
               for w in got.audios)
    assert os.path.isfile(tvctk.textgrid_path_for_wav(got.audios[0]))


def test_vctk_download_raises_and_a_missing_corpus_is_named(tmp_path):
    with pytest.raises(NotImplementedError, match="does not download"):
        tvctk.VCTK(str(tmp_path), download=True)
    with pytest.raises(FileNotFoundError, match="VCTK corpus not found"):
        tvctk.VCTK(str(tmp_path))


def _preprocessed(module, path, seed, length=7680):
    speaker_dic = {f"p30{i}": i for i in range(8)}
    return module.preprocess_utterance(path, speaker_dic, 16000, 20, length,
                                       256, np.random.default_rng(seed))


def _assert_same_item(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value and type(got[key]) is type(value), key


@pytest.mark.parametrize("index", range(len(WAVS)))
def test_preprocess_utterance_equals_jax(index):
    """TextGrid silence cut, peak normalization, crop or pad, mu-law bins:
    the same floats and bins as the JAX package's (whose bins come from its
    native encoder)."""
    want = _preprocessed(jvctk, WAVS[index], index)
    got = _preprocessed(tvctk, WAVS[index], index)
    _assert_same_item(got, want)
    assert got["preprocessed_audio"].shape == (7681,)


def _padded_corpus_wav(tmp_path):
    """VCTK-Corpus/wav48/p301/p301_007.wav: a corpus utterance (16 kHz)
    between 0.25 s of faint noise before and 0.125 s after."""
    from scipy.io import wavfile

    rate, wave = wavfile.read(WAVS[2])
    noise = np.random.default_rng(0).integers(-3, 4, rate // 4)
    padded = np.concatenate([noise, wave, noise[:rate // 8]]).astype(
        wave.dtype)
    corpus = tmp_path / "VCTK-Corpus"
    (corpus / "wav48" / "p301").mkdir(parents=True)
    (corpus / "phonemes" / "p301").mkdir(parents=True)
    path = str(corpus / "wav48" / "p301" / "p301_007.wav")
    wavfile.write(path, rate, padded)
    return path, str(corpus / "phonemes" / "p301" / "p301_007.TextGrid")


def test_preprocess_utterance_silence_cuts_equal_jax(tmp_path):
    """Without a TextGrid beside the wav the RMS trim cuts the silence; with
    one, its leading 'sil' intervals do."""
    path, textgrid = _padded_corpus_wav(tmp_path)
    for length in (7680, None):
        want = _preprocessed(jvctk, path, 7, length)
        got = _preprocessed(tvctk, path, 7, length)
        _assert_same_item(got, want)
        assert got["shifting_time"] > 0
    _silence_textgrid(textgrid)
    for length in (7680, None):
        want = _preprocessed(jvctk, path, 7, length)
        got = _preprocessed(tvctk, path, 7, length)
        _assert_same_item(got, want)
    assert got["shifting_time"] == 0.1875


def _random_store(module, root, n=13, width_out=39, seed=0):
    rng = np.random.default_rng(seed)
    store = module.FeatureStore(root)
    store.write("train",
                rng.normal(5.0, 3.0, (n, 11, 39)).astype(np.float32),
                rng.normal(2.0, 1.0, (n, 11, width_out)).astype(np.float32),
                rng.integers(0, 4, n).astype(np.int32),
                metadata={"wav_filenames": [f"p{i}.wav" for i in range(n)]},
                preprocessed_audio=rng.uniform(-1, 1, (n, 64)).astype(
                    np.float32))
    return store


def test_feature_store_files_and_stats_equal_jax(tmp_path):
    _random_store(jstore, str(tmp_path / "jax"))
    _random_store(tstore, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name
    port_store = tstore.FeatureStore(str(tmp_path / "jax"))
    assert port_store.num_examples("train") == 13
    assert port_store.metadata("train")["wav_filenames"][0] == "p0.wav"
    want = jstore.compute_dataset_stats(jstore.FeatureStore(
        str(tmp_path / "jax")), str(tmp_path / "jax_stats.pickle"))
    got = tstore.compute_dataset_stats(port_store,
                                       str(tmp_path / "port_stats.pickle"))
    loaded = tstore.load_normalizer(str(tmp_path / "jax_stats.pickle"))
    for key in ("train_mean", "train_std"):
        assert got[key].dtype == want[key].dtype == np.float64
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(loaded[key], want[key])
    with open(tmp_path / "port_stats.pickle", "rb") as f:
        assert set(pickle.load(f)) == {"train_mean", "train_std"}


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("width_out", [39, 79])
def test_feature_loader_batches_equal_jax(tmp_path, seed, normalized,
                                          width_out):
    """Two epochs of shuffled batches, bit-equal; the normalizer whitens the
    outputs only when their width is the stats' (the width-mismatch rule)."""
    _random_store(jstore, str(tmp_path), width_out=width_out)
    normalizer = None
    if normalized:
        normalizer = jstore.compute_dataset_stats(
            jstore.FeatureStore(str(tmp_path)), str(tmp_path / "s.pickle"))
    loaders = [m.FeatureLoader(m.FeatureStore(str(tmp_path)), "train", 4,
                               normalizer=normalizer, seed=seed)
               for m in (jstore, tstore)]
    assert len(loaders[1]) == len(loaders[0]) == 3
    raw_out = np.load(tmp_path / "train.output_features.npy")
    for _ in range(2):
        epochs = [list(loader) for loader in loaders]
        assert len(epochs[1]) == len(epochs[0]) == 3
        for want, got in zip(*epochs):
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], key)
            moved = not np.array_equal(got["output_features"],
                                       raw_out[got["index"]])
            assert moved == (normalized and width_out == 39)
    ordered = list(tstore.FeatureLoader(tstore.FeatureStore(str(tmp_path)),
                                        "train", 5, shuffle=False,
                                        drop_last=False))
    assert [len(b["index"]) for b in ordered] == [5, 5, 3]


def test_synthetic_store_equals_jax(tmp_path):
    want = jsynthetic.build_synthetic_store(str(tmp_path / "jax"), 6, 2,
                                            seed=3)
    got = tsynthetic.build_synthetic_store(str(tmp_path / "port"), 6, 2,
                                           seed=3, device="cpu")
    for split in ("train", "val"):
        a, b = want.open(split), got.open(split)
        assert sorted(a.files) == sorted(b.files)
        for column in ("speaker_ids", "preprocessed_audio"):
            assert b[column].dtype == a[column].dtype
            np.testing.assert_array_equal(b[column], a[column])
        for column in ("input_features", "output_features"):
            assert b[column].shape == a[column].shape == (
                {"train": 6, "val": 2}[split], 47, 39)
            np.testing.assert_allclose(b[column], a[column], rtol=1e-4,
                                       atol=1e-4)
        assert got.metadata(split) == want.metadata(split)


def test_console_logger_equals_jax(capsys):
    for module in (jlogger, tlogger):
        for level in ("status", "success", "warn", "error", "critical"):
            getattr(module.ConsoleLogger, level)(f"{level} message")
    out = capsys.readouterr().out.splitlines()
    assert out[:5] == out[5:] and "[WARN] warn message" in out[2]
