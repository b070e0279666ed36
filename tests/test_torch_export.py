"""PyTorch port: the feature export against the JAX package's.

A slice of the tracked VCTK subset (two speakers, ten utterances each, a
seeded split) goes through both packages' exports. ``preprocessed_audio``,
the speaker ids and the metadata must be equal; the features come from the
port's ``ops.speech_features`` and are held to the MFCC tolerance of
``tests/test_torch_dsp.py`` (rtol/atol 1e-4). The fault tolerance (an
unreadable wav is skipped), the invalid-shape skip and the resume rule (an
existing split is kept) behave as JAX's do.
"""
import json
import os

import numpy as np
import pytest

from vqvae_speech_tpu.data import export as jexport
from vqvae_speech_tpu.data import feature_store as jstore
from vqvae_speech_tpu.data import vctk as jvctk
from vqvae_speech_tpu_torch.data import export as texport
from vqvae_speech_tpu_torch.data import feature_store as tstore
from vqvae_speech_tpu_torch.data import vctk as tvctk
from vqvae_speech_tpu_torch.train import load_configuration

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO_ROOT, "quality_parity", "raw", "VCTK-Corpus")
CONFIG = load_configuration(os.path.join(REPO_ROOT, "configurations",
                                         "vctk_features.yaml"))


@pytest.fixture
def corpus_root(tmp_path):
    """<tmp>/vctk/raw/VCTK-Corpus with p300 and p301's first ten utterances
    (links into the tracked subset) and one unreadable wav."""
    root = tmp_path / "vctk"
    for sub in ("wav48", "txt", "phonemes"):
        for speaker in ("p300", "p301"):
            d = root / "raw" / "VCTK-Corpus" / sub / speaker
            d.mkdir(parents=True)
            for name in sorted(os.listdir(os.path.join(CORPUS, sub,
                                                       speaker)))[:10]:
                os.symlink(os.path.join(CORPUS, sub, speaker, name), d / name)
    (root / "raw" / "VCTK-Corpus" / "wav48" / "p301" / "p301_999.wav"
     ).write_bytes(b"not a wav")
    return str(root)


def _assert_stores_match(got_root, want_root, splits=("train", "val")):
    got, want = tstore.FeatureStore(got_root), jstore.FeatureStore(want_root)
    for split in splits:
        a, b = want.open(split), got.open(split)
        assert sorted(b.files) == sorted(a.files)
        for column in ("speaker_ids", "preprocessed_audio"):
            assert b[column].dtype == a[column].dtype
            np.testing.assert_array_equal(b[column], a[column])
        for column in ("input_features", "output_features"):
            assert b[column].shape == a[column].shape
            assert b[column].dtype == np.float32
            np.testing.assert_allclose(b[column], a[column], rtol=1e-4,
                                       atol=1e-4)
        assert got.metadata(split) == want.metadata(split)


def test_export_split_equals_jax(corpus_root, tmp_path):
    corpus = jvctk.VCTK(corpus_root, ratio=0.8, shuffle_seed=3)
    assert corpus.audios == tvctk.VCTK(corpus_root, ratio=0.8,
                                       shuffle_seed=3).audios
    assert len(corpus.audios) == 21
    jexport.export_split_to_features(
        corpus.audios_train, corpus.speaker_dic,
        jstore.FeatureStore(str(tmp_path / "jax")), "train", CONFIG,
        chunk_size=8, num_workers=4, seed=5)
    texport.export_split_to_features(
        corpus.audios_train, corpus.speaker_dic,
        tstore.FeatureStore(str(tmp_path / "port")), "train", CONFIG,
        chunk_size=8, num_workers=4, seed=5, device="cpu")
    _assert_stores_match(str(tmp_path / "port"), str(tmp_path / "jax"),
                         ("train",))
    store = tstore.FeatureStore(str(tmp_path / "port")).open("train")
    bad = [p for p in corpus.audios_train if p.endswith("p301_999.wav")]
    # 16 train files, the unreadable one among them skipped where drawn
    assert store["input_features"].shape == (16 - len(bad), 47, 39)
    assert store["preprocessed_audio"].shape == (16 - len(bad), 7681)
    meta = tstore.FeatureStore(str(tmp_path / "port")).metadata("train")
    assert len(meta["wav_filenames"]) == 16 - len(bad)


def test_export_to_features_keeps_an_existing_split(corpus_root, tmp_path,
                                                    capsys):
    corpus = tvctk.VCTK(corpus_root, ratio=0.8, shuffle_seed=1)
    jexport.export_to_features(corpus, str(tmp_path / "jax"), CONFIG,
                               num_workers=2)
    texport.export_to_features(corpus, str(tmp_path / "port"), CONFIG,
                               num_workers=2, device="cpu")
    _assert_stores_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    out = capsys.readouterr().out
    assert "skipping" in out and "p301_999.wav" in out
    marker = tmp_path / "port" / "val.meta.json"
    marker.write_text(json.dumps({"kept": True}))
    texport.export_to_features(corpus, str(tmp_path / "port"), CONFIG,
                               device="cpu")
    assert "already exported; skipping" in capsys.readouterr().out
    assert json.loads(marker.read_text()) == {"kept": True}
    texport.export_to_features(corpus, str(tmp_path / "port"), CONFIG,
                               overwrite=True, device="cpu")
    assert json.loads(marker.read_text()) != {"kept": True}


def test_export_skips_features_of_another_shape_as_jax_does(corpus_root,
                                                            tmp_path, capsys):
    """An input_features_dim the features do not have: nothing is saved, and
    both packages write the same empty split."""
    cfg = dict(CONFIG, input_features_dim=46)
    corpus = tvctk.VCTK(corpus_root, ratio=0.8, shuffle_seed=2)
    files = corpus.audios_val
    jexport.export_split_to_features(files, corpus.speaker_dic,
                                     jstore.FeatureStore(str(tmp_path / "jax")),
                                     "val", cfg)
    texport.export_split_to_features(files, corpus.speaker_dic,
                                     tstore.FeatureStore(str(tmp_path / "port")),
                                     "val", cfg, device="cpu")
    assert "will not be saved" in capsys.readouterr().out
    _assert_stores_match(str(tmp_path / "port"), str(tmp_path / "jax"),
                         ("val",))
    store = tstore.FeatureStore(str(tmp_path / "port")).open("val")
    assert store["input_features"].shape == (0, 47, 39)
    assert store["preprocessed_audio"].shape == (0, 7681)


def test_export_names_its_device(corpus_root, tmp_path):
    corpus = tvctk.VCTK(corpus_root, shuffle_seed=0)
    store = tstore.FeatureStore(str(tmp_path))
    with pytest.raises(TypeError, match="device"):
        texport.export_split_to_features(corpus.audios_val,
                                         corpus.speaker_dic, store, "val",
                                         CONFIG)
    assert not store.exists("val")
