"""PyTorch port: ``data/synthetic_phonemes.py`` is a copy of the JAX
package's (the port imports nothing of it): both write the same corpus
tree, file for file and byte for byte, for the simple and the rich corpus,
and return the same values."""
import os

import pytest

from vqvae_speech_tpu.data import synthetic_phonemes as jsp
from vqvae_speech_tpu_torch.data import synthetic_phonemes as tsp


def _tree(root):
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


@pytest.mark.parametrize("builder, kwargs", [
    ("build_phoneme_corpus", dict(num_speakers=2, utts_per_speaker=3,
                                  seed=3)),
    ("build_rich_phoneme_corpus", dict(num_speakers=2, utts_per_speaker=2,
                                       seed=5)),
])
def test_corpus_is_byte_equal_to_jax(tmp_path, builder, kwargs):
    got = getattr(tsp, builder)(str(tmp_path / "torch"), **kwargs)
    want = getattr(jsp, builder)(str(tmp_path / "jax"), **kwargs)
    assert got[1:] == want[1:]
    got_files, want_files = _tree(tmp_path / "torch"), _tree(tmp_path / "jax")
    assert sorted(got_files) == sorted(want_files)
    assert any(name.endswith(".TextGrid") for name in got_files)
    for name, data in want_files.items():
        assert got_files[name] == data, name


def test_module_constants_equal_jax():
    assert tsp.PHONEME_SPECS == jsp.PHONEME_SPECS
    public = sorted(n for n in vars(jsp) if n.isupper())
    assert public == sorted(n for n in vars(tsp) if n.isupper())
    for name in public:
        assert getattr(tsp, name) == getattr(jsp, name), name
