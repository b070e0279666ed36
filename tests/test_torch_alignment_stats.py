"""PyTorch port: ``eval/alignment_stats.py`` against the JAX package's, on
one checkpoint written once and a split whose size is not a multiple of
the sweep's batch of 32.

The port's copy of the synthetic phoneme corpus (``build_phoneme_corpus``:
five timbre "phonemes" with exact TextGrids, one speaker, 47 utterances)
goes through the port's export (a 0.8 split: 37 train utterances, so the
sweep's batches hold 32 and 5) and stats, and the port trains one epoch of
a tiny experiment on the CPU. On its ``train`` split:

* the groundtruth alignment pickles of both packages are equal
  (``possible_phonemes`` as a set),
* the empirical sequences of both pairings equal JAX's except near-tie
  rows (0 here), are int32 arrays, and the default pairing's mixing of
  batch items is JAX's (the last, short batch included),
* bigram matrices, frequencies, ARI/AMI/NMI and the average phoneme count
  computed by each package from its own files agree within 1e-12,
* each package reads the other's files: the JAX package's functions on the
  port's files return the port's numbers, and the port's on JAX's return
  JAX's,
* the port's pickles hold numpy arrays and builtins only, no tensor.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_evaluator import (
    Evaluator,
    assert_sequences_equal_or_near_tie,
    build_experiment,
    flat_rows,
)
from vqvae_speech_tpu.data import FeatureStore as JaxFeatureStore
from vqvae_speech_tpu.eval import alignment_stats as jstats
from vqvae_speech_tpu.train.checkpoint import latest_checkpoint_epoch
from vqvae_speech_tpu.train.checkpoint import load_checkpoint as jax_load
from vqvae_speech_tpu.train.experiment import _as_jax_tree
from vqvae_speech_tpu_torch.data import FeatureStore
from vqvae_speech_tpu_torch.data.synthetic_phonemes import build_phoneme_corpus
from vqvae_speech_tpu_torch.eval import alignment_stats as tstats
from vqvae_speech_tpu_torch.train import Experiments

SPLIT = "train"
N_UTTERANCES = 37
NAME = "ev"
METRICS = ("adjusted_rand_score", "adjusted_mutual_info_score",
           "normalized_mutual_info_score")


def _corpus(root):
    build_phoneme_corpus(root, num_speakers=1, utts_per_speaker=47, seed=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages' groundtruth and empirical files (both pairings) of the
    same checkpoint, in results/torch and results/jax."""
    root = str(tmp_path_factory.mktemp("phonemes"))
    spec_torch, _, store_root = build_experiment(root, corpus=_corpus,
                                                 batch_size=8)
    exp = Experiments.load(spec_torch, data_root=store_root,
                           device="cpu").experiments[0]
    cfg = exp.configuration
    model = Evaluator(exp, store_root, device="cpu",
                      figures=False)._load_model()
    ckpt = jax_load(latest_checkpoint_epoch(exp.experiments_path, NAME)[1])
    params, state = _as_jax_tree(ckpt["params"]), _as_jax_tree(
        ckpt["model_state"])
    phonemes = os.path.join(root, "raw", "VCTK-Corpus", "phonemes")
    dirs = {side: os.path.join(root, "results", side)
            for side in ("torch", "jax")}
    tstore, jstore = FeatureStore(store_root), JaxFeatureStore(store_root)
    assert tstore.num_examples(SPLIT) == N_UTTERANCES
    tstats.compute_groundtruth_alignments(tstore, SPLIT, cfg, dirs["torch"],
                                          phonemes)
    jstats.compute_groundtruth_alignments(jstore, SPLIT, cfg, dirs["jax"],
                                          phonemes)
    for per_frame in (False, True):
        tstats.compute_empirical_alignments(model, tstore, SPLIT, cfg,
                                            dirs["torch"], NAME,
                                            per_frame=per_frame)
        jstats.compute_empirical_alignments(params, state, jstore, SPLIT, cfg,
                                            dirs["jax"], NAME,
                                            per_frame=per_frame)
    return dirs, model, cfg, store_root


def _pickle(directory, name):
    with open(os.path.join(directory, name), "rb") as f:
        return pickle.load(f)


def _assert_plain(obj, where):
    """numpy arrays, numpy scalars and builtins, nothing else."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _assert_plain(k, where)
            _assert_plain(v, where)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _assert_plain(v, where)
    else:
        assert isinstance(obj, (np.ndarray, np.generic, str, int, float,
                                type(None))), (where, type(obj))


def test_groundtruth_alignments_equal_jax(run):
    dirs, _, _, _ = run
    name = f"vctk_{SPLIT}_groundtruth_alignments.pickle"
    got, want = _pickle(dirs["torch"], name), _pickle(dirs["jax"], name)
    _assert_plain(got, name)
    assert set(got.pop("possible_phonemes")) == \
        set(want.pop("possible_phonemes")) == {"AA", "IY", "UW", "EH", "SH"}
    assert got == want
    assert len(got["extended_alignment_dataset"]) == N_UTTERANCES
    assert {len(a) for _, a in got["extended_alignment_dataset"]} == {24}


@pytest.mark.parametrize("per_frame", [False, True],
                         ids=["reference_pairing", "per_frame"])
def test_empirical_alignments_match_jax(run, per_frame):
    dirs, model, cfg, store_root = run
    name = (f"{NAME}_vctk_{SPLIT}_empirical_alignments"
            f"{'_per_frame' if per_frame else ''}.pickle")
    got, want = _pickle(dirs["torch"], name), _pickle(dirs["jax"], name)
    _assert_plain(got, name)
    feats = tstats.normalized_features(FeatureStore(store_root).open(SPLIT),
                                       cfg)
    assert len(got["all_alignments"]) == N_UTTERANCES
    for _, seq in got["all_alignments"]:
        assert seq.dtype == np.int32 and seq.shape == (24,)
    n_diff = assert_sequences_equal_or_near_tie(
        got.pop("all_alignments"), want.pop("all_alignments"),
        flat_rows(model, feats, per_frame), model.vq.codebook.detach())
    assert n_diff == 0
    assert got == want


def test_reference_pairing_mixes_the_items_of_a_batch(run):
    """At batch 32 the reference's (C, T, B) flatten pairs frames with rows
    of other items: the sequences differ from each item encoded alone, and
    the short last batch (5 items) mixes only its own."""
    dirs, model, cfg, store_root = run
    seqs = [s for _, s in _pickle(
        dirs["torch"],
        f"{NAME}_vctk_{SPLIT}_empirical_alignments.pickle")["all_alignments"]]
    feats = torch.from_numpy(tstats.normalized_features(
        FeatureStore(store_root).open(SPLIT), cfg))
    alone = [tstats.encode_codes(model, feats[i:i + 1]).numpy()[0]
             for i in range(N_UTTERANCES)]
    assert not all(np.array_equal(a, s) for a, s in zip(alone, seqs))
    last = tstats.encode_codes(model, feats[32:]).numpy()
    np.testing.assert_array_equal(np.stack(seqs[32:]), last)


def _numbers(module, results, cfg):
    """Every number the downstream functions compute from the files in
    ``results`` (no figures)."""
    out = {
        "gt_bigrams": module.compute_groundtruth_bigrams_matrix(
            results, SPLIT, plot=False),
        "gt_bigrams_diag": module.compute_groundtruth_bigrams_matrix(
            results, SPLIT, wo_diag=False, plot=False),
        "emp_bigrams": module.compute_empirical_bigrams_matrix(
            results, NAME, SPLIT, plot=False),
        "avg_phonemes": module.compute_groundtruth_average_phonemes_number(
            results, SPLIT),
    }
    for per_frame in (False, True):
        scores = module.compute_clustering_metrics(results, NAME, SPLIT, cfg,
                                                   per_frame=per_frame)
        for metric in METRICS:
            out[f"{per_frame}_{metric}"] = scores[metric]
    return out


def _assert_numbers_close(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-12,
                                   err_msg=key)


def test_downstream_numbers_match_jax(run):
    dirs, _, cfg, _ = run
    got = _numbers(tstats, dirs["torch"], cfg)
    want = _numbers(jstats, dirs["jax"], cfg)
    _assert_numbers_close(got, want)
    assert got["emp_bigrams"].shape == (cfg["num_embeddings"],) * 2
    assert 0 < got["avg_phonemes"] <= 5
    for per_frame in (False, True):
        assert any(got[f"{per_frame}_{m}"] != 0 for m in METRICS)
    freq = tstats.compute_empirical_encodings_frequency(dirs["torch"], NAME,
                                                        SPLIT, plot=False)
    assert not [f for f in os.listdir(dirs["torch"]) if f.endswith(".png")]
    # the JAX function always draws; its numbers are the same
    want_freq = jstats.compute_empirical_encodings_frequency(dirs["jax"], NAME,
                                                             SPLIT)
    assert freq.keys() == want_freq.keys()
    for code, pct in want_freq.items():
        assert abs(freq[code] - pct) <= 1e-12
    assert abs(sum(freq.values()) - 100) < 1e-9
    for metric in METRICS:
        saved = np.load(os.path.join(dirs["torch"], f"{NAME}_{metric}.npy"))
        assert saved.dtype == np.float64 and saved.shape == ()
        assert float(saved) == got[f"False_{metric}"]


def test_each_package_reads_the_others_files(run):
    dirs, _, cfg, _ = run
    _assert_numbers_close(_numbers(jstats, dirs["torch"], cfg),
                          _numbers(tstats, dirs["torch"], cfg))
    _assert_numbers_close(_numbers(tstats, dirs["jax"], cfg),
                          _numbers(jstats, dirs["jax"], cfg))


def test_resample_phoneme_tier_matches_jax(run):
    """The groundtruth resampling at shifts off the 20 ms grid, including
    windows the tier does not cover."""
    dirs, _, _, store_root = run
    from vqvae_speech_tpu.data.textgrid import read_textgrid as jread
    from vqvae_speech_tpu_torch.data.textgrid import read_textgrid as tread

    root = os.path.dirname(store_root)
    path = os.path.join(root, "raw", "VCTK-Corpus", "phonemes", "p300",
                        "p300_000.TextGrid")
    for shift in (0.0, 0.013, 0.05, 0.119, 0.2):
        for length in (0.48, 0.6):
            assert tstats.resample_phoneme_tier(tread(path), length, shift) \
                == jstats.resample_phoneme_tier(jread(path), length, shift)
    assert tstats.resample_phoneme_tier(tread(path), 0.6, 0.2)[0] is None


def test_codebook_refit_matches_jax(run):
    """``collect_latents`` on the port's model against the JAX package's on
    the same checkpoint (rtol 1e-4 / atol 1e-5: two frameworks' f32
    convolutions), and the numpy k-means copies equal to JAX's on those
    latents."""
    from vqvae_speech_tpu.eval import codebook_refit as jrefit
    from vqvae_speech_tpu_torch.eval import codebook_refit as trefit

    dirs, model, cfg, store_root = run
    feats = tstats.normalized_features(FeatureStore(store_root).open(SPLIT),
                                       cfg)
    exp_dir = os.path.join(os.path.dirname(store_root), "experiments")
    ckpt = jax_load(latest_checkpoint_epoch(exp_dir, NAME)[1])
    got = trefit.collect_latents(model, feats, device="cpu")
    want = jrefit.collect_latents(_as_jax_tree(ckpt["params"]),
                                  _as_jax_tree(ckpt["model_state"]), feats,
                                  cfg)
    assert got.shape == want.shape == (N_UTTERANCES, 24, cfg["embedding_dim"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    flat = want.reshape(-1, want.shape[-1]).astype(np.float64)
    codebook = model.vq.codebook.detach().numpy()
    for a, b in zip(trefit.kmeans_refit(codebook, flat, iters=10),
                    jrefit.kmeans_refit(codebook, flat, iters=10)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trefit.lloyd_kmeans(flat, 5, seed=1),
                                  jrefit.lloyd_kmeans(flat, 5, seed=1))
