"""PyTorch port: the whole ``Evaluator.evaluate`` against the JAX package's,
on one checkpoint written once.

A VCTK-shaped mini corpus with TextGrids (``tests/test_ingest.py``'s, six
utterances, two in val) goes through the port's export and stats, and the
port trains one epoch of a tiny experiment (``test_training.TINY_CFG``
width) on the CPU. Both packages then evaluate that checkpoint with every
option that writes numbers (alignments in both pairings, bigrams,
frequencies, clustering metrics, the many-to-one mapping, the average
phoneme count, speaker-dependency and entropy statistics), each into its
own results directory, and every number file is compared:

* groundtruth alignments equal (``possible_phonemes`` as a set: its order
  follows ``PYTHONHASHSEED``),
* empirical code sequences equal except near-tie rows (the rule of
  ``tests/test_torch_train_step.py::assert_codes_equal_or_near_tie``),
  int32 in the port's files,
* bigrams, clustering scores, frequencies, the mapping, the speaker
  histograms and divergences and the entropies of the input features
  within 1e-12 (exact arithmetic on the same codes and inputs),
* the entropies of the quantized latents and of the reconstructions within
  rtol 1e-5: they are functions of the two frameworks' f32 convolutions
  (1.5e-07 apart at most over these runs, tiny and flagship width).

Also: the model's parameters and buffers (an EMA quantizer's codebook,
``ema_w`` and ``ema_cluster_size``) bit-equal before and after evaluation,
the first-interval rule of the mapping on a frame that sits exactly on a
phoneme boundary, the options that only draw figures refused under
``figures=False``, and one case at the flagship width (vq44-mfcc39
jitter12: 768 hidden, K=44, D=64) on the same utterances.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from test_ingest import _mini_corpus
from test_training import TINY_CFG
from vqvae_speech_tpu.train import Experiments as JaxExperiments
from vqvae_speech_tpu_torch.data import FeatureStore, compute_dataset_stats
from vqvae_speech_tpu_torch.data.export import export_to_features
from vqvae_speech_tpu_torch.data.vctk import VCTK
from vqvae_speech_tpu_torch.eval import Evaluator
from vqvae_speech_tpu_torch.eval.alignment_stats import normalized_features
from vqvae_speech_tpu_torch.ops.vq import reference_flatten, vq_distances
from vqvae_speech_tpu_torch.train import Experiments, load_configuration

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "ev"
NUMBER_OPTIONS = {
    "compute_many_to_one_mapping": True,
    "compute_alignments": True,
    "alignment_subset": "val",
    "compute_clustering_metrics": True,
    "per_frame_alignments": True,
    "compute_groundtruth_average_phonemes_number": True,
    "compute_speaker_dependency_stats": True,
    "compute_entropy_distributions": True,
}
# entropies of f32 network outputs: the two frameworks' convolutions
CONV_DERIVED = {f"{NAME}_quantized_distribution.pickle",
                f"{NAME}_reconstruction_distribution.pickle"}


def flagship_configuration():
    """configurations/vctk_features.yaml with the jitter12 overrides of
    configurations/experiments_vq44-mfcc39.json."""
    cfg = load_configuration(os.path.join(REPO_ROOT, "configurations",
                                          "vctk_features.yaml"))
    with open(os.path.join(REPO_ROOT, "configurations",
                           "experiments_vq44-mfcc39.json")) as f:
        cfg.update(json.load(f)["experiments"]["jitter12"])
    return cfg


def build_experiment(root, cfg=None, corpus=_mini_corpus, **overrides):
    """Corpus -> the port's export and stats -> one epoch of the port's
    trainer on the CPU. Returns (spec path for the port, spec path for
    JAX, store root); the two specs share the experiments directory (one
    checkpoint) and differ in their results directories."""
    corpus(root)
    cfg = dict(TINY_CFG if cfg is None else cfg)
    store_root = os.path.join(root, "features")
    export_to_features(VCTK(root, ratio=0.8, shuffle_seed=0), store_root, cfg,
                       num_workers=2, device="cpu")
    normalizer_path = os.path.join(root, "stats.pickle")
    compute_dataset_stats(FeatureStore(store_root), normalizer_path)
    cfg.update(num_epochs=1, batch_size=2, data_root=root, normalize=True,
               normalizer_path=normalizer_path)
    cfg.update(overrides)
    cfg_path = os.path.join(root, "base.yaml")
    with open(cfg_path, "w") as f:
        yaml.dump(cfg, f)
    specs = []
    for side in ("torch", "jax"):
        spec = {"experiments_path": os.path.join(root, "experiments"),
                "results_path": os.path.join(root, f"results_{side}"),
                "configuration_path": cfg_path, "seed": 1234,
                "experiments": {NAME: {}}}
        specs.append(os.path.join(root, f"{side}.json"))
        with open(specs[-1], "w") as f:
            json.dump(spec, f)
    Experiments.load(specs[0], data_root=store_root, device="cpu").train()
    return specs[0], specs[1], store_root


def evaluate_both(spec_torch, spec_jax, store_root, options):
    """The port's evaluation (figures off) and JAX's of the same
    checkpoint; returns the port's experiment and both results."""
    exp = Experiments.load(spec_torch, data_root=store_root,
                           device="cpu").experiments[0]
    got = exp.evaluate(options, figures=False)
    want = JaxExperiments.load(spec_jax, data_root=store_root).evaluate(
        options)[NAME]
    return exp, got, want


def flat_rows(model, feats, per_frame, batch_size=32):
    """The rows each code of the empirical sweep was searched for, in the
    order of the concatenated sequences."""
    rows = []
    D = model.vq.codebook.shape[1]
    with torch.no_grad():
        for start in range(0, feats.shape[0], batch_size):
            z = model.latents(torch.from_numpy(feats[start:start + batch_size]))
            rows.append(z.transpose(1, 2).reshape(-1, D) if per_frame
                        else reference_flatten(z, D))
    return torch.cat(rows)


def assert_sequences_equal_or_near_tie(got, want, flat, codebook):
    """Sequences of the same keys, in order; positions that differ must be
    near-ties on the port's own rows (|d_got - d_want| <= 1e-4 (|z|^2 + 1)).
    Returns the number of differing positions."""
    assert [k for k, _ in got] == [k for k, _ in want]
    g = np.concatenate([s for _, s in got])
    w = np.concatenate([s for _, s in want])
    assert g.shape == w.shape == (flat.shape[0],)
    diff = np.nonzero(g != w)[0]
    if len(diff):
        d = vq_distances(flat[diff], codebook).numpy()
        gap = np.abs(d[np.arange(len(diff)), g[diff]]
                     - d[np.arange(len(diff)), w[diff]])
        zz = flat[diff].square().sum(1).numpy()
        assert (gap <= 1e-4 * (zz + 1)).all(), (len(diff), gap.max())
    return len(diff)


def _load(path):
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_results_match(got_dir, want_dir, model, cfg, store_root,
                         subset="val"):
    """Every number file of the JAX evaluation against the port's; returns
    the number of near-tie rows in the empirical sequences."""
    got_files = {f for f in os.listdir(got_dir) if not f.endswith(".png")}
    want_files = {f for f in os.listdir(want_dir) if not f.endswith(".png")}
    assert got_files == want_files
    assert not [f for f in os.listdir(got_dir) if f.endswith(".png")]
    feats = normalized_features(FeatureStore(store_root).open(subset), cfg)
    codebook = model.vq.codebook.detach()
    near_ties = 0
    for name in sorted(want_files):
        got = _load(os.path.join(got_dir, name))
        want = _load(os.path.join(want_dir, name))
        if name.endswith(".npy"):
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                       err_msg=name)
        elif "groundtruth_alignments" in name:
            assert set(got.pop("possible_phonemes")) == \
                set(want.pop("possible_phonemes"))
            assert got == want, name
        elif "empirical_alignments" in name:
            for _, seq in got["all_alignments"]:
                assert isinstance(seq, np.ndarray) and seq.dtype == np.int32
            near_ties += assert_sequences_equal_or_near_tie(
                got.pop("all_alignments"), want.pop("all_alignments"),
                flat_rows(model, feats, name.endswith("_per_frame.pickle")),
                codebook)
            assert got == want, name
        elif name.endswith("_mapping.pickle"):
            assert got == want, name
        elif name.endswith("speaker_dependency_stats.pickle"):
            assert got["pairs"] == want["pairs"]
            assert got["speaker_histograms"].keys() == \
                want["speaker_histograms"].keys()
            for spk, hist in want["speaker_histograms"].items():
                np.testing.assert_array_equal(got["speaker_histograms"][spk],
                                              hist)
            np.testing.assert_allclose(got["js_divergences"],
                                       want["js_divergences"], rtol=0,
                                       atol=1e-12)
        elif name in CONV_DERIVED:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        elif name.endswith("_distribution.pickle"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                       err_msg=name)
        else:
            raise AssertionError(f"no comparison for {name}")
    return near_ties


def assert_returns_match(got, want):
    """The numbers evaluate() returns, beside its files."""
    for key in ("clustering_metrics", "clustering_metrics_per_frame"):
        assert got[key].keys() == want[key].keys()
        for metric, value in want[key].items():
            assert abs(got[key][metric] - value) <= 1e-12, (key, metric)
    assert got["avg_phonemes"] == want["avg_phonemes"]
    assert got["many_to_one"] == want["many_to_one"]
    for key in ("gt_bigrams", "emp_bigrams"):
        np.testing.assert_allclose(got["alignments"][key],
                                   want["alignments"][key], rtol=0,
                                   atol=1e-12)
    freq_got, freq_want = (got["alignments"]["emp_frequency"],
                           want["alignments"]["emp_frequency"])
    assert freq_got.keys() == freq_want.keys()
    for code, pct in freq_want.items():
        assert abs(freq_got[code] - pct) <= 1e-12


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny"))
    return root, build_experiment(root)


def test_evaluate_matches_jax(tiny):
    root, (spec_torch, spec_jax, store_root) = tiny
    exp, got, want = evaluate_both(spec_torch, spec_jax, store_root,
                                   NUMBER_OPTIONS)
    model = Evaluator(exp, store_root, device="cpu",
                      figures=False)._load_model()
    assert_results_match(os.path.join(root, "results_torch"),
                         os.path.join(root, "results_jax"), model,
                         exp.configuration, store_root)
    assert_returns_match(got, want)


def test_evaluation_leaves_the_ema_model_unchanged(tmp_path):
    spec_torch, _, store_root = build_experiment(str(tmp_path), decay=0.99)
    exp = Experiments.load(spec_torch, data_root=store_root,
                           device="cpu").experiments[0]
    ev = Evaluator(exp, store_root, device="cpu", figures=False)
    model = ev._load_model()
    assert model.vq.ema and not model.training
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ev.evaluate(NUMBER_OPTIONS)
    ev._evaluate_once()
    after = model.state_dict()
    assert before.keys() == after.keys()
    assert {"vq.codebook", "vq.ema_w", "vq.ema_cluster_size"} <= set(before)
    for key, value in before.items():
        assert torch.equal(value, after[key]), key
    assert not model.training


def test_many_to_one_takes_the_first_interval_on_a_boundary(tiny):
    """Frame 3 of each val utterance sits exactly on the boundary between
    "aa" and "bb" (the TextGrid's time is the frame's own float): it belongs
    to the first interval, "aa", as in the JAX evaluator."""
    root, (spec_torch, spec_jax, store_root) = tiny
    specs = []
    for spec_path in (spec_torch, spec_jax):
        with open(spec_path) as f:
            spec = json.load(f)
        spec["results_path"] += "_boundary"
        specs.append(spec_path.replace(".json", "_boundary.json"))
        with open(specs[-1], "w") as f:
            json.dump(spec, f)
    meta = FeatureStore(store_root).metadata("val")
    phonemes = os.path.join(root, "raw", "VCTK-Corpus", "phonemes")
    originals = {}
    for wav, shift in zip(meta["wav_filenames"], meta["shifting_times"]):
        key = os.path.basename(wav).rsplit(".", 1)[0]
        t3 = float((np.arange(24) * 0.01 * 2 + float(shift))[3])
        path = os.path.join(phonemes, key.split("_")[0], key + ".TextGrid")
        with open(path) as f:
            originals[path] = f.read()
        with open(path, "w") as f:
            f.write(_two_phoneme_textgrid(t3))
    try:
        _, got, want = evaluate_both(*specs, store_root,
                                     {"compute_many_to_one_mapping": True})
    finally:
        for path, text in originals.items():
            with open(path, "w") as f:
                f.write(text)
    assert got["many_to_one"] == want["many_to_one"]
    with open(os.path.join(root, "results_torch_boundary",
                           f"{NAME}_phonemes_mapping.pickle"), "rb") as f:
        phonemes_mapping = pickle.load(f)
    assert {k: len(v) for k, v in phonemes_mapping.items()} == \
        {"aa": 4 * len(originals), "bb": 20 * len(originals)}


def _two_phoneme_textgrid(boundary):
    return f'''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 2.0
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 2.0
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 2.0
            text = "hello"
    item [2]:
        class = "IntervalTier"
        name = "phonemes"
        xmin = 0
        xmax = 2.0
        intervals: size = 2
        intervals [1]:
            xmin = 0
            xmax = {boundary!r}
            text = "aa"
        intervals [2]:
            xmin = {boundary!r}
            xmax = 2.0
            text = "bb"
'''


@pytest.mark.parametrize("option", [
    "plot_comparaison_plot", "plot_distances_histogram",
    "plot_quantized_embedding_spaces", "test_denormalization",
    "compute_quantized_embedding_spaces_animation", "plot_gradient_stats",
    "plot_clustering_metrics_evolution",
    "check_clustering_metrics_stability_over_seeds"])
def test_figure_options_refused_without_figures(tiny, option):
    root, (spec_torch, _, store_root) = tiny
    exps = Experiments.load(spec_torch, data_root=store_root, device="cpu")
    with pytest.raises(ValueError, match="--no_figures"):
        exps.evaluate({option: True, "compute_alignments": True},
                      figures=False)
    with pytest.raises(ValueError, match=option):
        Evaluator(exps.experiments[0], store_root, device="cpu",
                  figures=False).evaluate({option: True})


def test_flagship_width_matches_jax(tmp_path):
    root = str(tmp_path)
    spec_torch, spec_jax, store_root = build_experiment(
        root, flagship_configuration())
    exp, got, want = evaluate_both(spec_torch, spec_jax, store_root,
                                   NUMBER_OPTIONS)
    model = Evaluator(exp, store_root, device="cpu",
                      figures=False)._load_model()
    assert model.vq.codebook.shape == (44, 64)
    assert_results_match(os.path.join(root, "results_torch"),
                         os.path.join(root, "results_jax"), model,
                         exp.configuration, store_root)
    assert_returns_match(got, want)
