"""Speaker-dependency and entropy-distribution analyses.

A copy of ``vqvae_speech_tpu/eval/speaker_stats.py`` (numpy; the port
imports nothing of the JAX package): capability-parity with reference
src/experiments/evaluator.py:409-503. The reference's speaker-dependency
routine is unfinished (its embedding grouping is commented out,
evaluator.py:437-447); this module implements the full algorithm it
describes in its docstring: per-speaker code-usage distributions + pairwise
distribution distances (Jensen-Shannon divergence). The entropy-distribution
analysis follows the reference exactly (softmax entropies of originals /
quantized / reconstructions with pickles + plots). The plots are drawn only
with ``plot=True``; the pickles are written either way.
"""
import os
import pickle

import numpy as np


def _softmax(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def _entropy(p):
    return float(-np.sum(p * np.log(p + 1e-10)))


def _js_divergence(p, q, eps=1e-10):
    p = p / (p.sum() + eps)
    q = q / (q.sum() + eps)
    m = 0.5 * (p + q)

    def kl(a, b):
        return np.sum(a * np.log((a + eps) / (b + eps)))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def compute_speaker_dependency_stats(per_utterance_indices, speaker_ids,
                                     num_embeddings: int, results_path: str,
                                     experiment_name: str, plot: bool = True):
    """Are codes speaker-independent?

    per_utterance_indices: list of (T_lat,) code sequences; speaker_ids:
    matching (N,) speaker ids.  Groups code-usage histograms by speaker and
    computes all pairwise Jensen-Shannon divergences.  Low divergences mean
    the codebook is shared across speakers (speaker-independent phonemes).
    """
    speakers = sorted(set(int(s) for s in speaker_ids))
    hists = {}
    for spk in speakers:
        counts = np.zeros(num_embeddings)
        for seq, s in zip(per_utterance_indices, speaker_ids):
            if int(s) == spk:
                counts += np.bincount(np.asarray(seq, int),
                                      minlength=num_embeddings)
        hists[spk] = counts

    pairs, divergences = [], []
    for i, a in enumerate(speakers):
        for b in speakers[i + 1:]:
            pairs.append((a, b))
            divergences.append(_js_divergence(hists[a], hists[b]))

    result = {
        "speaker_histograms": hists,
        "pairs": pairs,
        "js_divergences": np.asarray(divergences),
    }
    os.makedirs(results_path, exist_ok=True)
    with open(os.path.join(
            results_path,
            f"{experiment_name}_speaker_dependency_stats.pickle"), "wb") as f:
        pickle.dump(result, f)

    if plot and divergences:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(1, 2, figsize=(14, 5))
        axs[0].hist(divergences, bins=20, density=True)
        axs[0].set_title("Pairwise JS divergence of per-speaker "
                         "code-usage distributions")
        mat = np.zeros((len(speakers), len(speakers)))
        for (a, b), d in zip(pairs, divergences):
            ia, ib = speakers.index(a), speakers.index(b)
            mat[ia, ib] = mat[ib, ia] = d
        im = axs[1].matshow(mat)
        fig.colorbar(im, ax=axs[1])
        axs[1].set_title("speaker x speaker JS divergence")
        fig.savefig(os.path.join(
            results_path,
            f"{experiment_name}_speaker-dependency-plot.png"),
            bbox_inches="tight", pad_inches=0)
        plt.close(fig)
    return result


def compute_entropy_distributions(originals, quantizeds, reconstructions,
                                  results_path: str, experiment_name: str,
                                  plot: bool = True):
    """Entropy distributions of softmaxed originals / quantized latents /
    reconstructions over the val set (reference evaluator.py:449-503).

    originals/reconstructions: iterable of (T, C); quantizeds: iterable of
    (T_lat, D).  Softmax axes mirror the reference (dim=0 over time for
    originals/reconstructions of the channels-first view -> feature axis
    here; dim=1 over channels for quantized).
    """
    original_distribution = [
        _entropy(_softmax(np.asarray(x), axis=0)) for x in originals]
    quantized_distribution = [
        _entropy(_softmax(np.asarray(q), axis=1)) for q in quantizeds]
    reconstruction_distribution = [
        _entropy(_softmax(np.asarray(r), axis=0)) for r in reconstructions]

    os.makedirs(results_path, exist_ok=True)
    for name, dist in (
            ("original_distribution", original_distribution),
            ("quantized_distribution", quantized_distribution),
            ("reconstruction_distribution", reconstruction_distribution)):
        with open(os.path.join(results_path,
                               f"{experiment_name}_{name}.pickle"),
                  "wb") as f:
            pickle.dump(np.asarray(dist), f)

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(3, 1, figsize=(15, 10), sharex=True)
        for ax, (title, dist) in zip(axs, (
                ("Entropy distribution of validation dataset",
                 original_distribution),
                ("Entropy distribution of quantized validation dataset",
                 quantized_distribution),
                ("Entropy distribution of reconstructed validation dataset",
                 reconstruction_distribution))):
            ax.hist(dist, bins=30, density=True)
            ax.set_title(title)
        fig.savefig(os.path.join(results_path,
                                 f"{experiment_name}_entropy-stats-plot.png"),
                    bbox_inches="tight", pad_inches=0)
        plt.close(fig)
    return (original_distribution, quantized_distribution,
            reconstruction_distribution)
