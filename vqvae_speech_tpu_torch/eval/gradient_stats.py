"""Gradient-flow plots from recorded gradient-stats pickles.

A copy of ``vqvae_speech_tpu/eval/gradient_stats.py`` (the port imports
nothing of the JAX package): capability-parity with reference
src/evaluation/gradient_stats.py:36-121, bar plots of per-parameter
mean/max |grad| arranged epochs x iterations, from the
``{name}_{epoch}_{iteration}_gradient-stats.pickle`` files that either
package's trainer writes (``train/trainer.py``).
"""
import os
import pickle

import numpy as np


def load_gradient_entries(experiment_path: str, experiment_name: str):
    """[(epoch, iteration, entry)] sorted, from the trainer's pickles."""
    suffix = "_gradient-stats.pickle"
    names = [f for f in os.listdir(experiment_path)
             if f.endswith(suffix) and f.startswith(experiment_name + "_")]

    def key(fname):
        parts = fname[len(experiment_name) + 1: -len(suffix)].split("_")
        return int(parts[0]), int(parts[1])

    entries = []
    for fname in sorted(names, key=key):
        epoch, iteration = key(fname)
        with open(os.path.join(experiment_path, fname), "rb") as f:
            entries.append((epoch, iteration, pickle.load(f)))
    return entries


def plot_gradient_flow_over_epochs(gradient_stats_entries, output_file_name,
                                   module: str = "model"):
    """Grid of gradient-flow bar plots (reference lines 81-121)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not gradient_stats_entries:
        return None
    epochs = sorted({e for e, _, _ in gradient_stats_entries})
    iters = sorted({i for _, i, _ in gradient_stats_entries})
    fig, axs = plt.subplots(
        len(epochs), len(iters),
        figsize=(4 * len(iters), 3 * len(epochs)), squeeze=False)
    pos = {(e, i): (r, c) for r, e in enumerate(epochs)
           for c, i in enumerate(iters)}
    for epoch, iteration, entry in gradient_stats_entries:
        r, c = pos[(epoch, iteration)]
        ax = axs[r][c]
        stats = entry[module]
        x = np.arange(len(stats["layers"]))
        ax.bar(x, stats["max_grads"], alpha=0.3, color="c", label="max")
        ax.bar(x, stats["avg_grads"], alpha=0.6, color="b", label="mean")
        ax.set_title(f"epoch {epoch} it {iteration}", fontsize=8)
        ax.set_yscale("log")
        ax.set_xticks([])
    fig.tight_layout()
    fig.savefig(output_file_name, bbox_inches="tight")
    plt.close(fig)
    return output_file_name
