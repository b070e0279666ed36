"""Loss/perplexity curves from merged per-epoch checkpoints.

A copy of ``vqvae_speech_tpu/eval/losses_plotter.py`` that reads the
checkpoints through the port's ``train/checkpoint.py`` (no JAX, no optax):
capability-parity with reference src/evaluation/losses_plotter.py:37-305,
per-experiment loss+perplexity figures (savgol-smoothed, log-y), merged
figures across experiments, and per-loss-type figures.
"""
import os

import numpy as np
from scipy.signal import savgol_filter

from vqvae_speech_tpu_torch.train.checkpoint import merge_checkpoint_losses
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger


def _smooth(values, window: int = 9, order: int = 3):
    values = np.asarray(values, np.float64)
    if len(values) < window:
        return values
    return savgol_filter(values, window, order)


def _loss_series(losses):
    """list of per-step loss dicts -> {loss_name: np.array}."""
    if not losses:
        return {}
    keys = losses[0].keys()
    return {k: np.asarray([step[k] for step in losses]) for k in keys}


def plot_experiment_losses(experiment_name: str, experiments_path: str,
                           output_path: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    losses, perplexities = merge_checkpoint_losses(
        experiments_path, experiment_name)
    if not losses:
        ConsoleLogger.warn(f"No checkpoints found for '{experiment_name}'")
        return None
    series = _loss_series(losses)

    fig, axs = plt.subplots(2, 1, figsize=(12, 8), sharex=True)
    for name, values in series.items():
        axs[0].plot(_smooth(values), label=name)
    axs[0].set_yscale("log")
    axs[0].set_ylabel("loss")
    axs[0].legend(fontsize=7)
    axs[1].plot(_smooth(perplexities), color="tab:orange")
    axs[1].set_ylabel("perplexity")
    axs[1].set_xlabel("step")
    out = os.path.join(output_path,
                       f"{experiment_name}_losses-and-perplexities.png")
    os.makedirs(output_path, exist_ok=True)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_merged_losses(experiment_names, experiments_path: str,
                       output_path: str, loss_key: str = "loss"):
    """Cross-experiment figure for one loss key, plus a perplexity panel
    (reference 'merged-loss-and-perplexity', losses_plotter.py:140-185)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 2, figsize=(16, 6))
    for name in experiment_names:
        losses, perplexities = merge_checkpoint_losses(
            experiments_path, name)
        if not losses:
            continue
        series = _loss_series(losses)
        if loss_key in series:
            axs[0].plot(_smooth(series[loss_key]), label=name)
        if perplexities:
            axs[1].plot(_smooth(perplexities), label=name)
    axs[0].set_yscale("log")
    axs[0].set_ylabel(loss_key)
    axs[0].set_xlabel("step")
    axs[0].legend()
    axs[1].set_ylabel("perplexity")
    axs[1].set_xlabel("step")
    axs[1].legend()
    os.makedirs(output_path, exist_ok=True)
    out = os.path.join(output_path, f"merged_{loss_key}.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_loss_type_figures(experiment_names, experiments_path: str,
                           output_path: str):
    """One figure PER LOSS TYPE across experiments (reference
    _plot_merged_all_losses_type, losses_plotter.py:228-261: every loss key
    except the total 'loss' gets its own '{loss_name}.png' comparing all
    experiments)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_type = {}   # loss_name -> [(experiment_name, values)]
    for name in experiment_names:
        losses, _ = merge_checkpoint_losses(experiments_path, name)
        if not losses:
            continue
        for loss_name, values in _loss_series(losses).items():
            if loss_name == "loss":
                continue
            by_type.setdefault(loss_name, []).append((name, values))

    os.makedirs(output_path, exist_ok=True)
    outs = []
    for loss_name, curves in by_type.items():
        fig, ax = plt.subplots(figsize=(8, 8))
        for exp_name, values in curves:
            ax.plot(_smooth(values), label=exp_name)
        ax.set_title("Smoothed " + loss_name.replace("_", " "))
        ax.set_xlabel("step")
        ax.set_ylabel("loss")
        ax.set_yscale("log")
        ax.legend()
        out = os.path.join(output_path, f"{loss_name}.png")
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
        ConsoleLogger.success(f"Saved figure at path '{out}'")
        outs.append(out)
    return outs


def plot_training_losses(experiments, experiments_path: str):
    """Entry point for the --plot_experiments_losses CLI mode.  Emits the
    reference's full figure family: per-experiment loss+perplexity, merged
    across experiments, and one figure per loss type."""
    names = [e.name for e in experiments]
    results_path = experiments[0].results_path if experiments else "results"
    for name in names:
        plot_experiment_losses(name, experiments_path, results_path)
    plot_merged_losses(names, experiments_path, results_path)
    plot_loss_type_figures(names, experiments_path, results_path)
