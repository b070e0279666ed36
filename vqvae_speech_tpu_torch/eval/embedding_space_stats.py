"""Embedding-space statistics: 2-D projections of quantized frames + codebook.

Counterpart of ``vqvae_speech_tpu/eval/embedding_space_stats.py``
(reference src/evaluation/embedding_space_stats.py:41-264): the same
scatters of [quantized frames ‖ codebook] colored by speaker / code index,
with jitter, and the same animation over the codebook-stats records.
Projection: the JAX package uses UMAP when importable, else scikit-learn's
PCA; neither package's environment has UMAP, and the GPU machine has no
scikit-learn, so ``project_2d`` is a numpy PCA (an exact SVD of the
centered points, with scikit-learn's ``svd_flip`` sign rule on the
components), equal to scikit-learn's where it solves exactly (its "full"
and "covariance_eigh" solvers).
"""
import os
import pickle

import numpy as np

from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger


def project_2d(points: np.ndarray, seed: int = 0) -> np.ndarray:
    """(N, D) -> (N, 2): the centered points on their first two principal
    axes, each axis signed so that its largest-magnitude entry is positive.
    ``seed`` is kept for the JAX package's signature; PCA draws nothing."""
    x = np.asarray(points, np.float64)
    x = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    vt = vt[:2]
    signs = np.sign(vt[np.arange(vt.shape[0]),
                       np.argmax(np.abs(vt), axis=1)])
    return x @ (vt * signs[:, None]).T


def plot_quantized_embedding_space(quantized_frames: np.ndarray,
                                   codebook: np.ndarray,
                                   speaker_ids: np.ndarray,
                                   output_path: str,
                                   time_jitter: float = 0.03,
                                   seed: int = 0):
    """Dual scatter: colored by speaker and by nearest-code index
    (reference lines 49-114).  quantized_frames: (N, D) straight-through
    outputs; codebook: (K, D)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    stacked = np.concatenate([quantized_frames, codebook], axis=0)
    proj = project_2d(stacked, seed)
    n = quantized_frames.shape[0]
    frames_2d = proj[:n] + rng.normal(0, time_jitter, (n, 2))
    codes_2d = proj[n:]

    # nearest code per frame for the code-colored panel
    d = ((quantized_frames**2).sum(1, keepdims=True) + (codebook**2).sum(1)
         - 2 * quantized_frames @ codebook.T)
    nearest = np.argmin(d, axis=1)

    fig, axs = plt.subplots(1, 2, figsize=(16, 7))
    sc0 = axs[0].scatter(frames_2d[:, 0], frames_2d[:, 1], c=speaker_ids,
                         s=4, cmap="tab20")
    axs[0].scatter(codes_2d[:, 0], codes_2d[:, 1], c="k", s=40, marker="x")
    axs[0].set_title("colored by speaker")
    fig.colorbar(sc0, ax=axs[0])
    sc1 = axs[1].scatter(frames_2d[:, 0], frames_2d[:, 1], c=nearest,
                         s=4, cmap="hsv")
    axs[1].scatter(codes_2d[:, 0], codes_2d[:, 1], c="k", s=40, marker="x")
    axs[1].set_title("colored by nearest code")
    fig.colorbar(sc1, ax=axs[1])
    fig.savefig(output_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return output_path


def compute_quantized_embedding_spaces_animation(experiment_path: str,
                                                 experiment_name: str,
                                                 results_path: str,
                                                 fps: int = 2):
    """GIF over the recorded codebook-stats pickles (reference lines 156-241)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.animation as animation

    file_names = sorted(
        (f for f in os.listdir(experiment_path)
         if "codebook-stats" in f and f.startswith(experiment_name + "_")),
        key=lambda x: tuple(
            int(p) for p in
            x[len(experiment_name) + 1:].replace(
                "_codebook-stats.pickle", "").split("_")))
    if not file_names:
        ConsoleLogger.warn("No codebook-stats records found")
        return None

    entries = []
    for fname in file_names:
        with open(os.path.join(experiment_path, fname), "rb") as f:
            entries.append(pickle.load(f))

    frames = []
    for entry in entries:
        stacked = np.concatenate(
            [entry["concatenated_quantized"], entry["embedding"]], axis=0)
        proj = project_2d(stacked)
        n = entry["concatenated_quantized"].shape[0]
        frames.append((proj[:n], proj[n:]))

    fig, ax = plt.subplots(figsize=(8, 8))

    def update(i):
        ax.clear()
        pts, codes = frames[i]
        ax.scatter(pts[:, 0], pts[:, 1], s=4)
        ax.scatter(codes[:, 0], codes[:, 1], c="k", s=40, marker="x")
        ax.set_title(f"record {i + 1}/{len(frames)}")

    anim = animation.FuncAnimation(fig, update, frames=len(frames))
    out = os.path.join(results_path,
                       f"{experiment_name}_embedding_space_animation.gif")
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out
