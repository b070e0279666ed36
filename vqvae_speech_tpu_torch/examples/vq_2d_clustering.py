"""2-D synthetic clustering demo: VQ-EMA directly on Gaussian clusters.

Counterpart of the repository's ``examples/vq_2d_clustering.py`` (reference
vqvae_2d_direct_clustering.py): generate points from ring-arranged Gaussian
clusters, train the EMA quantizer with no encoder/decoder (codebook
initialized around the data statistics), and plot assignments + codebook
trajectory. One quantizer call an epoch, the whole dataset one batch on the
device; on the card its search is the hand-written kernel.

    python -m vqvae_speech_tpu_torch.examples.vq_2d_clustering \
        [--output vq_2d_clustering.png] [--device cuda]
"""
import argparse

import numpy as np
import torch

from vqvae_speech_tpu_torch.examples import (
    require_matplotlib,
    seeded_generator,
)
from vqvae_speech_tpu_torch.models.vq import VectorQuantizer
from vqvae_speech_tpu_torch.utils.device import resolve_device


def generate_2d_clusters(n_points=500, n_clusters=5, noise=0.3, seed=42):
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, n_clusters, endpoint=False)
    centers = np.stack([np.cos(angles) * 3, np.sin(angles) * 3], axis=1)
    per = n_points // n_clusters
    data, labels = [], []
    for i, c in enumerate(centers):
        data.append(rng.standard_normal((per, 2)) * noise + c)
        labels.extend([i] * per)
    data, labels = np.vstack(data), np.array(labels)
    order = rng.permutation(len(data))
    return data[order].astype(np.float32), labels[order]


def points_bct(data, device) -> torch.Tensor:
    """(N, 2) points as the quantizer's (B, C, T) input, (1, N, 2): its
    (C, T, B)-order flatten (ops/vq.py:reference_flatten) then gives row i =
    point i. (The JAX demo feeds ``data.T[None]`` in its (B, T, C) layout,
    the same tensor; fed unchanged here, the rows would be pairs of
    neighbouring points' coordinates.)"""
    return torch.as_tensor(np.asarray(data, np.float32),
                           device=device)[None]


def initial_codebook(data, num_embeddings: int, seed: int) -> torch.Tensor:
    """mean + std * N(0, 1) over the data's statistics (the JAX demo's init,
    with the normals from a seeded torch.Generator)."""
    pts = torch.as_tensor(np.asarray(data, np.float32))
    normal = torch.randn(num_embeddings, 2, generator=seeded_generator(seed))
    return pts.mean() + pts.std(correction=0) * normal


def ema_quantizer(codebook0, cluster0, ema_w0, decay, device
                  ) -> VectorQuantizer:
    """The EMA quantizer with the given starting buffers, in training
    mode."""
    K = codebook0.shape[0]
    vq = VectorQuantizer(K, 2, commitment_cost=0.25, decay=decay,
                         generator=torch.Generator())
    vq.codebook = torch.as_tensor(codebook0, dtype=torch.float32).clone()
    vq.ema_cluster_size = torch.as_tensor(cluster0, dtype=torch.float32).clone()
    vq.ema_w = torch.as_tensor(ema_w0, dtype=torch.float32).clone()
    return vq.to(device).train()


def record_epoch(history, epoch, out, vq):
    """One epoch's entry of a demo's history: the JAX demo's keys."""
    history.append({"epoch": epoch, "loss": float(out.vq_loss),
                    "perplexity": float(out.perplexity),
                    "codebook": vq.codebook.cpu().numpy()})


def final_assignments(vq: VectorQuantizer, points: torch.Tensor) -> np.ndarray:
    """Each point's code under the trained codebook (no update)."""
    vq.eval()
    with torch.no_grad():
        out = vq(points)
    return out.indices[:, 0].cpu().numpy()


def train_direct_vq(data, n_epochs=100, num_embeddings=8, decay=0.99,
                    seed=0, *, codebook0=None, device="cuda"):
    """Cluster (N, 2) points with the EMA quantizer (no encoder/decoder).

    ``codebook0`` (K, 2), when given, replaces the seeded init (tests feed
    the JAX demo's). Returns (state, assignments, history): the quantizer's
    EMA buffers, each point's code, and a dict an epoch."""
    dev = resolve_device(device)
    if codebook0 is None:
        codebook0 = initial_codebook(data, num_embeddings, seed)
    codebook0 = torch.tensor(np.asarray(codebook0), dtype=torch.float32)
    vq = ema_quantizer(codebook0, torch.zeros(len(codebook0)), codebook0,
                       decay, dev)
    points = points_bct(data, dev)

    history = []
    with torch.no_grad():
        for epoch in range(n_epochs):
            record_epoch(history, epoch, vq(points), vq)
    return vq.ema_state(), final_assignments(vq, points), history


def visualize(data, labels, state, assignments, history, output_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    codebook = np.asarray(torch.as_tensor(state["codebook"]).cpu())
    fig, axs = plt.subplots(2, 2, figsize=(14, 12))
    axs[0, 0].scatter(data[:, 0], data[:, 1], c=labels, s=8, cmap="tab10")
    axs[0, 0].set_title("groundtruth clusters")
    n = len(assignments)
    axs[0, 1].scatter(data[:n, 0], data[:n, 1], c=assignments, s=8,
                      cmap="tab10")
    axs[0, 1].scatter(codebook[:, 0], codebook[:, 1], c="k", marker="x",
                      s=120)
    axs[0, 1].set_title("VQ-EMA assignments + codebook")
    axs[1, 0].plot([h["loss"] for h in history])
    axs[1, 0].set_title("vq loss")
    axs[1, 0].set_yscale("log")
    axs[1, 1].plot([h["perplexity"] for h in history])
    axs[1, 1].set_title("perplexity")
    fig.savefig(output_path, bbox_inches="tight")
    plt.close(fig)
    return output_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output", default="vq_2d_clustering.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_matplotlib()
    data, labels = generate_2d_clusters()
    state, assignments, history = train_direct_vq(data, device=args.device)
    visualize(data, labels, state, assignments, history, args.output)
    print(f"final loss {history[-1]['loss']:.4f} "
          f"perplexity {history[-1]['perplexity']:.2f} -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
