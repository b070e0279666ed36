"""Balanced VQ-EMA demo: many clusters, dead-code revival.

Counterpart of the repository's ``examples/vq_balanced_2d.py`` (reference
vqvae_balanced.py:302-360, 40 clusters, 2000 points): trains the
usage-tracked balanced quantizer and plots assignments, codebook coverage,
and code-usage distribution.

    python -m vqvae_speech_tpu_torch.examples.vq_balanced_2d \
        [--output vq_balanced_2d.png] [--device cuda]
"""
import argparse

import numpy as np
import torch

from vqvae_speech_tpu_torch.examples import (
    require_matplotlib,
    seeded_generator,
)
from vqvae_speech_tpu_torch.examples.vq_2d_clustering import (
    generate_2d_clusters,
)
from vqvae_speech_tpu_torch.models.vq_balanced import (
    balanced_vq_apply,
    balanced_vq_init,
)
from vqvae_speech_tpu_torch.utils.device import resolve_device


def initial_codebook(data, n_codes: int, seed: int) -> np.ndarray:
    """The codebook around the data statistics, drawn with numpy as the JAX
    demo draws it (so the two start from the same codebook)."""
    mean, std = data.mean(0), data.std(0)
    return (mean + std * np.random.default_rng(seed).standard_normal(
        (n_codes, 2))).astype(np.float32)


def train_balanced(data, n_codes=40, n_epochs=300, seed=0, *,
                   revival_draws=None, device="cuda"):
    """Returns (state, assignments, history). Each epoch revives dead codes
    with the epoch's entry of ``revival_draws`` when given (tests feed the
    JAX demo's), otherwise with draws from a generator seeded from
    ``seed``."""
    dev = resolve_device(device)
    generator = seeded_generator(seed)
    state = balanced_vq_init(n_codes, 2, device=dev, generator=generator)
    state["codebook"] = torch.from_numpy(
        initial_codebook(data, n_codes, seed)).to(dev)
    points = torch.as_tensor(np.asarray(data, np.float32), device=dev)

    history = []
    for epoch in range(n_epochs):
        out = balanced_vq_apply(
            state, points, training=True,
            revival_draws=None if revival_draws is None
            else revival_draws[epoch],
            revival_generator=generator)
        state = out.new_state
        history.append({"loss": float(out.vq_loss),
                        "perplexity": float(out.perplexity)})
    out = balanced_vq_apply(state, points, training=False)
    return state, out.indices.cpu().numpy(), history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output", default="vq_balanced_2d.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_matplotlib()
    data, labels = generate_2d_clusters(n_points=2000, n_clusters=40,
                                        noise=0.25)
    state, assignments, history = train_balanced(data, device=args.device)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    codebook = state["codebook"].cpu().numpy()
    usage = state["usage_count"].cpu().numpy()
    fig, axs = plt.subplots(2, 2, figsize=(14, 12))
    axs[0, 0].scatter(data[:, 0], data[:, 1], c=labels, s=6, cmap="hsv")
    axs[0, 0].set_title("groundtruth (40 clusters)")
    axs[0, 1].scatter(data[:, 0], data[:, 1], c=assignments, s=6, cmap="hsv")
    axs[0, 1].scatter(codebook[:, 0], codebook[:, 1], c="k", marker="x", s=80)
    axs[0, 1].set_title("balanced VQ assignments + codebook")
    axs[1, 0].plot([h["perplexity"] for h in history])
    axs[1, 0].set_title("perplexity (codebook coverage)")
    axs[1, 1].bar(np.arange(len(usage)), np.sort(usage)[::-1])
    axs[1, 1].set_title("code usage distribution")
    fig.savefig(args.output, bbox_inches="tight")
    plt.close(fig)
    print(f"final perplexity {history[-1]['perplexity']:.1f} -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
