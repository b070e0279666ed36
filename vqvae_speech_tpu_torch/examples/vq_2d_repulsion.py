"""2-D clustering demos with codebook repulsion + dead-code reset.

Counterpart of the repository's ``examples/vq_2d_repulsion.py``, the two
``old/`` demo variants of the reference:

* default mode — old/vqvae_2d_direct_fixed.py ("VQWithRepulsion"): EMA-VQ
  directly on Gaussian clusters with a pairwise repulsive force applied
  every step (min_distance 2.0).
* --improved — old/vqvae_2d_improved.py ("ImprovedVectorQuantizerEMA"): adds
  the outward-from-center force, a usage EMA, periodic dead-code reset from
  random input rows (reset_interval 30, threshold 1%), and k-means codebook
  init (scikit-learn's when it imports, else seeded random rows, as in the
  JAX demo).

    python -m vqvae_speech_tpu_torch.examples.vq_2d_repulsion \
        [--improved] [--output PNG] [--device cuda]
"""
import argparse

import numpy as np
import torch

from vqvae_speech_tpu_torch.examples import (
    require_matplotlib,
    seeded_generator,
)
from vqvae_speech_tpu_torch.examples.vq_2d_clustering import (
    record_epoch,
    ema_quantizer,
    final_assignments,
    generate_2d_clusters,
    initial_codebook,
    points_bct,
    visualize,
)
from vqvae_speech_tpu_torch.models.vq_repulsion import (
    codebook_repulsion,
    reset_dead_codes,
    usage_ema_update,
)
from vqvae_speech_tpu_torch.utils.device import resolve_device


def kmeans_init(data, k, seed=42):
    """k-means centers (scikit-learn), or ``k`` distinct rows drawn with
    ``np.random.default_rng(seed)`` where scikit-learn is not installed."""
    try:
        from sklearn.cluster import KMeans
    except ImportError:
        rng = np.random.default_rng(seed)
        return data[rng.choice(len(data), k, replace=False)]
    km = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(data)
    return km.cluster_centers_.astype(np.float32)


def train_repulsion_vq(data, n_epochs=200, num_embeddings=8, decay=0.99,
                       improved=False, repulsion_strength=None,
                       min_distance=None, reset_interval=30,
                       reset_threshold=0.01, seed=0, *, codebook0=None,
                       reset_perms=None, device="cuda"):
    """Returns (state, assignments, history, resets).

    ``codebook0`` (K, 2), when given, replaces the init (the seeded normals
    of ``vq_2d_clustering``, or k-means with ``improved``). Each dead-code
    reset permutes the input rows: with the i-th of ``reset_perms`` when
    given (tests feed the JAX demo's), otherwise with a draw from a
    generator seeded from ``seed``."""
    if repulsion_strength is None:
        # reference defaults: 0.01 (direct_fixed), 0.05 (improved)
        repulsion_strength = 0.05 if improved else 0.01
    if min_distance is None:
        min_distance = 1.5 if improved else 2.0
    outward = repulsion_strength * 0.5 if improved else 0.0
    dev = resolve_device(device)

    if codebook0 is None:
        codebook0 = (kmeans_init(data, num_embeddings) if improved
                     else initial_codebook(data, num_embeddings, seed))
    codebook0 = torch.tensor(np.asarray(codebook0), dtype=torch.float32)
    cluster0 = (torch.full((num_embeddings,), len(data) / num_embeddings)
                if improved else torch.zeros(num_embeddings))
    vq = ema_quantizer(codebook0, cluster0, codebook0, decay, dev)
    points = points_bct(data, dev)
    flat = points[0]                          # (N, 2): row i = point i
    usage = torch.zeros(num_embeddings, device=dev)
    generator = seeded_generator(seed)
    perms = None if reset_perms is None else iter(reset_perms)

    history = []
    resets = 0
    with torch.no_grad():
        for epoch in range(n_epochs):
            out = vq(points)
            usage = usage_ema_update(usage, out.counts, decay)
            cb = codebook_repulsion(vq.codebook, repulsion_strength,
                                    min_distance, outward_strength=outward)
            vq.codebook = cb
            # The reference clones raw POSITIONS into ema_w
            # (old/vqvae_2d_direct_fixed.py:109); as in the JAX demo the
            # displacement is kept consistent with the ema_w / cluster_size
            # parameterization instead, so the repulsed position survives
            # the next EMA update.
            vq.ema_w = cb * vq.ema_cluster_size[:, None]
            if improved and (epoch + 1) % reset_interval == 0:
                perm = (None if perms is None
                        else torch.tensor(np.asarray(next(perms))))
                r = reset_dead_codes(vq.codebook, vq.ema_w,
                                     vq.ema_cluster_size, usage, flat,
                                     threshold=reset_threshold, perm=perm,
                                     generator=generator)
                vq.codebook, vq.ema_w = r.codebook, r.ema_w
                vq.ema_cluster_size = r.cluster_size
                usage = r.usage
                resets += int(r.num_reset)
            record_epoch(history, epoch, out, vq)
    return vq.ema_state(), final_assignments(vq, points), history, resets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--improved", action="store_true",
                    help="outward force + dead-code reset + k-means init "
                         "(old/vqvae_2d_improved.py)")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_matplotlib()
    name = "vq_2d_improved.png" if args.improved else "vq_2d_repulsion.png"
    output = args.output or name

    data, labels = generate_2d_clusters()
    state, assignments, history, resets = train_repulsion_vq(
        data, improved=args.improved, device=args.device)
    visualize(data, labels, state, assignments, history, output)
    active = int((np.bincount(assignments, minlength=8) > 0).sum())
    print(f"final loss {history[-1]['loss']:.4f} "
          f"perplexity {history[-1]['perplexity']:.2f} "
          f"active {active}/8 resets {resets} -> {output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
