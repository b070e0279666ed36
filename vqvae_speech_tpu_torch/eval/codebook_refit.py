"""Eval-side codebook refit (X — extension, no reference counterpart).

Counterpart of ``vqvae_speech_tpu/eval/codebook_refit.py``: the k-means
code (``kmeans_refit``, ``lloyd_kmeans`` and their helpers) is a numpy copy;
``collect_latents`` runs the port's model on its device.

Motivation (RESULTS.md, latent signal diagnostic): at the flagship
configuration the trained ENCODER's pre-VQ latents carry phone structure at
reference-headline level (k-means(44) ARI ~0.05) while the gradient-VQ
codebook's nearest-neighbor tessellation — shaped for reconstruction, not
clustering — scores ~0.002.  Refitting the codebook rows to the latent
cloud with k-means (initialized from the trained codebook, so surviving
codes keep their identity) recovers that clustering headroom WITHOUT
touching the trained parameters: this is an analysis-time view, the model
itself is unchanged.
"""
import numpy as np
import torch

__all__ = ["kmeans_refit", "collect_latents", "lloyd_kmeans"]


def collect_latents(model, feats_normalized, batch_size: int = 32, *,
                    device):
    """Pre-VQ latents z of the port's ``ConvVQVAE`` (already on ``device``)
    for a (N, T, F) normalized feature array -> (N, T_lat, D) numpy."""
    import torch

    out = []
    with torch.inference_mode():
        for start in range(0, feats_normalized.shape[0], batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                feats_normalized[start:start + batch_size],
                dtype=np.float32)).to(device)
            out.append(model.latents(chunk).transpose(1, 2).cpu().numpy())
    return np.concatenate(out, axis=0)


def kmeans_refit(codebook, latents_flat, iters: int = 50, seed: int = 0):
    """k-means over ``latents_flat`` (M, D), initialized at the trained
    ``codebook`` (K, D).  Returns (new_codebook, assignments).

    Runs Lloyd's twice — once seeded at the trained codebook (so surviving
    codes keep their identity when that init is good) and once with
    k-means++ (escapes the merge/split local optima a degenerate codebook
    init can't) — and keeps the lower-inertia solution.  Dead codes are
    re-seeded at distinct worst-served latents each iteration.
    """
    X = np.asarray(latents_flat, dtype=np.float64)
    K = np.asarray(codebook).shape[0]

    best = None
    for init_name in ("codebook", "kmeans++"):
        if init_name == "codebook":
            init = np.array(codebook, dtype=np.float64, copy=True)
        else:
            init = _kmeanspp_init(X, K, seed)
        cents, assign = _lloyd(init, X, iters, seed)
        inertia = float(((X - cents[assign]) ** 2).sum())
        if best is None or inertia < best[0]:
            best = (inertia, cents, assign)
    _, cents, assign = best
    return cents.astype(np.asarray(codebook).dtype), assign


def _sqdist(X, C):
    """(M, K) squared distances as ||x||^2 - 2 x.c + ||c||^2 — the direct
    (M, K, D) broadcast would be 2-22 GB per Lloyd iteration at real-VCTK
    latent-cloud scale (M ~ 1e5-1e6, K=44, D=64)."""
    d = ((X * X).sum(1)[:, None] - 2.0 * (X @ C.T) + (C * C).sum(1)[None])
    return np.maximum(d, 0.0)


def _kmeanspp_init(X, K, seed):
    rng = np.random.default_rng(seed)
    cents = [X[rng.integers(len(X))]]
    # incremental min-distance update: O(K*M*D) total, not O(K^2*M*D)
    d = _sqdist(X, cents[-1][None])[:, 0]
    for _ in range(K - 1):
        s = float(d.sum())
        if s <= 0.0:
            # fewer than K distinct points (the collapse regime this tool
            # exists to study): every remaining center is a duplicate —
            # pick uniformly instead of crashing on an all-zero p
            cents.append(X[rng.integers(len(X))])
            continue
        cents.append(X[rng.choice(len(X), p=d / s)])
        d = np.minimum(d, _sqdist(X, cents[-1][None])[:, 0])
    return np.stack(cents)


def lloyd_kmeans(X, k, seed, iters: int = 50):
    """Plain Lloyd's k-means assignments: random data-point init, empty
    clusters keep their previous center, `allclose` convergence stop.

    The ONE shared implementation behind the analysis scripts'
    latent/raw-feature k-means (scripts/latent_signal_diagnostic.py,
    scripts/corpus_ari_ceiling.py) — same update rule they originally
    inlined, but on the expanded-norm distances (`_sqdist`) instead of the
    (M, k, D) broadcast, which is 2-22 GB per iteration at real-VCTK
    latent-cloud scale."""
    X = np.asarray(X)
    rng = np.random.default_rng(seed)
    # replace=False needs k distinct rows; fall back to with-replacement on
    # degenerate (smaller-than-k) clouds rather than crash
    cents = X[rng.choice(len(X), k, replace=len(X) < k)]
    a = np.zeros(len(X), dtype=np.int64)
    for _ in range(iters):
        a = np.argmin(_sqdist(X, cents), axis=1)
        new = np.stack([X[a == j].mean(0) if (a == j).any() else cents[j]
                        for j in range(k)])
        if np.allclose(new, cents):
            break
        cents = new
    return a


def _lloyd(cents, X, iters, seed):
    rng = np.random.default_rng(seed)
    cents = np.array(cents, dtype=np.float64, copy=True)
    K = cents.shape[0]
    for _ in range(iters):
        d = _sqdist(X, cents)
        a = np.argmin(d, axis=1)
        moved = False
        dead = [j for j in range(K) if not (a == j).any()]
        if dead:
            # re-seed ALL dead codes at DISTINCT worst-served latents
            # (one shared point would collapse them right back together)
            order = np.argsort(-d[np.arange(len(X)), a])
            for j, idx in zip(dead, order[: len(dead)]):
                cents[j] = X[int(idx)] + 1e-6 * rng.standard_normal(
                    X.shape[1])
            moved = True
        for j in range(K):
            sel = a == j
            if sel.any():
                nc = X[sel].mean(0)
                if not np.allclose(nc, cents[j]):
                    moved = True
                cents[j] = nc
        if not moved:
            break
    return cents, np.argmin(_sqdist(X, cents), axis=1)
