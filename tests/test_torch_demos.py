"""The port's examples (vqvae_speech_tpu_torch/examples/) against the
repository's JAX examples (examples/):

* the three 2-D demos' training functions, 5 epochs on the same data and
  initial codebook with JAX's draws fed (dead-code reset permutations,
  revival picks and noise): losses, perplexities and codebooks each epoch
  and the final state within rtol 1e-6 / atol 1e-6, the assignments equal;
* the JAX tests' own quality checks (tests/test_demos.py,
  tests/test_vq_adaptive.py) at their sizes, run by the port alone, with
  ARI from the port's eval/clustering_metrics.py;
* row i of the demos' flattened input is point i.

The JAX side runs with x64 off, its production semantics (tests/conftest.py
turns it on). The two other examples, ``encode_wav`` and ``serve_vocoder``,
are held to JAX's in tests/test_torch_host_utils.py.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import vq_2d_clustering as jax_clustering
from examples import vq_2d_repulsion as jax_repulsion
from examples import vq_balanced_2d as jax_balanced
from tests.test_torch_vocoder_train import one_torch_thread  # noqa: F401
from vqvae_speech_tpu_torch.eval.clustering_metrics import adjusted_rand_score
from vqvae_speech_tpu_torch.examples.vq_2d_clustering import (
    generate_2d_clusters,
    points_bct,
    train_direct_vq,
    visualize,
)
from vqvae_speech_tpu_torch.examples.vq_2d_repulsion import (
    kmeans_init,
    train_repulsion_vq,
)
from vqvae_speech_tpu_torch.examples.vq_balanced_2d import train_balanced
from vqvae_speech_tpu_torch.models import vq_adaptive
from vqvae_speech_tpu_torch.models.vq_repulsion import codebook_repulsion
from vqvae_speech_tpu_torch.ops.vq import reference_flatten

TOL = dict(rtol=1e-6, atol=1e-6)
EPOCHS = 5


def jax_initial_codebook(data, K, seed=0):
    """The JAX demos' init: mean + std * N(0, 1) from PRNGKey(seed)."""
    sequences = jnp.asarray(data.T[None])
    return np.asarray(sequences.mean() + sequences.std()
                      * jax.random.normal(jax.random.PRNGKey(seed), (K, 2)))


def assert_histories(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in w:
            np.testing.assert_allclose(g[name], w[name], err_msg=name, **TOL)


def assert_states(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_demo_rows_are_points():
    """The quantizer's flatten of the demos' input gives row i = point i;
    the JAX demo's input, (1, 2, N) in its (B, T, C) layout, is the same
    tensor."""
    data, _ = generate_2d_clusters(n_points=50, n_clusters=5)
    x = points_bct(data, "cpu")
    np.testing.assert_array_equal(reference_flatten(x, 2).numpy(), data)
    np.testing.assert_array_equal(x.transpose(1, 2).numpy(), data.T[None])
    # fed without the transpose, rows would pair one coordinate of
    # neighbouring points
    wrong = reference_flatten(torch.from_numpy(data.T[None].copy()), 2)
    assert not np.array_equal(wrong.numpy(), data)


def test_direct_vq_matches_jax():
    data, _ = generate_2d_clusters(n_points=300, n_clusters=5, noise=0.2)
    with jax.enable_x64(False):
        cb0 = jax_initial_codebook(data, 8)
        want = jax_clustering.train_direct_vq(data, n_epochs=EPOCHS)
    got = train_direct_vq(data, n_epochs=EPOCHS, codebook0=cb0, device="cpu")
    assert_histories(got[2], want[2])
    assert_states(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("improved", [False, True])
def test_repulsion_vq_matches_jax(improved):
    """With ``improved``, resets every 2 epochs at a 0.5 usage threshold, so
    that 5 epochs reset codes twice, from JAX's permutations."""
    data, _ = generate_2d_clusters(n_points=300, n_clusters=5, noise=0.2)
    kw = dict(n_epochs=EPOCHS, improved=improved)
    if improved:
        kw.update(reset_interval=2, reset_threshold=0.5)
    with jax.enable_x64(False):
        cb0 = (jax_repulsion.kmeans_init(data, 8) if improved
               else jax_initial_codebook(data, 8))
        want = jax_repulsion.train_repulsion_vq(data, **kw)
        key, perms = jax.random.PRNGKey(0), []
        for _ in range(EPOCHS // 2):
            key, sub = jax.random.split(key)
            perms.append(np.asarray(jax.random.permutation(sub, len(data))))
    if improved:   # scikit-learn's k-means, as the JAX demo's
        np.testing.assert_array_equal(kmeans_init(data, 8), cb0)
    got = train_repulsion_vq(data, codebook0=cb0, reset_perms=perms,
                             device="cpu", **kw)
    assert_histories(got[2], want[2])
    assert_states(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[3] == want[3]
    assert got[3] > 0 or not improved


def test_balanced_vq_matches_jax():
    data, _ = generate_2d_clusters(n_points=800, n_clusters=20, noise=0.2)
    from vqvae_speech_tpu_torch.models.vq_balanced import RevivalDraws

    with jax.enable_x64(False):
        want = jax_balanced.train_balanced(data, n_codes=20, n_epochs=EPOCHS)
        key, draws = jax.random.PRNGKey(0), []
        for _ in range(EPOCHS):
            key, sub = jax.random.split(key)
            k_pick, k_noise = jax.random.split(sub)
            draws.append(RevivalDraws(
                torch.from_numpy(np.array(jax.random.randint(
                    k_pick, (20,), 0, 3))),
                torch.from_numpy(np.array(jax.random.normal(
                    k_noise, (20, 2), jnp.float32)))))
    got = train_balanced(data, n_codes=20, n_epochs=EPOCHS,
                         revival_draws=draws, device="cpu")
    assert_histories(got[2], want[2])
    assert_states(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---- the JAX tests' quality checks, the port alone ----

def test_direct_vq_clusters_2d_points(tmp_path):
    data, labels = generate_2d_clusters(n_points=300, n_clusters=5, noise=0.2)
    state, assignments, history = train_direct_vq(
        data, n_epochs=60, num_embeddings=8, device="cpu")
    assert assignments.shape == (300,)
    assert history[-1]["loss"] < history[0]["loss"]
    assert adjusted_rand_score(labels, assignments) > 0.5
    out = visualize(data, labels, state, assignments, history,
                    str(tmp_path / "demo.png"))
    assert os.path.isfile(out)


def test_repulsion_vq_separates_codes():
    data, labels = generate_2d_clusters(n_points=300, n_clusters=5, noise=0.2)
    state, assignments, history, _ = train_repulsion_vq(
        data, n_epochs=60, num_embeddings=8, device="cpu")
    assert adjusted_rand_score(labels, assignments) > 0.5
    cb = state["codebook"].numpy()
    d = np.linalg.norm(cb[:, None] - cb[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 0.05
    moved = codebook_repulsion(
        torch.tensor([[0.0, 0.0], [0.1, 0.0], [10.0, 10.0]]), strength=0.1,
        min_distance=2.0).numpy()
    assert np.linalg.norm(moved[0] - moved[1]) > 0.1
    np.testing.assert_allclose(moved[2], [10.0, 10.0], atol=1e-6)


def test_improved_vq_end_to_end():
    data, labels = generate_2d_clusters(n_points=300, n_clusters=5, noise=0.2)
    state, assignments, history, resets = train_repulsion_vq(
        data, n_epochs=90, num_embeddings=8, improved=True, device="cpu")
    assert adjusted_rand_score(labels, assignments) > 0.5
    assert history[-1]["loss"] < history[0]["loss"] * 5


def test_balanced_vq_improves_coverage():
    data, labels = generate_2d_clusters(n_points=800, n_clusters=20,
                                        noise=0.2)
    state, assignments, history = train_balanced(data, n_codes=20,
                                                 n_epochs=120, device="cpu")
    assert history[-1]["perplexity"] > 10.0
    assert int((state["usage_count"] > 0).sum()) >= 18


def test_adaptive_training_converges_to_cluster_count():
    """tests/test_vq_adaptive.py's loop, the port's quantizer."""
    data, labels = generate_2d_clusters(n_points=600, n_clusters=5, noise=0.2)
    state = vq_adaptive.adaptive_vq_init(
        30, 2, initial_num_embeddings=20, device="cpu",
        generator=torch.Generator().manual_seed(0))
    state["codebook"] = torch.from_numpy(
        data.mean(0) + data.std(0)
        * np.random.default_rng(0).standard_normal((30, 2)).astype(np.float32))
    points = torch.from_numpy(data)
    for epoch in range(200):
        out = vq_adaptive.adaptive_vq_apply(state, points, training=True)
        state = out.new_state
        if (epoch + 1) % 50 == 0:
            state = vq_adaptive.adaptive_prune_and_merge(
                state, min_usage_threshold=0.01,
                merge_distance_threshold=0.8)
    n = vq_adaptive.active_codes_count(state)
    assert 3 <= n <= 12
    assert np.isfinite(float(out.vq_loss))


def test_demo_mains_refuse_without_matplotlib(monkeypatch, tmp_path):
    """Before any work: no figure file, no training."""
    from vqvae_speech_tpu_torch.examples import (
        vq_2d_clustering,
        vq_2d_repulsion,
        vq_balanced_2d,
    )

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "x.png")
    for mod in (vq_2d_clustering, vq_2d_repulsion, vq_balanced_2d):
        with pytest.raises(ImportError, match="matplotlib"):
            mod.main(["--output", out, "--device", "cpu"])
    assert not os.path.exists(out)
