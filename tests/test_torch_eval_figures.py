"""PyTorch port: the evaluation's figures, where matplotlib is installed
(the GPU machine has none; there the port runs with ``--no_figures``).

Every figure option of ``--evaluate``, the figures drawn inside the
number-producing calls, the cross-experiment evolution and stability plots
and ``--plot_experiments_losses`` write their files, under the JAX
package's names (``tests/test_eval.py`` and the JAX modules name them; the
mini corpus's val split holds one speaker, so neither package draws the
speaker-dependency plot, which needs two). The embedding-space
projection is a numpy PCA (no scikit-learn or UMAP on the GPU machine):
it matches ``sklearn.decomposition.PCA(n_components=2).fit_transform``
within 1e-6 in both of scikit-learn's exact regimes ("full" SVD below
500 points, "covariance_eigh" from ten points a feature on).
"""
import os

import numpy as np
import pytest
from sklearn.decomposition import PCA

from test_torch_evaluator import NAME, build_experiment
from vqvae_speech_tpu_torch import main as tmain
from vqvae_speech_tpu_torch.eval.embedding_space_stats import project_2d
from vqvae_speech_tpu_torch.train import Experiments

FIGURE_OPTIONS = {
    "plot_comparaison_plot": True,
    "plot_quantized_embedding_spaces": True,
    "plot_distances_histogram": True,
    "test_denormalization": True,
    "compute_quantized_embedding_spaces_animation": True,
    "plot_gradient_stats": True,
    "compute_alignments": True,
    "alignment_subset": "val",
    "compute_clustering_metrics": True,
    "compute_speaker_dependency_stats": True,
    "compute_entropy_distributions": True,
    "plot_clustering_metrics_evolution": True,
    "check_clustering_metrics_stability_over_seeds": True,
}


def _figures(directory):
    return sorted(f for f in os.listdir(directory)
                  if f.endswith((".png", ".gif")))


def test_every_figure_is_written_as_jax_writes_it(tmp_path):
    root = str(tmp_path)
    spec_torch, _, store_root = build_experiment(
        root, record_codebook_stats=True, record_gradient_stats=True)
    Experiments.load(spec_torch, data_root=store_root,
                     device="cpu").evaluate(FIGURE_OPTIONS)
    got = _figures(os.path.join(root, "results_torch"))
    assert got == sorted([
        f"{NAME}_evaluation-comparaison-plot.png",
        f"{NAME}_distances-histogram-plot.png",
        f"{NAME}_quantized-embedding-space.png",
        f"{NAME}_test-denormalization-plot.png",
        f"{NAME}_embedding_space_animation.gif",
        f"{NAME}_gradient_flow.png",
        f"{NAME}_entropy-stats-plot.png",
        "vctk_val_groundtruth_bigrams_wo_diag_20ms.png",
        f"{NAME}_vctk_val_empirical_bigrams_wo_diag_10ms.png",
        f"{NAME}_vctk_val_empirical_frequency_10ms.png",
        "clustering_metrics_evolution.png",
        "clustering_metrics_stability.png"])
    for name in got:
        assert os.path.getsize(os.path.join(root, "results_torch", name)) > 0

    # the gradient-stats pickles the port's trainer wrote, read by both
    from vqvae_speech_tpu.eval.gradient_stats import (
        load_gradient_entries as jax_entries)
    from vqvae_speech_tpu_torch.eval.gradient_stats import (
        load_gradient_entries)
    entries = load_gradient_entries(os.path.join(root, "experiments"), NAME)
    want = jax_entries(os.path.join(root, "experiments"), NAME)
    assert entries and [e[:2] for e in entries] == [w[:2] for w in want]

    # --plot_experiments_losses through the CLI, on the CPU
    assert tmain.main(["--plot_experiments_losses",
                       "--experiments_configuration_path", spec_torch,
                       "--experiments_path", os.path.join(root, "experiments"),
                       "--device", "cpu"]) == 0
    for name in (f"{NAME}_losses-and-perplexities.png", "merged_loss.png",
                 "reconstruction_loss.png"):
        assert os.path.isfile(os.path.join(root, "results_torch", name)), name
    with pytest.raises(ValueError, match="--no_figures"):
        tmain.main(["--plot_experiments_losses", "--no_figures",
                    "--experiments_configuration_path", spec_torch,
                    "--device", "cpu"])


@pytest.mark.parametrize("n", [40, 300, 700, 2000])
def test_projection_matches_sklearn_pca(n):
    rng = np.random.default_rng(n)
    points = (rng.standard_normal((n, 64)) * np.linspace(3.0, 0.1, 64)
              + rng.standard_normal(64))
    got = project_2d(points, seed=0)
    want = PCA(n_components=2, random_state=0).fit_transform(points)
    assert got.shape == (n, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_figure_helpers_match_jax(tmp_path):
    """``eval/utils.py``: the random categorical colormap's colors equal
    the JAX package's, and the GIF builder writes its file."""
    from vqvae_speech_tpu.eval import utils as jutils
    from vqvae_speech_tpu_torch.eval import utils as tutils

    got, want = tutils.rand_cmap(12, seed=3), jutils.rand_cmap(12, seed=3)
    np.testing.assert_array_equal(got(np.arange(12)), want(np.arange(12)))
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = []
    for i in range(2):
        path = str(tmp_path / f"frame{i}.png")
        plt.imsave(path, np.full((8, 8), float(i)))
        frames.append(path)
    out = tutils.build_gif(frames, str(tmp_path / "frames.gif"))
    assert os.path.getsize(out) > 0
