"""CLI: train / export features / dataset stats / evaluate / plots, on the
GPU by default.

Counterpart of ``vqvae_speech_tpu/main.py`` (flag parity with reference
src/main.py:68-146), with the same flags plus ``--device`` ("cuda" unless
the caller asks for "cpu") and ``--no_figures`` (write the evaluation's
number files and draw nothing: the GPU machine has no matplotlib; an
option that only draws a figure then raises). The configuration's
``use_cuda`` and ``use_device`` keys stay ignored, as in the JAX package.
Modes:

    python -m vqvae_speech_tpu_torch.main --export_to_features
    python -m vqvae_speech_tpu_torch.main --compute_dataset_stats
    python -m vqvae_speech_tpu_torch.main              # train, auto-resume
    python -m vqvae_speech_tpu_torch.main --experiments_configuration_path \
        spec.json  # a spec naming configurations/vctk_wavenet.yaml trains
                   # WaveNet-VQ-VAE (decoder_type: wavenet)
    python -m vqvae_speech_tpu_torch.main --evaluate --compute_alignments \
        --compute_clustering_metrics --no_figures
    python -m vqvae_speech_tpu_torch.main --plot_experiments_losses
    python -m vqvae_speech_tpu_torch.main --summary configurations/vctk_features.yaml

Paths are the JAX CLI's: ``configurations/vctk_features.yaml``, the
experiments JSON and ``--dataset_path`` relative to the working directory.
"""
import argparse
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger  # noqa: E402

BASE_CONFIGURATION = os.path.join("configurations", "vctk_features.yaml")


def build_parser():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--summary", nargs="?", default=None, type=str,
                   help="Print a parameter summary of the model from a configuration file")
    p.add_argument("--export_to_features", action="store_true",
                   help="Export the VCTK dataset files to features")
    p.add_argument("--compute_dataset_stats", action="store_true",
                   help="Compute the mean and the std of the VCTK dataset")
    p.add_argument("--experiments_configuration_path", nargs="?",
                   default=os.path.join("configurations",
                                        "experiments_vq44-mfcc39.json"),
                   type=str, help="Path of the experiments configuration file")
    p.add_argument("--experiments_path", nargs="?", default="experiments",
                   type=str, help="Path of the experiments output directory")
    p.add_argument("--dataset_path", nargs="?",
                   default=os.path.join("data", "vctk"), type=str,
                   help="Path of the VCTK dataset root")
    p.add_argument("--plot_experiments_losses", action="store_true",
                   help="Plot the losses of the experiments")
    p.add_argument("--evaluate", action="store_true", help="Evaluate the model")
    p.add_argument("--plot_comparaison_plot", action="store_true")
    p.add_argument("--plot_quantized_embedding_spaces", action="store_true")
    p.add_argument("--compute_quantized_embedding_spaces_animation",
                   action="store_true")
    p.add_argument("--plot_distances_histogram", action="store_true")
    p.add_argument("--compute_many_to_one_mapping", action="store_true")
    p.add_argument("--compute_alignments", action="store_true")
    p.add_argument("--alignment_subset", action="store", type=str,
                   default="val")
    p.add_argument("--compute_clustering_metrics", action="store_true")
    p.add_argument("--per_frame_alignments", action="store_true",
                   help="also compute the corrected per-frame empirical "
                        "alignments and clustering metrics (X extension; "
                        "the default keeps the reference's scrambled "
                        "(C,T,B)-flatten pairing for parity)")
    p.add_argument("--compute_groundtruth_average_phonemes_number",
                   action="store_true")
    p.add_argument("--plot_clustering_metrics_evolution", action="store_true")
    p.add_argument("--check_clustering_metrics_stability_over_seeds",
                   action="store_true")
    p.add_argument("--plot_gradient_stats", action="store_true")
    p.add_argument("--device", default="cuda", type=str,
                   help="Where the features are computed and the model "
                        "trains and is evaluated: cuda (a GPU), or cpu "
                        "when asked for")
    p.add_argument("--no_figures", action="store_true",
                   help="write the evaluation's number files and draw no "
                        "figure (no matplotlib needed); an option that only "
                        "draws a figure raises")
    return p


def _experiment_configuration(args):
    from vqvae_speech_tpu_torch.train import (
        load_configuration, update_configuration_from_experiments)

    return update_configuration_from_experiments(
        args.experiments_configuration_path,
        load_configuration(BASE_CONFIGURATION))


def main(argv=None):
    args = build_parser().parse_args(argv)

    from vqvae_speech_tpu_torch.train import Experiments, load_configuration

    evaluation_options = {
        k: getattr(args, k) for k in (
            "plot_comparaison_plot", "plot_quantized_embedding_spaces",
            "compute_quantized_embedding_spaces_animation",
            "plot_distances_histogram", "compute_many_to_one_mapping",
            "compute_alignments", "alignment_subset",
            "compute_clustering_metrics", "per_frame_alignments",
            "compute_groundtruth_average_phonemes_number",
            "plot_clustering_metrics_evolution",
            "check_clustering_metrics_stability_over_seeds",
            "plot_gradient_stats")}

    if args.summary:
        from vqvae_speech_tpu_torch.convert import jax_param_leaves
        from vqvae_speech_tpu_torch.models import ConvVQVAE

        configuration = load_configuration(args.summary)
        leaves = jax_param_leaves(ConvVQVAE.from_config(configuration))
        total = sum(leaf.tensor.numel() for leaf in leaves)
        ConsoleLogger.status(
            f"ConvolutionalVQVAE: {len(leaves)} tensors, {total:,} parameters")
        for leaf in leaves:
            shape = tuple(leaf.tensor.shape)
            if leaf.is_kernel:      # the JAX layout: transpose(2, 1, 0)
                shape = shape[::-1]
            name = "".join(f"['{key}']" for key in leaf.path)
            print(f"  {name}: {shape}")
        return 0

    if args.plot_experiments_losses:
        from vqvae_speech_tpu_torch.eval.evaluator import check_figures
        from vqvae_speech_tpu_torch.eval.losses_plotter import (
            plot_training_losses)

        check_figures({"plot_experiments_losses": True}, not args.no_figures)
        exps = Experiments.load(args.experiments_configuration_path,
                                device=args.device)
        plot_training_losses(exps.experiments, args.experiments_path)
        return 0

    if args.export_to_features:
        from vqvae_speech_tpu_torch.data.export import export_to_features
        from vqvae_speech_tpu_torch.data.vctk import VCTK

        configuration = _experiment_configuration(args)
        vctk = VCTK(args.dataset_path, ratio=configuration["train_val_split"])
        features_root = os.path.join(args.dataset_path,
                                     configuration["features_path"])
        export_to_features(vctk, features_root, configuration,
                           device=args.device)
        return 0

    if args.compute_dataset_stats:
        from vqvae_speech_tpu_torch.data import (
            FeatureStore, compute_dataset_stats)

        configuration = _experiment_configuration(args)
        features_root = os.path.join(args.dataset_path,
                                     configuration["features_path"])
        compute_dataset_stats(FeatureStore(features_root),
                              configuration["normalizer_path"])
        ConsoleLogger.success("Dataset stats computed")
        return 0

    if args.evaluate:
        Experiments.load(args.experiments_configuration_path,
                         device=args.device).evaluate(
            evaluation_options, figures=not args.no_figures)
        ConsoleLogger.success("All evaluating experiments done")
        return 0

    Experiments.load(args.experiments_configuration_path,
                     device=args.device).train()
    ConsoleLogger.success("All training experiments done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
