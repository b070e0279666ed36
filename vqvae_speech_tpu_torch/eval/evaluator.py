"""Evaluator: dispatch of all --evaluate sub-options, on the port's model.

Counterpart of ``vqvae_speech_tpu/eval/evaluator.py`` (reference
src/experiments/evaluator.py:44-503): single-batch evaluation capture with
the eval-only pairwise distance tensors, comparison plot, distance
histograms, embedding-space projections, many-to-one token->phoneme
mapping, alignments and clustering metrics, speaker-dependency and entropy
statistics. The same options, files and file contents as the JAX
evaluator's.

The model is the experiment's newest checkpoint (the JAX package's
format) in a ``ConvVQVAE`` on ``device`` (on a GPU with TF32 off, the
configuration's f32, as the trainer runs it), in eval mode: evaluation changes
no parameter or buffer (in training mode an EMA quantizer would replace
its buffers). Every encode goes through ``VectorQuantizer`` and so through
``ops.vq_search``, the CUDA kernel on the card. The batch sizes are the JAX
evaluator's (32 for the alignments and the mapping, 16 for the speaker and
entropy pass, 1 for the single-batch capture), since the reference's
(C, T, B) flatten pairs a frame with a row of another batch item.

With no checkpoint the model is a fresh init drawn from a
``torch.Generator`` seeded with the experiment's seed: the JAX package's
``jax.random`` stream cannot be reproduced here.

Figures: the number files are always written; figures are drawn unless
``figures=False``. With figures on and matplotlib missing, the evaluator
raises ``ImportError`` before any work; an option that only draws a figure
raises ``ValueError`` under ``figures=False`` (``check_figures``).
"""
import importlib.util
import os
import pickle

import numpy as np
import torch

from vqvae_speech_tpu_torch.data import FeatureStore, load_normalizer
from vqvae_speech_tpu_torch.data.textgrid import read_textgrid
from vqvae_speech_tpu_torch.eval.alignment_stats import (
    encode_codes,
    normalized_features,
    textgrid_path,
)
from vqvae_speech_tpu_torch.ops.pairwise import cdist, pdist
from vqvae_speech_tpu_torch.ops.vq import reference_flatten
from vqvae_speech_tpu_torch.utils.device import resolve_device
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger

# options (evaluation options and CLI modes) whose only product is a figure
FIGURE_OPTIONS = (
    "plot_comparaison_plot", "plot_quantized_embedding_spaces",
    "plot_distances_histogram", "test_denormalization",
    "compute_quantized_embedding_spaces_animation", "plot_gradient_stats",
    "plot_clustering_metrics_evolution",
    "check_clustering_metrics_stability_over_seeds",
    "plot_experiments_losses")


def check_figures(options: dict, figures: bool) -> None:
    """Before any work: with ``figures`` on, matplotlib must be importable;
    with it off, no option whose only product is a figure may be asked
    for."""
    if figures:
        if importlib.util.find_spec("matplotlib") is None:
            raise ImportError(
                "the evaluation draws its figures with matplotlib, which is "
                "not installed: pass --no_figures (figures=False) to write "
                "the number files alone")
        return
    asked = [name for name in FIGURE_OPTIONS if options.get(name)]
    if asked:
        raise ValueError(f"{', '.join('--' + a for a in asked)} only draw "
                         "figures, and figures are off (--no_figures)")


def log1p_spectrogram(y: np.ndarray, rate: int = 16000,
                      window_size: float = 0.02, window_stride: float = 0.01):
    """Hamming-window STFT magnitude -> log1p
    (reference src/dataset/spectrogram_parser.py:77-98)."""
    from scipy.signal import stft as scipy_stft

    n_fft = int(rate * window_size)
    hop = int(rate * window_stride)
    _, _, Z = scipy_stft(y, fs=rate, window="hamming", nperseg=n_fft,
                         noverlap=n_fft - hop, nfft=n_fft, boundary=None,
                         padded=False)
    # scipy scales by 1/sum(win); undo to get librosa-style raw magnitudes
    win_sum = np.hamming(n_fft).sum()
    return np.log1p(np.abs(Z) * win_sum)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Evaluator:
    def __init__(self, experiment, data_root=None, *, device,
                 figures: bool = True):
        check_figures({}, figures)
        self._experiment = experiment
        self._cfg = experiment.configuration
        self._name = experiment.name
        self._experiments_path = experiment.experiments_path
        self._results_path = experiment.results_path
        self._data_root = data_root
        self._device = resolve_device(device)
        if self._device.type == "cuda":
            # the configuration's f32, as the trainer sets it: PyTorch's
            # default would let cuDNN run the convolutions in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._figures = figures
        os.makedirs(self._results_path, exist_ok=True)
        self._model = None
        self._store = None

    # ---------------- lazy pipeline ----------------

    def _load_model(self):
        """The newest checkpoint's ConvVQVAE on the device, in eval mode."""
        if self._model is not None:
            return self._model
        from vqvae_speech_tpu_torch.convert import load_jax_params
        from vqvae_speech_tpu_torch.models import ConvVQVAE
        from vqvae_speech_tpu_torch.train.checkpoint import (
            latest_checkpoint_epoch, load_checkpoint)

        epoch, path = latest_checkpoint_epoch(self._experiments_path,
                                              self._name)
        if path is None:
            ConsoleLogger.warn(
                f"No checkpoint for '{self._name}'; evaluating a fresh init "
                f"(torch.Generator seeded with {self._experiment.seed})")
            model = ConvVQVAE.from_config(
                self._cfg,
                generator=torch.Generator().manual_seed(self._experiment.seed))
        else:
            ConsoleLogger.status(f"Evaluating checkpoint epoch {epoch}")
            ckpt = load_checkpoint(path)
            model = load_jax_params(ConvVQVAE.from_config(self._cfg),
                                    ckpt["params"], ckpt["model_state"])
        self._model = model.to(self._device).eval()
        return self._model

    def _load_store(self):
        if self._store is None:
            root = self._data_root or os.path.join(
                self._cfg.get("data_root", "."),
                self._cfg.get("features_path", "features"))
            self._store = FeatureStore(root)
        return self._store

    def _normalizer(self):
        if self._cfg.get("normalize"):
            return load_normalizer(self._cfg["normalizer_path"])
        return None

    def _codebook(self) -> np.ndarray:
        """The trained codebook: the EMA buffer or the gradient variant's
        parameter (the JAX package's state["vq"] or params["vq"])."""
        return _host(self._load_model().vq.codebook)

    # ---------------- dispatch ----------------

    def evaluate(self, evaluation_options: dict):
        o = evaluation_options
        check_figures(o, self._figures)
        subset = o.get("alignment_subset", "val")
        results = {}
        need_once = (o.get("plot_comparaison_plot")
                     or o.get("plot_quantized_embedding_spaces")
                     or o.get("plot_distances_histogram"))
        need_once = need_once or o.get("test_denormalization")
        if need_once:
            entry = self._evaluate_once()
            if o.get("plot_comparaison_plot"):
                results["comparaison_plot"] = \
                    self._compute_comparaison_plot(entry)
            if o.get("test_denormalization"):
                results["denormalization"] = \
                    self._test_denormalization(entry)
            if o.get("plot_quantized_embedding_spaces"):
                results["embedding_spaces"] = \
                    self._plot_quantized_embedding_spaces(entry)
            if o.get("plot_distances_histogram"):
                results["distances_histogram"] = \
                    self._plot_distances_histogram(entry)
        if o.get("compute_quantized_embedding_spaces_animation"):
            from vqvae_speech_tpu_torch.eval.embedding_space_stats import (
                compute_quantized_embedding_spaces_animation)

            results["animation"] = compute_quantized_embedding_spaces_animation(
                self._experiments_path, self._name, self._results_path)
        if o.get("compute_many_to_one_mapping"):
            results["many_to_one"] = self._many_to_one_mapping(subset)
        if o.get("compute_alignments"):
            results["alignments"] = self._compute_alignments(
                subset, per_frame=o.get("per_frame_alignments", False))
        if o.get("compute_clustering_metrics"):
            from vqvae_speech_tpu_torch.eval.alignment_stats import (
                compute_clustering_metrics)

            results["clustering_metrics"] = compute_clustering_metrics(
                self._results_path, self._name, subset, self._cfg)
            if o.get("per_frame_alignments"):
                results["clustering_metrics_per_frame"] = \
                    compute_clustering_metrics(
                        self._results_path, self._name, subset, self._cfg,
                        per_frame=True)
        if o.get("compute_groundtruth_average_phonemes_number"):
            from vqvae_speech_tpu_torch.eval.alignment_stats import (
                compute_groundtruth_average_phonemes_number)

            results["avg_phonemes"] = \
                compute_groundtruth_average_phonemes_number(
                    self._results_path, subset)
        if o.get("plot_gradient_stats"):
            results["gradient_stats"] = self._plot_gradient_stats()
        # Extensions beyond the reference's dispatch: the reference ships
        # these analyses but never wires them in (evaluator.py:409-503).
        if o.get("compute_speaker_dependency_stats") or \
                o.get("compute_entropy_distributions"):
            results.update(self._speaker_and_entropy_stats(
                subset,
                speaker=o.get("compute_speaker_dependency_stats", False),
                entropy=o.get("compute_entropy_distributions", False)))
        return results

    def _speaker_and_entropy_stats(self, subset, speaker=True, entropy=True):
        model = self._load_model()
        data = self._load_store().open(subset)
        feats = normalized_features(data, self._cfg)
        speakers = np.asarray(data["speaker_ids"])

        indices, quantizeds, recons = [], [], []
        with torch.inference_mode():
            for start in range(0, feats.shape[0], 16):
                x = torch.from_numpy(feats[start:start + 16]).to(self._device)
                out = model(x)
                indices.extend(list(_host(
                    out.encoding_indices.view(x.shape[0], -1))))
                quantizeds.extend(list(_host(out.quantized)))
                recons.extend(list(_host(out.reconstructed_x)))

        results = {}
        if speaker:
            from vqvae_speech_tpu_torch.eval.speaker_stats import (
                compute_speaker_dependency_stats)

            results["speaker_dependency"] = compute_speaker_dependency_stats(
                indices, speakers, self._cfg["num_embeddings"],
                self._results_path, self._name, plot=self._figures)
        if entropy:
            from vqvae_speech_tpu_torch.eval.speaker_stats import (
                compute_entropy_distributions)

            results["entropy_distributions"] = compute_entropy_distributions(
                feats, quantizeds, recons, self._results_path, self._name,
                plot=self._figures)
        return results

    # ---------------- single-batch capture ----------------

    def _evaluate_once(self, batch_index: int = 0):
        """Forward one val utterance capturing every VQ output, including the
        pairwise distances (reference evaluator.py:120-163)."""
        model = self._load_model()
        store = self._load_store()
        data = store.open("val")
        meta = store.metadata("val")
        norm = self._normalizer()

        x = np.asarray(data["input_features"][batch_index:batch_index + 1],
                       np.float32)
        target = np.asarray(data["output_features"][batch_index:batch_index + 1],
                            np.float32)
        if norm is not None:
            x = ((x - norm["train_mean"]) / norm["train_std"]).astype(np.float32)
            target = ((target - norm["train_mean"])
                      / norm["train_std"]).astype(np.float32)

        codebook = model.vq.codebook
        with torch.inference_mode():
            out = model(torch.from_numpy(x).to(self._device))
            z = out.pre_vq_latents                       # (B, T', D)
            flat = reference_flatten(z.transpose(1, 2), codebook.shape[1])
            B, T = x.shape[0], z.shape[1]
            encoding_distances = _host(pdist(flat)).reshape(B, -1)
            embedding_distances = _host(pdist(codebook))
            frames_vs_embedding = _host(cdist(flat, codebook)).reshape(
                B, T, -1)
            indices = _host(out.encoding_indices)
            reconstruction = _host(out.reconstructed_x[0])
            captured = {name: _host(getattr(out, name)) for name in
                        ("quantized", "encodings", "distances")}

        audio = (np.asarray(data["preprocessed_audio"][batch_index])
                 if "preprocessed_audio" in data.files else None)
        wavs = meta.get("wav_filenames", [])
        return {
            "preprocessed_audio": audio,
            "valid_originals": x,
            "speaker_ids": np.asarray(
                data["speaker_ids"][batch_index:batch_index + 1]),
            "target": target,
            "wav_filename": (wavs[batch_index] if batch_index < len(wavs)
                             else str(batch_index)),
            **captured,
            "encoding_indices": indices,
            "encoding_distances": encoding_distances,
            "embedding_distances": embedding_distances,
            "frames_vs_embedding_distances": frames_vs_embedding,
            "concatenated_quantized": self._codebook()[indices[:, 0]],
            "valid_reconstructions": reconstruction,
        }

    def _compute_unified_time_scale(self, shape, winstep=0.01,
                                    downsampling_factor=1):
        return np.arange(shape) * winstep * downsampling_factor

    def _compute_comparaison_plot(self, entry):
        """Six-panel plot: waveform, spectrogram, MFCC, softmax(-distances),
        encodings, reconstruction (reference evaluator.py:165-231)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from scipy.special import softmax

        rate = self._cfg["sampling_rate"]
        fig, axs = plt.subplots(6, 1, figsize=(20, 18), sharex=True)

        audio = entry["preprocessed_audio"]
        axs[0].set_title("Waveform of the original speech signal")
        if audio is not None:
            axs[0].plot(np.arange(len(audio)) / float(rate), audio)

        axs[1].set_title("Spectrogram of the original speech signal")
        if audio is not None:
            spec = log1p_spectrogram(audio, rate)
            self._plot_pcolormesh(
                spec, fig, x=self._compute_unified_time_scale(spec.shape[1]),
                axis=axs[1])

        originals = entry["valid_originals"][0].T  # (C, T)
        axs[2].set_title("Augmented MFCC + d + a of the original speech signal")
        self._plot_pcolormesh(
            originals, fig,
            x=self._compute_unified_time_scale(originals.shape[1]), axis=axs[2])

        probs = softmax(-entry["distances"][0], axis=1).T
        axs[3].set_title("Softmax of distances computed in VQ")
        self._plot_pcolormesh(
            probs, fig,
            x=self._compute_unified_time_scale(probs.shape[1],
                                               downsampling_factor=2),
            axis=axs[3])

        encodings = entry["encodings"][0].T
        axs[4].set_title("Encodings")
        self._plot_pcolormesh(
            encodings, fig,
            x=self._compute_unified_time_scale(encodings.shape[1],
                                               downsampling_factor=2),
            axis=axs[4])

        recon = entry["valid_reconstructions"].T
        axs[5].set_title("Actual reconstruction")
        self._plot_pcolormesh(
            recon, fig, x=self._compute_unified_time_scale(recon.shape[1]),
            axis=axs[5])

        out = os.path.join(self._results_path,
                           f"{self._name}_evaluation-comparaison-plot.png")
        fig.savefig(out, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return out

    def _plot_pcolormesh(self, data, fig, x=None, y=None, axis=None):
        import matplotlib.pyplot as plt

        axis = plt.gca() if axis is None else axis
        x = np.arange(data.shape[1]) if x is None else x
        y = np.arange(data.shape[0]) if y is None else y
        c = axis.pcolormesh(x, y, data, shading="auto")
        fig.colorbar(c, ax=axis)

    def _plot_distances_histogram(self, entry):
        """Three histograms: encoding/embedding/frames-vs-embedding distances
        (reference evaluator.py:243-272)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(3, 1, figsize=(15, 10), sharex=True)
        axs[0].set_title("Distances between the encoding vectors")
        axs[0].hist(entry["encoding_distances"][0], bins=50, density=True)
        axs[1].set_title("Distances between the embedding vectors")
        axs[1].hist(entry["embedding_distances"], bins=50, density=True)
        axs[2].set_title("Distances between frames and embedding vectors")
        axs[2].hist(entry["frames_vs_embedding_distances"].ravel(), bins=50,
                    density=True)
        out = os.path.join(self._results_path,
                           f"{self._name}_distances-histogram-plot.png")
        fig.savefig(out, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return out

    def _test_denormalization(self, entry):
        """Four-panel plot: normalized + denormalized originals and
        reconstructions (reference evaluator.py:276-306)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        norm = self._normalizer()
        originals = entry["valid_originals"][0].T       # (C, T)
        recon = entry["valid_reconstructions"].T
        if norm is not None:
            denorm_orig = (norm["train_std"][:, None] * originals
                           + norm["train_mean"][:, None])
            denorm_recon = (norm["train_std"][:, None] * recon
                            + norm["train_mean"][:, None])
        else:
            denorm_orig, denorm_recon = originals, recon

        fig, axs = plt.subplots(4, 1, figsize=(20, 12), sharex=True)
        panels = [("Augmented MFCC + d + a of the original speech signal",
                   originals),
                  ("Actual reconstruction", recon),
                  ("Denormalized target", denorm_orig),
                  ("Denormalized reconstruction", denorm_recon)]
        for ax, (title, data) in zip(axs, panels):
            ax.set_title(title)
            self._plot_pcolormesh(
                np.asarray(data), fig,
                x=self._compute_unified_time_scale(data.shape[1]), axis=ax)
        out = os.path.join(self._results_path,
                           f"{self._name}_test-denormalization-plot.png")
        fig.savefig(out, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return out

    def _plot_quantized_embedding_spaces(self, entry):
        from vqvae_speech_tpu_torch.eval.embedding_space_stats import (
            plot_quantized_embedding_space)

        frames = entry["concatenated_quantized"]
        speakers = np.repeat(entry["speaker_ids"], frames.shape[0])
        out = os.path.join(
            self._results_path,
            f"{self._name}_quantized-embedding-space.png")
        return plot_quantized_embedding_space(frames, self._codebook(),
                                              speakers, out)

    # ---------------- corpus-wide analyses ----------------

    def _phonemes_root(self):
        vctk_root = os.path.join(self._cfg.get("data_root", "."), "vctk")
        for root in (vctk_root, self._cfg.get("data_root", ".")):
            p = os.path.join(root, "raw", "VCTK-Corpus", "phonemes")
            if os.path.isdir(p):
                return p
        return None

    def _compute_alignments(self, subset, per_frame=False):
        from vqvae_speech_tpu_torch.eval.alignment_stats import (
            compute_groundtruth_alignments, compute_empirical_alignments,
            compute_groundtruth_bigrams_matrix,
            compute_empirical_bigrams_matrix,
            compute_empirical_encodings_frequency)

        model = self._load_model()
        store = self._load_store()
        outs = {}
        phonemes_root = self._phonemes_root()
        if phonemes_root is not None:
            outs["groundtruth"] = compute_groundtruth_alignments(
                store, subset, self._cfg, self._results_path, phonemes_root)
            outs["gt_bigrams"] = compute_groundtruth_bigrams_matrix(
                self._results_path, subset, plot=self._figures)
        else:
            ConsoleLogger.warn("No phonemes directory found; skipping "
                               "groundtruth alignments")
        outs["empirical"] = compute_empirical_alignments(
            model, store, subset, self._cfg, self._results_path, self._name)
        if per_frame:
            # corrected per-frame view alongside the parity default
            # (--per_frame_alignments; alignment_stats.encode_codes)
            outs["empirical_per_frame"] = compute_empirical_alignments(
                model, store, subset, self._cfg, self._results_path,
                self._name, per_frame=True)
        outs["emp_bigrams"] = compute_empirical_bigrams_matrix(
            self._results_path, self._name, subset, plot=self._figures)
        outs["emp_frequency"] = compute_empirical_encodings_frequency(
            self._results_path, self._name, subset, plot=self._figures)
        return outs

    def _many_to_one_mapping(self, subset):
        """Token -> phoneme distribution mapping
        (reference evaluator.py:307-407). A frame at time t takes the mark
        of the FIRST interval with minTime <= t <= maxTime, so a frame on a
        boundary belongs to the earlier interval."""
        model = self._load_model()
        store = self._load_store()
        phonemes_root = self._phonemes_root()
        if phonemes_root is None:
            ConsoleLogger.warn("No phonemes directory; skipping mapping")
            return None

        data = store.open(subset)
        meta = store.metadata(subset)
        wavs = meta.get("wav_filenames", [])
        shifts = meta.get("shifting_times", [0.0] * len(wavs))
        feats = normalized_features(data, self._cfg)

        phonemes_mapping = {}
        for start in range(0, feats.shape[0], 32):
            idx = _host(encode_codes(model, torch.from_numpy(
                feats[start:start + 32]).to(self._device)))
            for i in range(idx.shape[0]):
                gi = start + i
                if gi >= len(wavs):
                    continue
                tg_path = textgrid_path(phonemes_root, wavs[gi])
                if not os.path.isfile(tg_path):
                    continue
                tg = read_textgrid(tg_path)
                times = (self._compute_unified_time_scale(
                    idx.shape[1], downsampling_factor=2) + float(shifts[gi]))
                for t, token in zip(times, idx[i]):
                    phoneme = None
                    for interval in tg.tiers[1]:
                        if interval.minTime <= t <= interval.maxTime:
                            phoneme = interval.mark
                            break
                    phonemes_mapping.setdefault(phoneme, []).append(int(token))

        tokens_mapping = {}
        for phoneme, indices in phonemes_mapping.items():
            for index in set(indices):
                tokens_mapping.setdefault(index, []).append(
                    (phoneme, indices.count(index) / len(indices)))
        for index in tokens_mapping:
            tokens_mapping[index].sort(key=lambda x: x[1], reverse=True)

        with open(os.path.join(self._results_path,
                               f"{self._name}_phonemes_mapping.pickle"),
                  "wb") as f:
            pickle.dump(phonemes_mapping, f)
        with open(os.path.join(self._results_path,
                               f"{self._name}_tokens_mapping.pickle"),
                  "wb") as f:
            pickle.dump(tokens_mapping, f)
        return tokens_mapping

    def _plot_gradient_stats(self):
        from vqvae_speech_tpu_torch.eval.gradient_stats import (
            load_gradient_entries, plot_gradient_flow_over_epochs)

        entries = load_gradient_entries(self._experiments_path, self._name)
        out = os.path.join(self._results_path,
                           f"{self._name}_gradient_flow.png")
        return plot_gradient_flow_over_epochs(entries, out)
