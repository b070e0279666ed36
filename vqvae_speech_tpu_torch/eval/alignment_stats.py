"""Alignment statistics: groundtruth/empirical alignments, bigrams,
frequencies, clustering metrics (ARI/AMI/NMI), evolution/stability plots.

Counterpart of ``vqvae_speech_tpu/eval/alignment_stats.py`` (reference
src/evaluation/alignment_stats.py:42-749), with the same files under the
same names and contents:

* groundtruth alignments: each utterance's TextGrid phoneme tier resampled
  onto a 20 ms grid starting at its shifting time, trailing digits
  stripped from the phone labels, frequencies counted,
* empirical alignments: one batched encoder + VQ sweep over the split on
  the model's device, every batch through ``ops.vq_search`` (the CUDA
  kernel for a model on the card),
* bigram matrices, row-L1-normalized, the diagonal zeroed by default; the
  empirical one is skipped above 100 codes,
* clustering metrics between the concatenated groundtruth and empirical
  alignments, saved as ``{name}_{metric}.npy``; computed by
  ``eval/clustering_metrics.py`` (numpy and scipy; the JAX package calls
  scikit-learn, which the GPU machine does not have),
* evolution-over-experiments and stability-over-seeds plots reading those
  files back.

Pickles hold numpy arrays and builtins only: code sequences are int32
arrays, as the JAX package's are, so either package reads the other's
files. The functions that draw inside a number-producing call take
``plot=``; the numbers are written either way.
"""
import os
import pickle

import numpy as np
import torch

from vqvae_speech_tpu_torch.data import load_normalizer
from vqvae_speech_tpu_torch.data.textgrid import read_textgrid
from vqvae_speech_tpu_torch.eval.clustering_metrics import clustering_scores
from vqvae_speech_tpu_torch.ops.vq import vq_search
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger

DESIRED_GT_INTERVAL = 0.02   # 20 ms groundtruth grid (reference line 61)
DESIRED_EMP_INTERVAL = 0.01  # stored in the empirical pickle (line 280)


# -------------------- groundtruth --------------------


def resample_phoneme_tier(tg, data_length: float, shifting_time: float,
                          desired_time_interval: float = DESIRED_GT_INTERVAL):
    """Resample a TextGrid phoneme tier (tiers[1]) to the desired grid.

    Returns (phonemes list, counter dict) or (None, counter) when the
    alignment does not cover the window (reference lines 111-155, including
    the strip-trailing-digit normalization and the last-interval fill-in).
    """
    n_target = int(data_length / desired_time_interval)
    target = (np.arange(n_target + 1) * desired_time_interval + shifting_time)
    tier = tg.tiers[1]
    phonemes = []
    counter = {}
    idx = 0
    for k, interval in enumerate(tier.intervals):
        mark = interval.mark
        if mark in ("", "-", "'"):
            if k == len(tier.intervals) - 1 and len(phonemes) != n_target:
                prev = tier.intervals[-2].mark
                prev = prev[:-1] if prev and prev[-1].isdigit() else prev
                phonemes.append(prev)
            continue
        if interval.maxTime < shifting_time:
            continue
        mark = mark[:-1] if mark[-1].isdigit() else mark
        counter[mark] = counter.get(mark, 0) + 1
        while (idx < n_target and target[idx] >= interval.minTime
               and target[idx] <= interval.maxTime):
            phonemes.append(mark)
            idx += 1
        if len(phonemes) == n_target:
            break
    if len(phonemes) != n_target:
        return None, counter
    return phonemes, counter


def textgrid_path(phonemes_root: str, wav_filename: str) -> str:
    """``{phonemes_root}/{speaker}/{utterance}.TextGrid`` for a wav."""
    key = utterance_key(wav_filename)
    return os.path.join(phonemes_root, key.split("_")[0], key + ".TextGrid")


def utterance_key(wav_filename: str) -> str:
    return os.path.basename(wav_filename).rsplit(".", 1)[0]


def compute_groundtruth_alignments(store, split: str, configuration: dict,
                                   results_path: str, phonemes_root: str):
    """TextGrid tier resampling for every utterance of the split ->
    ``vctk_{split}_groundtruth_alignments.pickle``."""
    meta = store.metadata(split)
    wav_filenames = meta.get("wav_filenames", [])
    shifting_times = meta.get("shifting_times", [0.0] * len(wav_filenames))
    data_length = configuration["length"] / configuration["sampling_rate"]

    extended, possible, counter = [], set(), {}
    total = 0
    for wav, shift in zip(wav_filenames, shifting_times):
        tg_path = textgrid_path(phonemes_root, wav)
        if not os.path.isfile(tg_path):
            continue
        tg = read_textgrid(tg_path)
        if len(tg.tiers) < 2:
            continue
        phonemes, cnt = resample_phoneme_tier(tg, data_length, float(shift))
        for mark, c in cnt.items():
            possible.add(mark)
            counter[mark] = counter.get(mark, 0) + c
            total += c
        if phonemes is not None:
            extended.append((utterance_key(wav), phonemes))

    os.makedirs(results_path, exist_ok=True)
    out = os.path.join(results_path,
                       f"vctk_{split}_groundtruth_alignments.pickle")
    with open(out, "wb") as f:
        pickle.dump({
            "desired_time_interval": DESIRED_GT_INTERVAL,
            "extended_alignment_dataset": extended,
            "possible_phonemes": list(possible),
            "phonemes_counter": counter,
            "total_phonemes_apparations": total,
        }, f)
    ConsoleLogger.success(f"{len(extended)} groundtruth alignments -> {out}")
    return out


# -------------------- empirical --------------------


def normalized_features(split_data, configuration: dict) -> np.ndarray:
    """The split's input features as f32, normalized as the JAX evaluator
    normalizes them (in float64 against the normalizer, then cast)."""
    feats = np.asarray(split_data["input_features"], np.float32)
    if configuration.get("normalize"):
        norm = load_normalizer(configuration["normalizer_path"])
        feats = ((feats - norm["train_mean"]) / norm["train_std"]).astype(
            np.float32)
    return feats


@torch.inference_mode()
def encode_codes(model, x: torch.Tensor, per_frame: bool = False):
    """(B, T, C) features -> (B, T') int32 codes, through ``ops.vq_search``.

    ``per_frame=False`` is the reference's pairing: the quantizer's
    (C, T, B)-order flat index stream viewed back as (B, T')
    (reference alignment_stats.py:302), so frame (b, t) gets the code of a
    scrambled row at B > 1. ``per_frame=True`` searches each true frame's
    pre-VQ latent, the rows ``z.reshape(-1, D)`` of z in (B, T', D), against
    the trained codebook (the JAX package computes this search in plain
    jnp; here it runs through the same kernel)."""
    B = x.shape[0]
    if per_frame:
        z = model.latents(x).transpose(1, 2)          # (B, T', D)
        codebook = model.vq.codebook
        flat = z.reshape(-1, codebook.shape[1])
        return vq_search(flat, codebook).indices.view(B, -1)
    return model.encode(x).indices.view(B, -1)


def compute_empirical_alignments(model, store, split: str,
                                 configuration: dict, results_path: str,
                                 experiment_name: str, batch_size: int = 32,
                                 per_frame: bool = False):
    """Batched encoder + VQ sweep of ``model`` (a ``ConvVQVAE`` in eval mode,
    on its device) -> per-utterance code sequences ->
    ``{name}_vctk_{split}_empirical_alignments[_per_frame].pickle``.

    The batches are the JAX package's (``batch_size`` utterances, the last
    one short), since the default pairing mixes the items of a batch; see
    ``encode_codes``."""
    data = store.open(split)
    meta = store.metadata(split)
    wav_filenames = meta.get("wav_filenames", [])
    feats = normalized_features(data, configuration)
    device = next(model.parameters()).device

    all_alignments = []
    encodings_counter = {}
    total = 0
    for start in range(0, feats.shape[0], batch_size):
        chunk = feats[start:start + batch_size]
        idx = encode_codes(model, torch.from_numpy(chunk).to(device),
                           per_frame).cpu().numpy()
        for i in range(chunk.shape[0]):
            gi = start + i
            key = (utterance_key(wav_filenames[gi])
                   if gi < len(wav_filenames) else str(gi))
            seq = idx[i]
            all_alignments.append((key, seq))
            total += len(seq)
            for v in seq:
                s = str(v)
                encodings_counter[s] = encodings_counter.get(s, 0) + 1

    os.makedirs(results_path, exist_ok=True)
    suffix = "_per_frame" if per_frame else ""
    out = os.path.join(
        results_path,
        f"{experiment_name}_vctk_{split}_empirical_alignments{suffix}.pickle")
    with open(out, "wb") as f:
        pickle.dump({
            "all_alignments": all_alignments,
            "encodings_counter": encodings_counter,
            "desired_time_interval": DESIRED_EMP_INTERVAL,
            "total_indices_apparations": total,
            "num_embeddings": configuration["num_embeddings"],
        }, f)
    ConsoleLogger.success(f"{len(all_alignments)} empirical alignments -> {out}")
    return out


# -------------------- bigrams / frequencies --------------------


def _row_l1_normalize(m):
    s = np.abs(m).sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    return m / s


def compute_groundtruth_bigrams_matrix(results_path: str, split: str,
                                       wo_diag: bool = True, plot: bool = True):
    path = os.path.join(results_path,
                        f"vctk_{split}_groundtruth_alignments.pickle")
    with open(path, "rb") as f:
        dic = pickle.load(f)
    phonemes = sorted(dic["possible_phonemes"])
    pidx = {p: i for i, p in enumerate(phonemes)}
    P = len(phonemes)
    bigrams = np.zeros((P, P), dtype=int)
    prev_counter = np.zeros(P, dtype=int)
    for _, alignment in dic["extended_alignment_dataset"]:
        prev = alignment[0]
        for cur in alignment:
            bigrams[pidx[cur]][pidx[prev]] += 1
            prev_counter[pidx[prev]] += 1
            prev = cur
    if wo_diag:
        np.fill_diagonal(bigrams, 0)
    prev_counter[prev_counter == 0] = 1
    mat = _row_l1_normalize(bigrams / prev_counter)
    out = os.path.join(
        results_path,
        "vctk_{}_groundtruth_bigrams_{}{}ms".format(
            split, "wo_diag_" if wo_diag else "",
            int(dic["desired_time_interval"] * 1000)))
    np.save(out + ".npy", mat)
    if plot:
        _plot_matrix(mat, phonemes, out + ".png")
    return mat


def compute_empirical_bigrams_matrix(results_path: str, experiment_name: str,
                                     split: str, wo_diag: bool = True,
                                     plot: bool = True):
    path = os.path.join(
        results_path,
        f"{experiment_name}_vctk_{split}_empirical_alignments.pickle")
    with open(path, "rb") as f:
        dic = pickle.load(f)
    K = dic["num_embeddings"]
    if K > 100:
        ConsoleLogger.warn(
            f"Skipping empirical bigrams: embedding number ({K}) is huge")
        return None
    bigrams = np.zeros((K, K), dtype=int)
    prev_counter = np.zeros(K, dtype=int)
    for _, alignment in dic["all_alignments"]:
        prev = alignment[0]
        for cur in alignment:
            bigrams[cur][prev] += 1
            prev_counter[prev] += 1
            prev = cur
    if wo_diag:
        np.fill_diagonal(bigrams, 0)
    prev_counter[prev_counter == 0] = 1
    mat = _row_l1_normalize(bigrams / prev_counter)
    out = os.path.join(
        results_path,
        "{}_vctk_{}_empirical_bigrams_{}{}ms".format(
            experiment_name, split, "wo_diag_" if wo_diag else "",
            int(dic["desired_time_interval"] * 1000)))
    np.save(out + ".npy", mat)
    if plot:
        _plot_matrix(mat, list(range(K)), out + ".png")
    return mat


def compute_empirical_encodings_frequency(results_path: str,
                                          experiment_name: str, split: str,
                                          plot: bool = True):
    """Percent of frames a code takes, by code (the JAX package always
    draws the bar plot; here ``plot=False`` leaves it out)."""
    path = os.path.join(
        results_path,
        f"{experiment_name}_vctk_{split}_empirical_alignments.pickle")
    with open(path, "rb") as f:
        dic = pickle.load(f)
    total = dic["total_indices_apparations"]
    freq = {k: v * 100 / total for k, v in dic["encodings_counter"].items()}
    if not plot:
        return freq
    keys = sorted(freq, key=freq.get, reverse=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(20, 2))
    ax.bar(keys, [freq[k] for k in keys])
    out = os.path.join(
        results_path,
        "{}_vctk_{}_empirical_frequency_{}ms.png".format(
            experiment_name, split, int(dic["desired_time_interval"] * 1000)))
    fig.savefig(out, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return freq


def _plot_matrix(mat, labels, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = mat.shape[0]
    fig, ax = plt.subplots(figsize=(min(20, 2 + n // 2),) * 2)
    im = ax.matshow(np.around(mat, 2))
    ax.set_xticks(np.arange(n))
    ax.set_yticks(np.arange(n))
    ax.set_xticklabels(labels, rotation=90, fontsize=6)
    ax.set_yticklabels(labels, fontsize=6)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


# -------------------- clustering metrics --------------------


_METRICS = ("adjusted_rand_score", "adjusted_mutual_info_score",
            "normalized_mutual_info_score")


def compute_clustering_metrics(results_path: str, experiment_name: str,
                               split: str, configuration: dict,
                               per_frame: bool = False):
    """ARI/AMI/NMI between concatenated groundtruth and empirical alignments,
    saved as ``{name}_{metric}.npy`` (reference lines 418-497).

    ``per_frame=True`` scores the per-frame empirical alignments (see
    ``encode_codes``) and saves ``{name}_per_frame_{metric}.npy``."""
    suffix = "_per_frame" if per_frame else ""
    with open(os.path.join(
            results_path,
            f"vctk_{split}_groundtruth_alignments.pickle"), "rb") as f:
        gt_dic = pickle.load(f)
    with open(os.path.join(
            results_path,
            f"{experiment_name}_vctk_{split}_empirical_alignments"
            f"{suffix}.pickle"), "rb") as f:
        emp_dic = pickle.load(f)

    possible = list(gt_dic["possible_phonemes"])
    pidx = {p: i for i, p in enumerate(possible)}
    # one gt frame (20 ms) per latent frame (2x downsampled 10 ms features)
    alignment_length = ((configuration["length"]
                         / configuration["sampling_rate"]) * 100) / 2

    gt_keys = set()
    final_gt, final_emp = [], []
    for key, alignment in gt_dic["extended_alignment_dataset"]:
        if len(alignment) != alignment_length:
            continue
        gt_keys.add(key)
        final_gt.append([pidx[a] for a in alignment])
    for key, alignment in emp_dic["all_alignments"]:
        if key in gt_keys:
            final_emp.append(alignment)

    n = min(len(final_gt), len(final_emp))
    if n == 0:
        ConsoleLogger.warn("No overlapping groundtruth/empirical alignments; "
                           "clustering metrics undefined (scores = 0)")
        scores = {m: 0.0 for m in _METRICS}
    else:
        scores = clustering_scores(np.concatenate(np.asarray(final_gt[:n])),
                                   np.concatenate(np.asarray(final_emp[:n])))
    for metric, value in scores.items():
        np.save(os.path.join(results_path,
                             f"{experiment_name}{suffix}_{metric}.npy"),
                value)
        if n:
            ConsoleLogger.success(
                f"{'per-frame ' if per_frame else ''}{metric}: {value}")
    return scores


def compute_clustering_metrics_evolution(all_experiments_names, result_path):
    """Read each experiment's metric .npy and plot metric-vs-experiment
    (reference lines 499-565, e.g. the codebook-size sweep)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    for metric in _METRICS:
        values = []
        for name in all_experiments_names:
            path = os.path.join(result_path, f"{name}_{metric}.npy")
            values.append(float(np.load(path)) if os.path.isfile(path)
                          else np.nan)
        ax.plot(all_experiments_names, values, marker="o", label=metric)
    ax.set_xlabel("experiment")
    ax.set_ylabel("score")
    ax.legend()
    out = os.path.join(result_path, "clustering_metrics_evolution.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def check_clustering_metrics_stability_over_seeds(all_experiments_names,
                                                  result_path):
    """Group ``{base}-seed{seed}`` runs and plot per-base score spread
    (reference lines 567-673)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = {}
    for name in all_experiments_names:
        base = name.split("-seed")[0]
        groups.setdefault(base, []).append(name)

    fig, axs = plt.subplots(len(_METRICS), 1, figsize=(10, 12), sharex=True)
    for ax, metric in zip(axs, _METRICS):
        for base, names in groups.items():
            values = []
            for name in names:
                path = os.path.join(result_path, f"{name}_{metric}.npy")
                if os.path.isfile(path):
                    values.append(float(np.load(path)))
            ax.plot(range(len(values)), values, marker="o", label=base)
        ax.set_title(metric)
        ax.legend()
    out = os.path.join(result_path, "clustering_metrics_stability.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def compute_groundtruth_average_phonemes_number(results_path: str, split: str):
    with open(os.path.join(
            results_path,
            f"vctk_{split}_groundtruth_alignments.pickle"), "rb") as f:
        dic = pickle.load(f)
    counts = [len(np.unique(a)) for _, a in dic["extended_alignment_dataset"]]
    avg = float(np.mean(counts)) if counts else 0.0
    ConsoleLogger.success(
        f"Average number of phonemes per alignment over "
        f"{len(counts)} alignments: {avg:.2f}")
    return avg
