"""Columnar feature store — the replacement for 44k pickles.

A copy of ``vqvae_speech_tpu/data/feature_store.py`` (numpy only; the port
imports nothing of the JAX package): the same files, the same normalizer
pickle and, for one seed, the same batches (tests/test_torch_data.py).

The reference exports one pickle per utterance
(reference src/dataset/vctk_speech_stream.py:166-184) and re-reads them with
DataLoader worker processes every epoch
(reference src/dataset/vctk_features_dataset.py:43-64).  Here each split is a
single memory-mapped ``.npz`` of dense arrays — one sequential read, zero
unpickling, batches sliced directly into pinned host buffers and shipped to
device in one transfer.

Store schema per split (``{split}.npz``):
  input_features  (N, T, C_in)  float32
  output_features (N, T, C_out) float32
  speaker_ids     (N,)          int32
plus a ``{split}.meta.json`` sidecar (wav filenames, config echo).

`compute_dataset_stats` matches the reference normalizer contract
(``{'train_mean','train_std'}`` per-dimension over all train frames,
reference src/dataset/vctk_features_stream.py:114-173) but runs as one
streamed reduction instead of materializing every MFCC in a python list.
"""
import json
import os
import pickle

import numpy as np


class _ColumnView(dict):
    """dict of mmap'd arrays with an npz-compatible ``.files`` attribute."""

    @property
    def files(self):
        return list(self.keys())


class FeatureStore:
    """Read/write access to the columnar per-split feature arrays."""

    def __init__(self, root: str):
        self.root = root

    def _npz_path(self, split: str) -> str:
        return os.path.join(self.root, f"{split}.npz")

    def exists(self, split: str) -> bool:
        return os.path.isfile(self._npz_path(split))

    def _column_path(self, split: str, column: str) -> str:
        return os.path.join(self.root, f"{split}.{column}.npy")

    def write(self, split: str, input_features, output_features, speaker_ids,
              metadata: dict = None, **extra_arrays):
        os.makedirs(self.root, exist_ok=True)
        columns = {
            "input_features": np.asarray(input_features, np.float32),
            "output_features": np.asarray(output_features, np.float32),
            "speaker_ids": np.asarray(speaker_ids, np.int32),
            **{k: np.asarray(v) for k, v in extra_arrays.items()},
        }
        # one .npy per column: np.load(mmap_mode='r') gives TRUE memory
        # mapping (npz is a zip archive — numpy silently ignores mmap_mode
        # and re-reads the whole entry on every access)
        for name, arr in columns.items():
            np.save(self._column_path(split, name), arr, allow_pickle=False)
        with open(self._npz_path(split), "w") as f:
            json.dump({"columns": sorted(columns)}, f)
        if metadata is not None:
            with open(os.path.join(self.root, f"{split}.meta.json"), "w") as f:
                json.dump(metadata, f)

    def open(self, split: str):
        """mmap-backed dict-like of column arrays."""
        with open(self._npz_path(split)) as f:
            manifest = json.load(f)
        return _ColumnView({
            name: np.load(self._column_path(split, name), mmap_mode="r")
            for name in manifest["columns"]})

    def metadata(self, split: str) -> dict:
        path = os.path.join(self.root, f"{split}.meta.json")
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def num_examples(self, split: str) -> int:
        return int(self.open(split)["speaker_ids"].shape[0])


def compute_dataset_stats(store: FeatureStore, normalizer_path: str,
                          split: str = "train") -> dict:
    """Per-dimension mean/std over all train frames -> normalizer pickle.

    Contract-compatible with the reference's normalizer file
    ({'train_mean','train_std'} over axis 0 of the stacked (N*T, C) frames).
    """
    data = store.open(split)
    feats = np.asarray(data["input_features"], np.float64)
    flat = feats.reshape(-1, feats.shape[-1])
    stats = {
        "train_mean": flat.mean(axis=0),
        "train_std": flat.std(axis=0),
    }
    os.makedirs(os.path.dirname(normalizer_path) or ".", exist_ok=True)
    with open(normalizer_path, "wb") as f:
        pickle.dump(stats, f)
    return stats


def load_normalizer(normalizer_path: str) -> dict:
    with open(normalizer_path, "rb") as f:
        return pickle.load(f)


class FeatureLoader:
    """Shuffled batch iterator over a split, optional train-stats normalization.

    Yields dict batches of numpy arrays (``data.prefetch_to_device`` puts
    them on the device):
      input_features (B, T, C_in), output_features (B, T, C_out),
      speaker_id (B,), index (B,).

    Training uses ``drop_last=True`` so every step has the same shape (the
    JAX package compiles one step); validation uses batch_size=1 like the reference
    (reference src/dataset/vctk_features_stream.py:62-69).
    """

    def __init__(self, store: FeatureStore, split: str, batch_size: int,
                 normalizer: dict = None, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self._data = store.open(split)
        self._batch_size = batch_size
        self._normalizer = normalizer
        self._shuffle = shuffle
        self._drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._n = int(self._data["speaker_ids"].shape[0])

    @property
    def batch_size(self):
        return self._batch_size

    def __len__(self):
        if self._drop_last:
            return self._n // self._batch_size
        return (self._n + self._batch_size - 1) // self._batch_size

    def __iter__(self):
        order = np.arange(self._n)
        if self._shuffle:
            self._rng.shuffle(order)
        bs = self._batch_size
        stop = self._n - (self._n % bs) if self._drop_last else self._n
        for start in range(0, stop, bs):
            idx = np.sort(order[start:start + bs])  # sorted for mmap locality
            inp = np.asarray(self._data["input_features"][idx], np.float32)
            out = np.asarray(self._data["output_features"][idx], np.float32)
            if self._normalizer is not None:
                mean = self._normalizer["train_mean"].astype(np.float32)
                std = self._normalizer["train_std"].astype(np.float32)
                inp = (inp - mean) / std
                # the reference applies the SAME train stats to both streams
                # (vctk_features_dataset.py:56-58), which only type-checks
                # when both are 39-d MFCCs; its wavenet config dodges the
                # mismatch by never normalizing. Here output features keep
                # their raw scale when their width differs from the stats
                # (e.g. 79-d logfbank targets under the wavenet decoder,
                # where the training target is mu-law audio, not features).
                if out.shape[-1] == mean.shape[-1]:
                    out = (out - mean) / std
            batch = {
                "input_features": inp,
                "output_features": out,
                "speaker_id": np.asarray(self._data["speaker_ids"][idx], np.int32),
                "index": idx.astype(np.int32),
            }
            if "preprocessed_audio" in self._data.files:
                batch["preprocessed_audio"] = np.asarray(
                    self._data["preprocessed_audio"][idx], np.float32)
            yield batch
