"""Feature export: VCTK corpus -> columnar FeatureStore.

Counterpart of ``vqvae_speech_tpu/data/export.py`` (reference
src/dataset/vctk_speech_stream.py:91-240), with the same store, metadata and
rules:

* host-parallel ingest: a thread pool reads, trims and crops each wav, the
  random crop drawn from a per-file rng keyed by (seed, index), so the crops
  do not depend on thread scheduling,
* ONE batched feature computation per chunk (MFCC+deltas through
  ``ops.speech_features`` on ``device``),
* a per-split columnar store + metadata sidecar,
* per-utterance fault tolerance (a failed file is logged and skipped),
  and utterances whose features have another shape than
  (input_features_dim, 3 * input_features_filters) are not saved,
* resume: an existing split file is kept unless ``overwrite=True``.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vqvae_speech_tpu_torch.data.feature_store import FeatureStore
from vqvae_speech_tpu_torch.data.vctk import preprocess_utterance
from vqvae_speech_tpu_torch.ops import num_frames, speech_features
from vqvae_speech_tpu_torch.utils import resolve_device
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger


def _features(name, waves: torch.Tensor, rate, filters, augmented):
    return speech_features(name, waves, rate, filters, augmented).cpu().numpy()


@torch.inference_mode()
def export_split_to_features(files, speaker_dic, store: FeatureStore,
                             split: str, configuration: dict,
                             overwrite: bool = False, chunk_size: int = 256,
                             num_workers: int = 8, seed: int = 0, *, device):
    """``files`` -> the ``split`` of ``store``; the features are computed on
    ``device`` ("cuda", or "cpu" when the caller asks for it)."""
    device = resolve_device(device)
    cfg = configuration
    if store.exists(split) and not overwrite:
        ConsoleLogger.status(
            f"Features for split '{split}' already exported; skipping")
        return store

    rate = cfg["sampling_rate"]
    length = cfg["length"]
    in_name, out_name = cfg["input_features_type"], cfg["output_features_type"]
    in_filters = cfg["input_features_filters"]
    out_filters = cfg["output_features_filters"]
    frames = num_frames(length, round(0.025 * rate), round(0.01 * rate))
    in_dim = in_filters * 3  # input features are always delta-augmented
    target_shape = (cfg["input_features_dim"], in_dim)

    def load_one(job):
        index, path = job
        try:
            rng = np.random.default_rng((seed, index))
            return preprocess_utterance(
                path, speaker_dic, rate, cfg["top_db"], length,
                cfg["quantize"], rng)
        except Exception as e:  # per-file fault tolerance
            ConsoleLogger.warn(f"skipping '{path}': {e}")
            return None

    all_inputs, all_outputs, all_speakers, all_audio = [], [], [], []
    meta = {"wav_filenames": [], "shifting_times": [],
            "random_starting_indices": [], "top_db": cfg["top_db"],
            "sampling_rate": rate, "length": length}

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, len(files), chunk_size):
            chunk_files = list(enumerate(files[start:start + chunk_size],
                                         start=start))
            items = [it for it in pool.map(load_one, chunk_files)
                     if it is not None]
            if not items:
                continue
            # the reference featurizes the full preprocessed_audio (length+1
            # samples, vctk_speech_stream.py:145-150) -> 47 frames @ 7680
            waves = np.stack([it["preprocessed_audio"] for it in items])
            on_device = torch.from_numpy(waves).to(device)
            inp = _features(in_name, on_device, rate, in_filters, True)
            outp = _features(out_name, on_device, rate, out_filters,
                             cfg["augment_output_features"])
            keep = [i for i in range(len(items))
                    if inp[i].shape == target_shape]
            for i in range(len(items)):
                if i not in keep:
                    ConsoleLogger.warn(
                        f"features with invalid dimension {inp[i].shape} "
                        f"will not be saved (target {target_shape})")
            all_inputs.append(inp[keep])
            all_outputs.append(outp[keep])
            all_audio.append(waves[keep])
            all_speakers.extend(int(items[i]["speaker_id"]) for i in keep)
            for i in keep:
                meta["wav_filenames"].append(items[i]["wav_filename"])
                meta["shifting_times"].append(float(items[i]["shifting_time"]))
                meta["random_starting_indices"].append(
                    int(items[i]["random_starting_index"]))
            ConsoleLogger.status(
                f"[{split}] exported {start + len(chunk_files)}/{len(files)}")

    store.write(split,
                np.concatenate(all_inputs) if all_inputs else
                np.zeros((0, frames, in_dim), np.float32),
                np.concatenate(all_outputs) if all_outputs else
                np.zeros((0, frames, out_filters * 3), np.float32),
                np.asarray(all_speakers, np.int32), metadata=meta,
                preprocessed_audio=(
                    np.concatenate(all_audio).astype(np.float32) if all_audio
                    else np.zeros((0, length + 1), np.float32)))
    return store


def export_to_features(vctk, features_root: str, configuration: dict,
                       overwrite: bool = False, num_workers: int = 8, *,
                       device):
    """Both splits -> FeatureStore (reference vctk_speech_stream.py:91-240)."""
    store = FeatureStore(features_root)
    export_split_to_features(vctk.audios_train, vctk.speaker_dic, store,
                             "train", configuration, overwrite,
                             num_workers=num_workers, device=device)
    export_split_to_features(vctk.audios_val, vctk.speaker_dic, store,
                             "val", configuration, overwrite,
                             num_workers=num_workers, device=device)
    ConsoleLogger.success(f"VCTK exported to feature store at: '{features_root}'")
    return store
