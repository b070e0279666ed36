"""Synthetic speech-like dataset for tests and smoke training.

Counterpart of ``vqvae_speech_tpu/data/synthetic.py``: harmonic-plus-noise
waveforms with a per-"speaker" base pitch (numpy, so the same seed gives the
same waves in both packages), run through the batched feature pipeline
(``ops.speech_features`` on ``device``) and written as a FeatureStore, so that
everything downstream of ingest is exercised for real.
"""
import numpy as np
import torch

from vqvae_speech_tpu_torch.data.feature_store import FeatureStore
from vqvae_speech_tpu_torch.ops import speech_features
from vqvae_speech_tpu_torch.utils import resolve_device


def synth_waveforms(num: int, length: int = 7680, rate: int = 16000,
                    num_speakers: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / rate
    waves = np.empty((num, length), np.float32)
    speakers = rng.integers(0, num_speakers, num).astype(np.int32)
    for i in range(num):
        f0 = 90.0 + 40.0 * speakers[i] + rng.uniform(-10, 10)
        sig = np.zeros(length)
        for h in range(1, 6):
            sig += rng.uniform(0.1, 0.5) / h * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
        sig += 0.02 * rng.standard_normal(length)
        waves[i] = (sig / np.max(np.abs(sig))).astype(np.float32)
    return waves, speakers


@torch.inference_mode()
def build_synthetic_store(root: str, num_train: int = 16, num_val: int = 4,
                          length: int = 7680, rate: int = 16000,
                          features_type: str = "mfcc", filters: int = 13,
                          seed: int = 0, *, device) -> FeatureStore:
    """Train and val splits of synthetic utterances under ``root``; the
    features are computed on ``device`` ("cuda", or "cpu" when asked for)."""
    device = resolve_device(device)
    store = FeatureStore(root)
    for split, num, s in [("train", num_train, seed), ("val", num_val, seed + 1)]:
        waves, speakers = synth_waveforms(num, length, rate, seed=s)
        feats = speech_features(features_type,
                                torch.from_numpy(waves).to(device), rate,
                                filters, True).cpu().numpy()
        names = [f"synth/p{speakers[i]:03d}/p{speakers[i]:03d}_{i:03d}.wav"
                 for i in range(num)]
        store.write(split, feats, feats, speakers,
                    metadata={"synthetic": True, "length": length,
                              "rate": rate, "wav_filenames": names,
                              "shifting_times": [0.0] * num,
                              "random_starting_indices": [0] * num},
                    preprocessed_audio=waves)
    return store
