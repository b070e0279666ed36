from vqvae_speech_tpu_torch.data.audio import (
    load_and_preprocess,
    load_wav,
    pad_or_random_crop,
    trim_silence,
)
from vqvae_speech_tpu_torch.data.feature_store import (
    FeatureLoader,
    FeatureStore,
    compute_dataset_stats,
    load_normalizer,
)

__all__ = ["load_and_preprocess", "load_wav", "pad_or_random_crop",
           "trim_silence", "FeatureLoader", "FeatureStore",
           "compute_dataset_stats", "load_normalizer"]
