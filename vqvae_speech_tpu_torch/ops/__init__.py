from vqvae_speech_tpu_torch.ops.dsp import (
    delta,
    fbank,
    logfbank,
    mfcc,
    num_frames,
    speech_features,
)
from vqvae_speech_tpu_torch.ops.vq import (
    VQSearchResult,
    reference_flatten,
    reference_unflatten,
    vq_distances,
    vq_search,
    vq_search_torch,
)

__all__ = [
    "delta", "fbank", "logfbank", "mfcc", "num_frames", "speech_features",
    "VQSearchResult", "reference_flatten", "reference_unflatten",
    "vq_distances", "vq_search", "vq_search_torch",
]
