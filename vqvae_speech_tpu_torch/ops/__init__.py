from vqvae_speech_tpu_torch.ops.dsp import (
    delta,
    fbank,
    logfbank,
    mfcc,
    num_frames,
    speech_features,
)
from vqvae_speech_tpu_torch.ops.fused_resblock import (
    fused_block_chain,
    fused_block_chain_nc,
    fused_block_chain_nc_torch,
    fused_block_chain_tiled,
    fused_block_chain_tiled_torch,
    fused_block_chain_torch,
    stack_block_weights,
)
from vqvae_speech_tpu_torch.ops.mel import melspectrogram, normalized_log_mel
from vqvae_speech_tpu_torch.ops.mu_law import mu_law_decode, mu_law_encode
from vqvae_speech_tpu_torch.ops.vq import (
    VQSearchResult,
    reference_flatten,
    reference_unflatten,
    vq_distances,
    vq_search,
    vq_search_torch,
)
from vqvae_speech_tpu_torch.ops.wavenet_step import (
    glu_stack_step,
    glu_stack_step_torch,
    prepare_glu_stack_step,
)

__all__ = [
    "delta", "fbank", "logfbank", "mfcc", "num_frames", "speech_features",
    "mu_law_decode", "mu_law_encode", "glu_stack_step", "glu_stack_step_torch",
    "prepare_glu_stack_step",
    "VQSearchResult", "reference_flatten", "reference_unflatten",
    "vq_distances", "vq_search", "vq_search_torch",
    "fused_block_chain", "fused_block_chain_nc", "fused_block_chain_nc_torch",
    "fused_block_chain_tiled", "fused_block_chain_tiled_torch",
    "fused_block_chain_torch", "stack_block_weights", "melspectrogram",
    "normalized_log_mel",
]
