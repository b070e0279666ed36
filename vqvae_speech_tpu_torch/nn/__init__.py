from vqvae_speech_tpu_torch.nn.conv import Conv1d, ConvTranspose1d, conv_weight
from vqvae_speech_tpu_torch.nn.layers import (
    Residual,
    ResidualStack,
    jitter,
    jitter_masks,
    upsample_nearest,
)

__all__ = ["Conv1d", "ConvTranspose1d", "conv_weight", "Residual",
           "ResidualStack", "jitter", "jitter_masks", "upsample_nearest"]
