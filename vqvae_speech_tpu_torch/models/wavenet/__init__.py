from vqvae_speech_tpu_torch.models.wavenet.incremental import (
    hoist_conditioning,
    init_buffers,
    prepare_decode_weights,
    step_layer,
    wavenet_incremental_generate,
)
from vqvae_speech_tpu_torch.models.wavenet.model import (
    ResidualConv1dGLU,
    UpsampleStage,
    WaveNet,
    WaveNetConfig,
    receptive_field_size,
)

__all__ = ["WaveNet", "WaveNetConfig", "ResidualConv1dGLU", "UpsampleStage",
           "receptive_field_size", "hoist_conditioning", "init_buffers",
           "prepare_decode_weights", "step_layer",
           "wavenet_incremental_generate"]
