from vqvae_speech_tpu_torch.models.wavenet.incremental import (
    cast_floating,
    hoist_conditioning,
    init_buffers,
    prepare_decode_weights,
    step_layer,
    wavenet_incremental_generate,
)
from vqvae_speech_tpu_torch.models.wavenet.mixture import (
    discretized_mix_logistic_loss,
    sample_from_discretized_mix_logistic,
)
from vqvae_speech_tpu_torch.models.wavenet.model import (
    ResidualConv1dGLU,
    UpsampleStage,
    WaveNet,
    WaveNetConfig,
    receptive_field_size,
)
from vqvae_speech_tpu_torch.models.wavenet.util import (
    build_wavenet_from_hparams,
    is_mulaw,
    is_mulaw_quantize,
    is_raw,
    is_scalar_input,
)

__all__ = ["WaveNet", "WaveNetConfig", "ResidualConv1dGLU", "UpsampleStage",
           "receptive_field_size", "cast_floating", "hoist_conditioning",
           "init_buffers", "prepare_decode_weights", "step_layer",
           "wavenet_incremental_generate", "discretized_mix_logistic_loss",
           "sample_from_discretized_mix_logistic", "build_wavenet_from_hparams",
           "is_mulaw", "is_mulaw_quantize", "is_raw", "is_scalar_input"]
