from vqvae_speech_tpu_torch.models.clarinet.wavenet import (
    GaussianWaveNetConfig,
    gaussian_wavenet_core,
    gaussian_wavenet_core_fused,
    gaussian_wavenet_upsample,
)
from vqvae_speech_tpu_torch.models.clarinet.wavenet_iaf import (
    StudentConfig,
    wavenet_student_apply,
    wavenet_student_generate,
)

__all__ = ["GaussianWaveNetConfig", "gaussian_wavenet_core",
           "gaussian_wavenet_core_fused", "gaussian_wavenet_upsample",
           "StudentConfig", "wavenet_student_apply",
           "wavenet_student_generate"]
