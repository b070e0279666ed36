from vqvae_speech_tpu_torch.data.audio import (
    load_and_preprocess,
    load_wav,
    trim_silence,
)

__all__ = ["load_and_preprocess", "load_wav", "trim_silence"]
