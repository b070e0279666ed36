from vqvae_speech_tpu_torch.models.conv_vqvae import ConvVQVAE, ConvVQVAEOutput
from vqvae_speech_tpu_torch.models.decoder import DeconvolutionalDecoder
from vqvae_speech_tpu_torch.models.encoder import ConvolutionalEncoder
from vqvae_speech_tpu_torch.models.vq import VectorQuantizer, VQOutput
from vqvae_speech_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.models.wavenet_decoder import WaveNetDecoder
from vqvae_speech_tpu_torch.models.wavenet_vqvae import (
    WaveNetVQVAE,
    WaveNetVQVAEOutput,
)

__all__ = ["ConvVQVAE", "ConvVQVAEOutput", "DeconvolutionalDecoder",
           "ConvolutionalEncoder", "VectorQuantizer", "VQOutput", "WaveNet",
           "WaveNetConfig", "WaveNetDecoder", "WaveNetVQVAE",
           "WaveNetVQVAEOutput"]
