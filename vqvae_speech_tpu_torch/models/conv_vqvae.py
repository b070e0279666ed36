"""ConvolutionalVQVAE: encoder -> pre-VQ conv -> VQ(-EMA) -> deconv decoder.

Counterpart of ``vqvae_speech_tpu/models/conv_vqvae.py`` (reference
src/models/convolutional_vq_vae.py). ``encode`` is ``conv_vqvae_encode`` and
``forward`` is ``conv_vqvae_apply`` without training-time jitter; both take
(B, T, C_in) features and return latents in (B, T', D).
"""
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from vqvae_speech_tpu_torch.models.decoder import DeconvolutionalDecoder
from vqvae_speech_tpu_torch.models.encoder import ConvolutionalEncoder
from vqvae_speech_tpu_torch.models.vq import VectorQuantizer, VQOutput
from vqvae_speech_tpu_torch.nn import Conv1d


class ConvVQVAEOutput(NamedTuple):
    reconstructed_x: torch.Tensor  # (B, T, C_out) trimmed to input length
    vq_loss: torch.Tensor
    losses: dict
    perplexity: torch.Tensor
    encoding_indices: torch.Tensor  # (N, 1) reference-layout flat indices
    quantized: torch.Tensor         # (B, T', D) straight-through latents
    encodings: torch.Tensor         # (B, T', K)
    distances: torch.Tensor         # (B, T', K)
    new_state: dict                 # {"vq": EMA state or {}}
    pre_vq_latents: torch.Tensor    # (B, T', D), detached


def feature_channels(config: dict, prefix: str) -> int:
    """Feature width: filters, x3 when delta and delta-delta are appended."""
    n = config[f"{prefix}_features_filters"]
    return n * 3 if config[f"augment_{prefix}_features"] else n


class ConvVQVAE(nn.Module):
    def __init__(self, config: dict,
                 generator: Optional[torch.Generator] = None):
        """Sized from a configuration dict (the keys of the reference YAML,
        configurations/vctk_features.yaml), as ``conv_vqvae_init`` sizes it."""
        super().__init__()
        self.config = dict(config)
        wn = config["use_kaiming_normal"]
        hid = config["num_hiddens"]
        n_res = config["num_residual_layers"]
        D = config["embedding_dim"]
        self.encoder = ConvolutionalEncoder(
            feature_channels(config, "input"), hid, n_res, hid, wn, generator)
        self.pre_vq_conv = Conv1d(hid, D, 3, padding=1, generator=generator)
        self.vq = VectorQuantizer(config["num_embeddings"], D,
                                  config["commitment_cost"], config["decay"],
                                  generator=generator)
        self.decoder = DeconvolutionalDecoder(
            D, feature_channels(config, "output"), hid, n_res,
            config["residual_channels"], wn,
            config["use_speaker_conditioning"], config["use_jitter"],
            generator)

    @classmethod
    def from_config(cls, config: dict,
                    generator: Optional[torch.Generator] = None) -> "ConvVQVAE":
        return cls(config, generator)

    def latents(self, x_btc: torch.Tensor) -> torch.Tensor:
        """Encoder + pre-VQ conv: (B, T, C_in) -> (B, D, T') pre-VQ latents."""
        return self.pre_vq_conv(self.encoder(x_btc.transpose(1, 2)))

    def encode(self, x_btc: torch.Tensor) -> VQOutput:
        """Encoder + pre-VQ + VQ (``conv_vqvae_encode``)."""
        return self.vq(self.latents(x_btc))

    def forward(self, x_btc: torch.Tensor) -> ConvVQVAEOutput:
        """Full forward (``conv_vqvae_apply``); the output is trimmed back to
        the input frame count (reference convolutional_vq_vae.py:133-137)."""
        z = self.latents(x_btc)
        vq_out = self.vq(z)
        recon = self.decoder(vq_out.quantized.transpose(1, 2))
        recon = recon[:, :, :x_btc.shape[1]].transpose(1, 2)
        return ConvVQVAEOutput(
            reconstructed_x=recon,
            vq_loss=vq_out.vq_loss,
            losses=vq_out.losses,
            perplexity=vq_out.perplexity,
            encoding_indices=vq_out.indices,
            quantized=vq_out.quantized,
            encodings=vq_out.encodings,
            distances=vq_out.distances,
            new_state={"vq": vq_out.new_state or {}},
            pre_vq_latents=z.detach().transpose(1, 2),
        )
