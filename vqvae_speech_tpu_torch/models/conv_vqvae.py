"""ConvolutionalVQVAE: encoder -> pre-VQ conv -> VQ(-EMA) -> deconv decoder.

Counterpart of ``vqvae_speech_tpu/models/conv_vqvae.py`` (reference
src/models/convolutional_vq_vae.py). ``encode`` is ``conv_vqvae_encode`` and
``forward`` is ``conv_vqvae_apply``, training-time jitter and speaker
conditioning included; both take (B, T, C_in) features and return latents in
(B, T', D). With ``codebook_revival`` the module also holds the revival
extension's usage EMA (``revival_usage``, the JAX ``state["revival"]``).
"""
from typing import Optional

import torch
import torch.nn as nn

from vqvae_speech_tpu_torch.models.decoder import DeconvolutionalDecoder
from vqvae_speech_tpu_torch.models.encoder import ConvolutionalEncoder
from vqvae_speech_tpu_torch.models.vq import VectorQuantizer, VQOutput
from vqvae_speech_tpu_torch.nn import Conv1d


class ConvVQVAEOutput:
    """What one forward returns; the JAX package's field names. ``encodings``
    and ``distances`` (B, T', K) are the quantizer's, built when first read
    (``models.vq.VQOutput``)."""

    def __init__(self, reconstructed_x, vq_out: VQOutput, new_state,
                 pre_vq_latents):
        self.reconstructed_x = reconstructed_x   # (B, T, C_out), input length
        self.vq_loss = vq_out.vq_loss
        self.losses = vq_out.losses
        self.perplexity = vq_out.perplexity
        self.encoding_indices = vq_out.indices   # (N, 1) reference layout
        self.quantized = vq_out.quantized        # (B, T', D) straight-through
        self.counts = vq_out.counts              # (K,) rows per code
        self.new_state = new_state               # {"vq": ..., ["revival"]}
        self.pre_vq_latents = pre_vq_latents     # (B, T', D), detached
        self._vq_out = vq_out

    @property
    def encodings(self) -> torch.Tensor:
        return self._vq_out.encodings

    @property
    def distances(self) -> torch.Tensor:
        return self._vq_out.distances


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
            generator, num_speakers=config.get("num_speakers", 0),
            jitter_probability=config["jitter_probability"])
        if config.get("codebook_revival", False):
            K = config["num_embeddings"]
            self.register_buffer("revival_usage", torch.full((K,), 1.0 / K))
        else:
            self.revival_usage = None

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

    def forward(self, x_btc: torch.Tensor, speaker_ids=None, *,
                jitter_masks=None,
                jitter_generator: Optional[torch.Generator] = None
                ) -> ConvVQVAEOutput:
        """Full forward (``conv_vqvae_apply``); the output is trimmed back to
        the input frame count (reference convolutional_vq_vae.py:133-137).

        In training, a ``use_jitter`` model jitters the quantized latents with
        ``jitter_masks`` = (replace, direction) when given and with draws from
        ``jitter_generator`` otherwise; the config's
        ``jitter_gradient_detach`` (default True, PARITY #34) picks the
        replaced frames' gradient semantics."""
        z = self.latents(x_btc)
        vq_out = self.vq(z)
        recon = self.decoder(
            vq_out.quantized.transpose(1, 2), speaker_ids,
            jitter_masks=jitter_masks, jitter_generator=jitter_generator,
            jitter_detach=self.config.get("jitter_gradient_detach", True))
        recon = recon[:, :, :x_btc.shape[1]].transpose(1, 2)
        new_state = {"vq": vq_out.new_state or {}}
        if self.revival_usage is not None:
            new_state["revival"] = {"usage": self.revival_usage}
        return ConvVQVAEOutput(recon, vq_out, new_state,
                               z.detach().transpose(1, 2))
