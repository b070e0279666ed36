"""WaveNetVQVAE: feature encoder -> k1 pre-VQ conv -> VQ -> WaveNet decoder.

Counterpart of ``vqvae_speech_tpu/models/wavenet_vqvae.py`` (reference
src/models/wavenet_vq_vae.py:36-127). The pre-VQ conv is kernel 1 with
padding 0 (the ConvVQVAE's is k3/p1), so ``ConvVQVAE.latents`` is not
reused. ``forward`` is ``wavenet_vqvae_apply``: the teacher-forced forward,
with the reference's (C, T, B) VQ flatten over the whole batch; in training
mode the quantizer updates its EMA state and the decoder jitters and drops
out (draws fed or from generators). ``decoder_compute_dtype=torch.bfloat16``
runs the decoder on a bf16 cast of its parameters, of the teacher-forcing
input and of the quantized latents (autograd through the cast, so the
gradients reach the f32 parameters as f32); the encoder and the VQ stay f32
and the logits come back f32. With ``codebook_revival`` the module holds the
revival extension's usage EMA (``revival_usage``, the JAX
``state["revival"]``). ``local_conditioning`` is the synthesis front end:
every item's codes on batch-1 semantics, then the k2 mixer.
"""
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from vqvae_speech_tpu_torch.models.conv_vqvae import feature_channels
from vqvae_speech_tpu_torch.models.encoder import ConvolutionalEncoder
from vqvae_speech_tpu_torch.models.vq import VectorQuantizer
from vqvae_speech_tpu_torch.models.wavenet_decoder import WaveNetDecoder
from vqvae_speech_tpu_torch.nn import Conv1d
from vqvae_speech_tpu_torch.nn.cast import cast_call
from vqvae_speech_tpu_torch.ops.vq import vq_search


class WaveNetVQVAEOutput(NamedTuple):
    reconstructed_x: torch.Tensor  # (B, T_samples, quantize) logits
    vq_loss: torch.Tensor
    losses: dict
    perplexity: torch.Tensor
    encoding_indices: torch.Tensor  # (N, 1) reference-layout flat indices
    new_state: dict                 # {"vq": EMA state or {}, ["revival"]}
    pre_vq_latents: torch.Tensor    # (B, T', D), detached


class WaveNetVQVAE(nn.Module):
    def __init__(self, configuration: dict, num_speakers: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(configuration)
        hid = configuration["num_hiddens"]
        D = configuration["embedding_dim"]
        self.encoder = ConvolutionalEncoder(
            feature_channels(configuration, "input"), hid,
            configuration["num_residual_layers"],
            configuration["residual_channels"],
            configuration["use_kaiming_normal"], generator)
        self.pre_vq_conv = Conv1d(hid, D, 1, padding=0, generator=generator)
        self.vq = VectorQuantizer(configuration["num_embeddings"], D,
                                  configuration["commitment_cost"],
                                  configuration["decay"], generator=generator)
        self.decoder = WaveNetDecoder(configuration, num_speakers, generator)
        if configuration.get("codebook_revival", False):
            K = configuration["num_embeddings"]
            self.register_buffer("revival_usage", torch.full((K,), 1.0 / K))
        else:
            self.revival_usage = None

    def latents(self, feats: torch.Tensor) -> torch.Tensor:
        """Encoder + k1 pre-VQ conv: (B, T_feat, C_in) -> (B, D, T_lat)."""
        return self.pre_vq_conv(self.encoder(feats.transpose(1, 2)))

    def forward(self, x_enc, x_dec_onehot, speaker_ids, *,
                jitter_masks=None, dropout_masks=None,
                jitter_generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None,
                decoder_compute_dtype: Optional[torch.dtype] = None
                ) -> WaveNetVQVAEOutput:
        """x_enc: (B, T_feat, C_in) features; x_dec_onehot: (B, T_samp,
        quantize) teacher-forcing inputs; speaker_ids: (B,). The draws and
        ``decoder_compute_dtype`` are as the module docstring says."""
        z = self.latents(x_enc)
        vq_out = self.vq(z)
        x_dec, quantized = x_dec_onehot, vq_out.quantized
        decode = dict(jitter_masks=jitter_masks,
                      jitter_generator=jitter_generator,
                      dropout_masks=dropout_masks,
                      dropout_generator=dropout_generator)
        if decoder_compute_dtype is not None:
            x_dec = x_dec.to(decoder_compute_dtype)
            quantized = quantized.to(decoder_compute_dtype)
        recon = cast_call(self.decoder, decoder_compute_dtype,
                          (x_dec, quantized, speaker_ids), decode)
        new_state = {"vq": vq_out.new_state or {}}
        if self.revival_usage is not None:
            new_state["revival"] = {"usage": self.revival_usage}
        return WaveNetVQVAEOutput(
            reconstructed_x=recon.float(),
            vq_loss=vq_out.vq_loss,
            losses=vq_out.losses,
            perplexity=vq_out.perplexity,
            encoding_indices=vq_out.indices,
            new_state=new_state,
            pre_vq_latents=z.detach().transpose(1, 2),
        )

    @torch.inference_mode()
    def local_conditioning(self, feats: torch.Tensor):
        """(B, T_feat, C_in) features -> (lc (B, T_lat - 1,
        local_condition_dim), codes (B, T_lat) int32).

        Every item is quantized on batch-1 semantics (the reference's
        (C, T, B) flatten of a (1, D, T_lat) tensor is ``z[b].reshape(-1,
        D)``), so the whole batch is ONE ``vq_search`` over
        ``z.reshape(-1, D)``; the straight-through value ``z + (q - z)``
        feeds the k2 mixer, as in the JAX package's ``codes_to_lc``."""
        z = self.latents(feats).contiguous()                  # (B, D, T)
        B, D, T = z.shape
        res = vq_search(z.view(-1, D), self.vq.codebook)
        q = res.quantized.view(B, D, T)
        quantized = (z + (q - z)).transpose(1, 2)             # (B, T, D)
        return self.decoder.mix(quantized), res.indices.view(B, T)
