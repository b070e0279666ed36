"""WaveNetDecoder: latents -> conv k2 mixer -> conditioned WaveNet.

Counterpart of ``vqvae_speech_tpu/models/wavenet_decoder.py`` (reference
src/models/wavenet_decoder.py:38-88): a kernel-2 conv with padding 0 mixes
neighbouring latents (T_lat -> T_lat - 1), and the WaveNet takes the mixed
latents as local conditioning (upsampled x384) and the speaker id as global
conditioning. In training mode a ``use_jitter`` configuration jitters the
latents first (``nn.layers.jitter``, the reference's inverted probability
and detached replacements, as ``wavenet_decoder_apply`` calls it), then the
WaveNet applies its dropout; the draws of both are fed or drawn from
generators (JAX splits its key as the jitter's first, then the WaveNet's).
"""
from typing import Optional

import torch
import torch.nn as nn

from vqvae_speech_tpu_torch.models.wavenet.model import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.nn import Conv1d, jitter

# Reference wavenet_decoder.py:76 passes [2,2,2,2,2,12] with a "# 768"
# comment, but the product is 384; the code's behaviour is what is kept.
UPSAMPLE_SCALES = (2, 2, 2, 2, 2, 12)  # prod = 384


def wavenet_config_from(configuration: dict, num_speakers: int) -> WaveNetConfig:
    return WaveNetConfig(
        out_channels=configuration["quantize"],
        layers=configuration["n_layers"],
        stacks=configuration["n_loop"],
        residual_channels=configuration["residual_channels"],
        gate_channels=configuration["gate_channels"],
        skip_out_channels=configuration["skip_out_channels"],
        kernel_size=configuration["filter_size"],
        cin_channels=configuration["local_condition_dim"],
        gin_channels=configuration["global_condition_dim"],
        n_speakers=num_speakers,
        upsample_conditional_features=True,
        upsample_scales=UPSAMPLE_SCALES,
    )


class WaveNetDecoder(nn.Module):
    def __init__(self, configuration: dict, num_speakers: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = wavenet_config_from(configuration, num_speakers)
        self.use_jitter = bool(configuration.get("use_jitter"))
        self.jitter_probability = configuration.get("jitter_probability",
                                                    0.12)
        self.conv_1 = Conv1d(
            configuration["embedding_dim"],
            configuration["local_condition_dim"], 2,
            use_weight_norm=configuration["use_kaiming_normal"],
            generator=generator)
        self.wavenet = WaveNet(self.cfg, generator)

    def mix(self, latents: torch.Tensor) -> torch.Tensor:
        """The k2 mixer: (B, T_lat, D) -> (B, T_lat - 1, local_condition_dim)."""
        return self.conv_1(latents.transpose(1, 2)).transpose(1, 2)

    def forward(self, y, local_condition, global_condition, *,
                jitter_masks=None,
                jitter_generator: Optional[torch.Generator] = None,
                dropout_masks=None,
                dropout_generator: Optional[torch.Generator] = None):
        """y: (B, T, quantize) one-hot audio; local_condition: (B, T_lat, D)
        latents; global_condition: (B,) speaker ids -> (B, T, quantize).

        In training: ``jitter_masks`` = (replace, direction) or draws from
        ``jitter_generator`` jitter the latents (``use_jitter``), and
        ``dropout_masks`` or ``dropout_generator`` feed the WaveNet's
        dropout (``WaveNet.forward``)."""
        if self.training and self.use_jitter:
            replace, direction = jitter_masks or (None, None)
            local_condition = jitter(
                local_condition.transpose(1, 2), self.jitter_probability,
                replace=replace, direction=direction,
                generator=jitter_generator).transpose(1, 2)
        return self.wavenet(y, self.mix(local_condition), global_condition,
                            dropout_masks=dropout_masks,
                            dropout_generator=dropout_generator)
