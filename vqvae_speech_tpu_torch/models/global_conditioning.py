"""Speaker (global) conditioning: embedding lookup broadcast over time.

Counterpart of ``vqvae_speech_tpu/models/global_conditioning.py``: a
persistent, learnable table (std 0.1 at init). The reference builds a fresh
random table on every call; pass ``resample_generator`` to reproduce that for
A/B studies.
"""
from typing import Optional

import torch
import torch.nn as nn


class GlobalConditioning(nn.Module):
    def __init__(self, num_speakers: int, gin_channels: int = 40,
                 std: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.std = std
        self.table = nn.Parameter(
            std * torch.randn(num_speakers, gin_channels, generator=generator))

    def forward(self, speaker_ids: torch.Tensor, T: int, expand: bool = True,
                resample_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """speaker_ids (B,) int -> (B, gin, T) if ``expand`` else (B, gin, 1)
        (the port's channels-first layout of the JAX (B, T, gin))."""
        table = self.table
        if resample_generator is not None:
            table = (self.std * torch.randn(
                table.shape, generator=resample_generator)).to(table)
        g = table[speaker_ids.long()][:, :, None]
        return g.expand(-1, -1, T) if expand else g
