"""ClariNet IAF student: stack of Gaussian WaveNet flows, parallel synthesis.

Counterpart of ``vqvae_speech_tpu/models/clarinet/wavenet_iaf.py``
(reference src/clarinet/wavenet_iaf.py:30-126): flows with block counts
[1, 1, 1, 4]; ``iaf()`` composes means/scales across flows:

    mu_tot = mu_tot * exp(logs) + mu ;  logs_tot += logs
    z      = z[1:] * exp(logs) + mu, left-padded with 0

Generation is one pass, no autoregression.
"""
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.models.clarinet.modules import (
    cast_params,
    check_compute_dtype,
)
from vqvae_speech_tpu_torch.models.clarinet.wavenet import (
    GaussianWaveNetConfig,
    gaussian_wavenet_core,
    gaussian_wavenet_core_fused,
)


@dataclass(frozen=True)
class StudentConfig:
    num_blocks_student: Sequence[int] = (1, 1, 1, 4)
    num_layers: int = 6
    front_channels: int = 32
    residual_channels: int = 128
    gate_channels: int = 256
    skip_channels: int = 128
    kernel_size: int = 3
    cin_channels: int = 80
    causal: bool = True

    def flow_config(self, i) -> GaussianWaveNetConfig:
        return GaussianWaveNetConfig(
            out_channels=2,
            num_blocks=self.num_blocks_student[i],
            num_layers=self.num_layers,
            front_channels=self.front_channels,
            residual_channels=self.residual_channels,
            gate_channels=self.gate_channels,
            skip_channels=self.skip_channels,
            kernel_size=self.kernel_size,
            cin_channels=self.cin_channels,
            causal=self.causal)

    @property
    def num_flow(self):
        return len(self.num_blocks_student)


def wavenet_student_apply(params, cfg: StudentConfig, z, c_up,
                          use_fused=False):
    """z: (B, T, 1) noise; c_up: (B, T, cin) pre-upsampled conditioning.

    Returns (x (B, T, 1), mu_tot (B, T-1, 1), logs_tot (B, T-1, 1)) as the
    reference's iaf() (wavenet_iaf.py:52-62). ``use_fused`` runs every
    flow's resblock chains through the fused chain (batch 1 only; see
    gaussian_wavenet_core_fused).
    """
    core = gaussian_wavenet_core_fused if use_fused else gaussian_wavenet_core
    mu_tot = torch.zeros_like(z[:, :-1, :])
    logs_tot = torch.zeros_like(z[:, :-1, :])
    for i, p in enumerate(params["iafs"]):
        mu_logs = core(p, cfg.flow_config(i), z, c_up)
        mu = mu_logs[:, :-1, 0:1]
        logs = mu_logs[:, :-1, 1:2]
        mu_tot = mu_tot * torch.exp(logs) + mu
        logs_tot = logs_tot + logs
        z = F.pad(z[:, 1:, :] * torch.exp(logs) + mu, (0, 0, 1, 0))
    return z, mu_tot, logs_tot


def wavenet_student_generate(params, cfg: StudentConfig, z, c_up,
                             compute_dtype=None, use_fused=False):
    """One-pass synthesis. ``compute_dtype=torch.bfloat16`` is the
    synthesis-serving configuration: the parameters, z and c_up are cast in
    (``cast_params``; a tree loaded at bf16 is used as it is), every flow
    and the IAF recursion run in bf16, and the wave is returned as f32.
    None or f32 runs in f32. ``use_fused`` selects the batch-1 fused
    resblock chains (the single-stream path)."""
    check_compute_dtype(compute_dtype)
    if compute_dtype == torch.bfloat16:
        params = cast_params(params, compute_dtype)
        z, c_up = z.to(compute_dtype), c_up.to(compute_dtype)
    x, _, _ = wavenet_student_apply(params, cfg, z, c_up, use_fused=use_fused)
    return x.float()
