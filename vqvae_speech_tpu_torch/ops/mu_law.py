"""Mu-law companding.

Counterpart of ``vqvae_speech_tpu/ops/mu_law.py`` (reference
src/speech_utils/mu_law.py:33-46). The encoder compands with
``sign(x) * log1p(mu*|x|) / log1p(mu)`` and bins with
``floor((y + 1) * mu / 2)`` clipped to ``[-1, mu - 1]`` (the reference's
``np.digitize`` minus one); the decoder inverts the compander on the bin's
scaled value ``2*y/mu - 1``. All arithmetic is f32, as in the JAX package,
so the bins are bit-equal to it.
"""
import torch


def mu_law_encode(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Float waveform in [-1, 1] -> int32 bins in [0, mu - 1]."""
    x = x.to(torch.float32)
    log1p_mu = torch.log1p(torch.tensor(float(mu), device=x.device))
    y = torch.sign(x) * torch.log1p(mu * x.abs()) / log1p_mu
    idx = torch.floor((y + 1.0) * (mu / 2.0)).to(torch.int32)
    return idx.clamp(-1, mu - 1)


def mu_law_decode(y: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Integer bins -> f32 waveform (reference mu_law.py:41-46)."""
    y = 2.0 * y.to(torch.float32) / mu - 1.0
    return torch.sign(y) / mu * (torch.pow(float(mu), y.abs()) - 1.0)
