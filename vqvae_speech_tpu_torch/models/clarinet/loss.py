"""ClariNet losses: Gaussian NLL, Gaussian sampling, closed-form KL, STFT loss.

Counterpart of ``vqvae_speech_tpu/models/clarinet/loss.py`` (reference
src/clarinet/loss.py:30-67 and the conv-based STFT at
src/clarinet/modules.py:142-188), channels-last. The STFT magnitude is
framing + ``torch.fft.rfft``, numerically the Fourier-basis conv the
reference builds. The draws of ``sample_from_gaussian`` are fed
(``noise=``) or come from an explicit ``torch.Generator``: JAX's PRNG
streams cannot be reproduced here.
"""
import math

import torch
import torch.nn.functional as F


def gaussian_loss(y_hat, y, log_std_min: float = -7.0):
    """y_hat: (B, T, 2) [mean, log_std]; y: (B, T, 1) -> per-element NLL
    (B, T) (reference loss.py:30-41: the negative log-prob term, minimized
    directly)."""
    mean = y_hat[..., 0:1]
    log_std = y_hat[..., 1:2].clamp_min(log_std_min)
    log_probs = -0.5 * (
        -math.log(2.0 * math.pi) - 2.0 * log_std
        - torch.square(y - mean) * torch.exp(-2.0 * log_std))
    return log_probs.squeeze(-1)


def sample_from_gaussian(y_hat, log_std_min: float = -7.0,
                         scale_factor: float = 1.0, *, noise=None,
                         generator=None):
    """y_hat: (B, T, 2) -> samples (B, T, 1) clipped to [-sf, sf]. The
    standard-normal draws are ``noise`` (B, T, 1) when given, else drawn
    from ``generator`` on y_hat's device."""
    mean = y_hat[..., 0:1]
    log_std = y_hat[..., 1:2].clamp_min(log_std_min)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=mean.dtype, device=mean.device)
    sample = mean + torch.exp(log_std) * noise
    return sample.clamp(-scale_factor, scale_factor)


def kl_gaussians(mu_q, logs_q, mu_p, logs_p, log_std_min: float = -7.0,
                 regularization: bool = True):
    """Closed-form KL(q || p) and the log-scale regularizer (or None)
    (reference loss.py:57-67)."""
    logs_q = logs_q.clamp_min(log_std_min)
    logs_p = logs_p.clamp_min(log_std_min)
    kl = (logs_p - logs_q) + 0.5 * (
        (torch.exp(2.0 * logs_q) + torch.square(mu_p - mu_q))
        * torch.exp(-2.0 * logs_p) - 1.0)
    reg = torch.square(logs_q - logs_p) if regularization else None
    return kl, reg


def kl_loss(mu_q, logs_q, mu_p, logs_p, regularization: bool = True):
    """(mean(KL + 4*reg), mean(KL), mean(reg)) (reference
    modules.py:110-124)."""
    kl, reg = kl_gaussians(mu_q, logs_q, mu_p, logs_p,
                           regularization=regularization)
    total = kl + (reg * 4.0 if reg is not None else 0.0)
    return (total.mean(), kl.mean(),
            reg.mean() if reg is not None else kl.new_zeros(()))


def stft_magnitude(x, filter_length: int = 1024, hop_length: int = 256):
    """x: (B, T) -> magnitude (B, n_bins, n_frames): zero-pad
    ``filter_length`` on both sides, then rectangular frames every
    ``hop_length`` samples against the Fourier basis (modules.py:163-172)."""
    xp = F.pad(x, (filter_length, filter_length))
    frames = xp.unfold(-1, filter_length, hop_length)  # (B, frames, filter)
    return torch.fft.rfft(frames, dim=-1).abs().transpose(1, 2)


def stft_frame_loss(x_student, x_truth, filter_length: int = 1024,
                    hop_length: int = 256):
    """MSE between STFT magnitudes (the distillation frame loss,
    reference train_student.py:111-115)."""
    s = stft_magnitude(x_student, filter_length, hop_length)
    t = stft_magnitude(x_truth, filter_length, hop_length)
    return torch.mean(torch.square(s - t))
