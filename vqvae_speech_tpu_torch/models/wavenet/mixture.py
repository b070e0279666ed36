"""Discretized mixture-of-logistics loss and sampling (PixelCNN++ style).

Counterpart of ``vqvae_speech_tpu/models/wavenet/mixture.py`` (reference
src/wavenet_vocoder/mixture.py:42-179): the scalar-output WaveNet mode, where
y holds [logit_probs | means | log_scales] on the channel axis and targets
are waveform samples in [-1, 1] discretized into ``num_classes`` bins.

The sampler's randomness is explicit. The mixture choice is Gumbel-max over
``logit_probs`` (``jax.random.categorical``'s own construction) and the
logistic draw inverts the CDF at ``u`` uniform in [1e-5, 1 - 1e-5). A caller
passes either a ``torch.Generator`` or the draws themselves (``gumbel``,
``u``), so a test can feed the JAX package's.
"""
import math

import torch
import torch.nn.functional as F

U_MIN = 1e-5  # u is drawn in [U_MIN, 1 - U_MIN), as the JAX sampler draws it


def log_sum_exp(x, dim: int = -1):
    m = x.amax(dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim))


def log_prob_from_logits(x, dim: int = -1):
    m = x.amax(dim, keepdim=True)
    return x - m - torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus rounds otherwise
    return torch.logaddexp(x, torch.zeros_like(x))


def discretized_mix_logistic_loss(y_hat, y, num_classes: int = 256,
                                  log_scale_min: float = -7.0,
                                  reduce: bool = True):
    """y_hat: (B, T, 3*nr_mix) [logits | means | log_scales]; y: (B, T, 1)
    targets in [-1, 1]. The mean negative log-likelihood, or (B, T, 1) of
    them with ``reduce=False``."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp_min(y_hat[..., 2 * nr_mix:], log_scale_min)

    y = y.expand(*y.shape[:-1], nr_mix)
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus_in = inv_stdv * (centered + half_bin)
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered - half_bin)
    cdf_min = torch.sigmoid(min_in)

    log_cdf_plus = plus_in - _softplus(plus_in)       # log CDF at the -1 edge
    log_one_minus_cdf_min = -_softplus(min_in)        # log(1 - CDF) at +1
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * _softplus(mid_in)

    inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp_min(cdf_delta, 1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    log_probs = torch.where(
        y < -0.999, log_cdf_plus,
        torch.where(y > 0.999, log_one_minus_cdf_min, inner))

    log_probs = log_probs + log_prob_from_logits(logit_probs)
    lse = log_sum_exp(log_probs)
    if reduce:
        return -torch.mean(lse)
    return -lse[..., None]


def gumbel_noise(shape, generator: torch.Generator, device=None):
    """Standard Gumbel draws, -log(-log(U)) with U uniform in [tiny, 1), as
    ``jax.random.gumbel`` makes them (from another generator)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def logistic_uniform(shape, generator: torch.Generator, device=None):
    """u uniform in [U_MIN, 1 - U_MIN), the sampler's CDF inversion point."""
    u = torch.rand(shape, generator=generator, device=device)
    return U_MIN + (1.0 - 2 * U_MIN) * u


def sample_from_discretized_mix_logistic(y, log_scale_min: float = -7.0, *,
                                         generator=None, gumbel=None, u=None):
    """y: (B, T, 3*nr_mix) -> samples (B, T) in [-1, 1].

    ``gumbel`` (B, T, nr_mix) and ``u`` (B, T) are the draws; without them
    both are drawn from ``generator`` on y's device."""
    nr_mix = y.shape[-1] // 3
    logit_probs = y[..., :nr_mix]
    if (gumbel is None) != (u is None):
        raise ValueError("pass both gumbel and u, or neither")
    if gumbel is None:
        if generator is None:
            raise ValueError("sampling needs a torch.Generator or the draws")
        gumbel = gumbel_noise(logit_probs.shape, generator, y.device)
        u = logistic_uniform(logit_probs.shape[:-1], generator, y.device)
    sel = torch.argmax(gumbel.to(y.dtype) + logit_probs, dim=-1)
    one_hot = F.one_hot(sel, nr_mix).to(y.dtype)
    means = torch.sum(y[..., nr_mix:2 * nr_mix] * one_hot, dim=-1)
    log_scales = torch.clamp_min(
        torch.sum(y[..., 2 * nr_mix:] * one_hot, dim=-1), log_scale_min)
    u = u.to(y.dtype)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)
