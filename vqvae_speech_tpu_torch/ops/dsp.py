"""Speech DSP features as batched PyTorch ops.

Counterpart of ``vqvae_speech_tpu/ops/dsp.py``: python_speech_features
numerics (winfunc=ones, preemph=0.97, nfft=512, nfilt=26, ceplifter=22,
appendEnergy=True), batched over leading axes, on whatever device the signal
lies on. The power spectrum is a batched ``rfft``, the branch the JAX package
runs off the TPU; its DFT-as-matmul branch was a TPU matrix-unit measure and
is not ported. The pure-numpy constant builders below are copies of the JAX
module's, so the port does not import it (it imports jax).
"""
import functools
import math

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def round_half_up(x: float) -> int:
    """python_speech_features-style rounding for frame sizes (decimal ROUND_HALF_UP)."""
    return int(math.floor(x + 0.5))


def num_frames(signal_len: int, frame_len: int, frame_step: int) -> int:
    """Number of frames produced by python_speech_features-style framing."""
    if signal_len <= frame_len:
        return 1
    return 1 + int(math.ceil((signal_len - frame_len) / frame_step))


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(nfilt: int = 26, nfft: int = 512, samplerate: int = 16000,
                   lowfreq: float = 0.0, highfreq: float = None) -> np.ndarray:
    """Triangular mel filterbank, (nfilt, nfft//2 + 1), float64 numpy."""
    highfreq = highfreq or samplerate / 2
    lowmel, highmel = _hz2mel(lowfreq), _hz2mel(highfreq)
    melpoints = np.linspace(lowmel, highmel, nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(melpoints) / samplerate).astype(np.int64)
    fb = np.zeros((nfilt, nfft // 2 + 1), dtype=np.float64)
    for j in range(nfilt):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fb


@functools.lru_cache(maxsize=None)
def _dct2_ortho_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_in, n_out): y = x @ M gives scipy
    ``dct(x, type=2, norm='ortho')[:n_out]``."""
    k = np.arange(n_out)[None, :]
    i = np.arange(n_in)[:, None]
    m = np.cos(np.pi * k * (2.0 * i + 1.0) / (2.0 * n_in))
    scale = np.full(n_out, np.sqrt(2.0 / n_in))
    scale[0] = np.sqrt(1.0 / n_in)
    return m * scale[None, :]


@functools.lru_cache(maxsize=None)
def _lifter_vector(ncep: int, L: int = 22) -> np.ndarray:
    if L <= 0:
        return np.ones(ncep)
    n = np.arange(ncep)
    return 1.0 + (L / 2.0) * np.sin(np.pi * n / L)


def _const(array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(array, dtype=like.dtype, device=like.device)


def preemphasis(signal: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[0] = x[0]; y[t] = x[t] - coeff * x[t-1]."""
    return torch.cat([signal[..., :1], signal[..., 1:] - coeff * signal[..., :-1]],
                     dim=-1)


def frame_signal(signal: torch.Tensor, frame_len: int, frame_step: int):
    """Frame (..., S) into (..., num_frames, frame_len), zero-padding the tail."""
    slen = signal.shape[-1]
    nframes = num_frames(slen, frame_len, frame_step)
    padlen = (nframes - 1) * frame_step + frame_len
    padded = torch.nn.functional.pad(signal, (0, padlen - slen))
    return padded.unfold(-1, frame_len, frame_step)


def power_spectrum(frames: torch.Tensor, nfft: int = 512) -> torch.Tensor:
    """1/nfft * |rfft(frames, nfft)|^2 over the last axis."""
    if frames.shape[-1] > nfft:
        frames = frames[..., :nfft]
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    return (1.0 / nfft) * spec.abs().square()


def fbank(signal: torch.Tensor, samplerate: int = 16000, winlen: float = 0.025,
          winstep: float = 0.01, nfilt: int = 26, nfft: int = 512,
          lowfreq: float = 0.0, highfreq: float = None, preemph: float = 0.97):
    """Mel filterbank energies + per-frame total energy.

    Returns (feat, energy): feat (..., T, nfilt), energy (..., T).
    """
    frame_len = round_half_up(winlen * samplerate)
    frame_step = round_half_up(winstep * samplerate)
    frames = frame_signal(preemphasis(signal, preemph), frame_len, frame_step)
    pspec = power_spectrum(frames, nfft)
    energy = pspec.sum(-1)
    energy = torch.where(energy == 0, _F32_EPS, energy)
    fb = _const(mel_filterbank(nfilt, nfft, samplerate, lowfreq, highfreq), pspec)
    feat = pspec @ fb.t()
    feat = torch.where(feat == 0, _F32_EPS, feat)
    return feat, energy


def mfcc(signal: torch.Tensor, samplerate: int = 16000, numcep: int = 13,
         nfilt: int = 26, nfft: int = 512, winlen: float = 0.025,
         winstep: float = 0.01, lowfreq: float = 0.0, highfreq: float = None,
         preemph: float = 0.97, ceplifter: int = 22,
         append_energy: bool = True) -> torch.Tensor:
    """Batched MFCC, (..., S) -> (..., T, numcep)."""
    feat, energy = fbank(signal, samplerate, winlen, winstep, nfilt, nfft,
                         lowfreq, highfreq, preemph)
    feat = torch.log(feat) @ _const(_dct2_ortho_matrix(nfilt, numcep), feat)
    feat = feat * _const(_lifter_vector(numcep, ceplifter), feat)
    if append_energy:
        feat = torch.cat([torch.log(energy)[..., None], feat[..., 1:]], dim=-1)
    return feat


def logfbank(signal: torch.Tensor, samplerate: int = 16000, nfilt: int = 26,
             nfft: int = 512, winlen: float = 0.025, winstep: float = 0.01,
             lowfreq: float = 0.0, highfreq: float = None,
             preemph: float = 0.97) -> torch.Tensor:
    """Batched log mel filterbank energies (..., S) -> (..., T, nfilt)."""
    feat, _ = fbank(signal, samplerate, winlen, winstep, nfilt, nfft, lowfreq,
                    highfreq, preemph)
    return torch.log(feat)


def delta(feat: torch.Tensor, N: int = 2) -> torch.Tensor:
    """Delta features over the time axis (axis -2), edge-padded.

    d[t] = sum_{n=1..N} n*(feat[t+n] - feat[t-n]) / (2*sum n^2)
    """
    if N < 1:
        raise ValueError("N must be >= 1")
    denom = 2.0 * sum(n ** 2 for n in range(1, N + 1))
    T = feat.shape[-2]
    first = feat[..., :1, :].expand(*feat.shape[:-2], N, feat.shape[-1])
    last = feat[..., -1:, :].expand(*feat.shape[:-2], N, feat.shape[-1])
    padded = torch.cat([first, feat, last], dim=-2)
    out = torch.zeros_like(feat)
    for n in range(-N, N + 1):
        if n:
            out = out + n * padded[..., N + n:N + n + T, :]
    return out / denom


def speech_features(name: str, signal: torch.Tensor, rate: int = 16000,
                    filters_number: int = 13, augmented: bool = True):
    """'mfcc' (numcep=filters_number) or 'logfbank' (nfilt=filters_number),
    optionally with delta and delta-delta concatenated on the feature axis."""
    if name == "mfcc":
        feat = mfcc(signal, samplerate=rate, numcep=filters_number)
    elif name == "logfbank":
        feat = logfbank(signal, samplerate=rate, nfilt=filters_number)
    else:
        raise ValueError(f"unknown feature type: {name!r}")
    if not augmented:
        return feat
    d = delta(feat, 2)
    return torch.cat([feat, d, delta(d, 2)], dim=-1)
