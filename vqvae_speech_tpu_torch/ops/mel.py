"""librosa-compatible mel spectrograms for the vocoder pipelines.

Counterpart of ``vqvae_speech_tpu/ops/mel.py``: the ClariNet/FloWaveNet
conditioning is librosa.feature.melspectrogram at 22.05 kHz (n_fft 1024, hop
256, 80 mels, fmin 125, fmax 7600) followed by a dB normalization into
[0, 1] (reference src/clarinet/preprocessing.py:49-70): centred
reflect-padded hann STFT, power spectrum, Slaney-scale mel filterbank with
Slaney area normalization. The filterbank is built in numpy f64, the
spectrogram runs on the device of the wave it is given.
"""
import functools

import numpy as np
import torch


def _hz_to_mel_slaney(hz):
    hz = np.asarray(hz, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (hz - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= min_log_hz,
                    min_log_mel + np.log(hz / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(mel):
    mel = np.asarray(mel, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    hz = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)


@functools.lru_cache(maxsize=None)
def mel_filterbank_slaney(sr: int = 22050, n_fft: int = 1024,
                          n_mels: int = 80, fmin: float = 125.0,
                          fmax: float = 7600.0) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney'): (n_mels, 1+n_fft//2)."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


def stft_power(y: torch.Tensor, n_fft: int = 1024, hop_length: int = 256):
    """Centred (reflect-padded) hann-window power spectrogram,
    (..., S) -> (..., n_frames, 1+n_fft//2): librosa.stft semantics."""
    pad = n_fft // 2
    yp = torch.cat([y[..., 1:pad + 1].flip(-1), y,
                    y[..., -pad - 1:-1].flip(-1)], dim=-1)
    frames = yp.unfold(-1, n_fft, hop_length)
    win = torch.as_tensor(np.hanning(n_fft + 1)[:-1], dtype=y.dtype,
                          device=y.device)
    return torch.fft.rfft(frames * win, dim=-1).abs().square()


def melspectrogram(y: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                   hop_length: int = 256, n_mels: int = 80,
                   fmin: float = 125.0, fmax: float = 7600.0):
    """(..., S) -> (..., n_frames, n_mels) power mel spectrogram."""
    S = stft_power(y, n_fft, hop_length)
    fb = torch.as_tensor(mel_filterbank_slaney(sr, n_fft, n_mels, fmin, fmax),
                         dtype=S.dtype, device=S.device)
    return S @ fb.T


def normalized_log_mel(y: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                       hop_length: int = 256, n_mels: int = 80,
                       fmin: float = 125.0, fmax: float = 7600.0,
                       reference: float = 20.0, min_db: float = -100.0):
    """The ClariNet/FloWaveNet conditioning features: 20*log10(mel) dB,
    referenced and clipped into [0, 1]
    (reference src/clarinet/preprocessing.py:66-68)."""
    mel = melspectrogram(y, sr, n_fft, hop_length, n_mels, fmin, fmax)
    db = 20.0 * torch.log10(mel.clamp_min(1e-4)) - reference
    return ((db - min_db) / (-min_db)).clamp(0.0, 1.0)
