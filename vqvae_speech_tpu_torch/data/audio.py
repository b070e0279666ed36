"""Host-side audio I/O: wav load, resample, silence trim, peak normalization.

Counterpart of ``vqvae_speech_tpu/data/audio.py`` (numpy and scipy only), so
that the port and its GPU smoke run need nothing of the JAX package:
``scipy.io.wavfile`` read, polyphase resampling, an RMS-envelope trim
``top_db`` below the peak with librosa's framing (2048 / 512), then peak
normalization (reference src/dataset/vctk_dataset.py:141-152), and the
pad-or-random-crop of a preprocessed utterance.
"""
import math

import numpy as np
from scipy.io import wavfile


def load_wav(path: str, target_rate: int = 16000) -> np.ndarray:
    """Read a wav file as float32 in [-1, 1], resampled to target_rate."""
    rate, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
    else:
        data = data.astype(np.float32)
    if rate != target_rate:
        # imported here: scipy.signal takes seconds to import, and a CLI
        # process that reads no wav of another rate needs none of it
        from scipy.signal import resample_poly

        g = math.gcd(int(rate), int(target_rate))
        data = resample_poly(data, target_rate // g, rate // g).astype(np.float32)
    return data


def trim_silence(y: np.ndarray, top_db: float = 20.0,
                 frame_length: int = 2048, hop_length: int = 512):
    """Trim leading/trailing frames ``top_db`` below the peak framewise RMS
    (center-padded frames, librosa.effects.trim semantics).

    Returns (trimmed, (start_idx, end_idx)).
    """
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad))
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    rms = np.sqrt(np.mean(yp[idx] ** 2, axis=1))
    ref = np.max(rms)
    if ref <= 0:
        return y, (0, len(y))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    non_silent = np.nonzero(db > -top_db)[0]
    if len(non_silent) == 0:
        return y[:0], (0, 0)
    start = int(non_silent[0] * hop_length)
    end = int(min(len(y), (non_silent[-1] + 1) * hop_length))
    return y[start:end], (start, end)


def load_and_preprocess(path: str, sampling_rate: int = 16000,
                        top_db: float = 20.0, trimming_duration=None):
    """Load, silence-trim (or cut a known leading-silence duration, in
    seconds) and peak-normalize one utterance. The scale is the f32
    reciprocal of the peak, as the JAX package's native ingest applies it.

    Returns (audio float32 peak-normalized, trimming_time seconds).
    """
    raw = load_wav(path, sampling_rate)
    if trimming_duration is None:
        trimmed, (start, _) = trim_silence(raw, top_db)
        trimming_time = start / sampling_rate
    else:
        trimmed = raw[int(trimming_duration * sampling_rate):]
        trimming_time = trimming_duration
    peak = np.abs(trimmed).max() if len(trimmed) else np.float32(0)
    if peak > 0:
        trimmed = trimmed * (np.float32(1) / peak)
    return trimmed.astype(np.float32), trimming_time


def pad_or_random_crop(audio: np.ndarray, length: int, rng=None):
    """Zero-pad to ``length`` or random-crop a ``length`` window
    (reference vctk_dataset.py:51-66).  Returns (audio, start or None)."""
    if len(audio) <= length:
        return (np.concatenate([audio,
                                np.zeros(length - len(audio), np.float32)]),
                None)
    rng = rng or np.random.default_rng()
    start = int(rng.integers(0, len(audio) - length))
    return audio[start:start + length], start
