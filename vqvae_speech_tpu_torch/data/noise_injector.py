"""SNR-controlled noise injection + tempo/gain augmentation (sox-free).

Counterpart of ``vqvae_speech_tpu/data/noise_injector.py``: host numpy,
drawing from the ``np.random.Generator`` it is given, so its outputs are
bit-equal to the JAX package's numpy path under the same generator seeds.
One difference: ``wsola_time_stretch`` takes the numpy form unless the
caller asks for the C++ one of ``native.py`` (``use_native=True``), where
JAX's defaults to the C++ one. On an H100 host the C++ form was the slower
of the two (PERF.md), and the two part by an ulp (the C++ window is f32,
numpy's f64 rounded).

Capability-parity with reference src/dataset/noise_injector.py:34-83 (which
shells out to sox/soxi per sample) and the sox tempo/gain augmentation in
src/dataset/spectrogram_parser.py:103-129 — reimplemented with in-process
numpy: noise files are loaded directly, and the energy-matched mixing
formula is identical:

    data += noise_level * noise * rms(data) / rms(noise)

Tempo change is a real WSOLA time-stretch (`wsola_time_stretch`) — the same
algorithm sox's `tempo` effect uses — so pitch is preserved, matching the
reference's augmentation semantics exactly (no pitch shift at tempo != 1).
"""
import os

import numpy as np

from vqvae_speech_tpu_torch.data.audio import load_wav


def _find_audio_files(path):
    out = []
    for root, _, files in os.walk(path):
        for f in sorted(files):
            if f.lower().endswith((".wav", ".flac")):
                out.append(os.path.join(root, f))
    return out


class NoiseInjector:
    def __init__(self, path, sample_rate: int = 16000,
                 noise_levels=(0.0, 0.5), rng=None):
        if path is None or not os.path.exists(path):
            raise IOError(f"Directory doesn't exist: {path}")
        self.paths = _find_audio_files(path)
        if not self.paths:
            raise IOError(f"No audio files under: {path}")
        self.sample_rate = sample_rate
        self.noise_levels = noise_levels
        self._rng = rng or np.random.default_rng()

    def inject_noise(self, data):
        noise_path = self.paths[self._rng.integers(len(self.paths))]
        noise_level = self._rng.uniform(*self.noise_levels)
        return self.inject_noise_sample(data, noise_path, noise_level)

    def inject_noise_sample(self, data, noise_path, noise_level):
        noise = load_wav(noise_path, self.sample_rate)
        if len(noise) < len(data):  # loop short noise
            noise = np.tile(noise, int(np.ceil(len(data) / len(noise))))
        start = int(self._rng.integers(0, len(noise) - len(data) + 1))
        noise = noise[start:start + len(data)]
        noise_energy = np.sqrt(noise.dot(noise) / noise.size)
        data_energy = np.sqrt(data.dot(data) / data.size)
        if noise_energy == 0:
            return data
        return (data + noise_level * noise * data_energy
                / noise_energy).astype(np.float32)


def wsola_time_stretch(x, tempo: float, sample_rate: int = 16000,
                       win_ms: float = 25.0, tol_ms: float = 7.5,
                       use_native: bool = False):
    """Pitch-preserving time stretch (WSOLA — the algorithm behind sox's
    `tempo` effect used by the reference, spectrogram_parser.py:117-129).

    tempo > 1 speeds up (shorter output), < 1 slows down; pitch unchanged.
    Overlap-add of windowed analysis frames whose positions are searched
    within +-tol of the nominal grid to maximize cross-correlation with the
    natural continuation of the previous frame (waveform-similarity OLA).
    Host-side preprocessing in numpy; ``use_native=True`` takes the C++
    implementation (csrc/ingest.cpp:wsola_time_stretch) when it is built,
    the same algorithm, equal to the numpy one to within an ulp.
    """
    if use_native:
        from vqvae_speech_tpu_torch.native import wsola_time_stretch_native

        out = wsola_time_stretch_native(x, tempo, sample_rate, win_ms,
                                        tol_ms)
        if out is not None:
            return out
    x = np.asarray(x, np.float32)
    N = max(int(round(win_ms * sample_rate / 1000.0)) & ~1, 4)  # even
    if abs(tempo - 1.0) < 1e-6 or len(x) <= N:
        return x.copy()  # shorter than one window: nothing to align
    Hs = N // 2                                   # synthesis hop
    Ha = Hs * tempo                               # analysis hop
    tol = max(int(round(tol_ms * sample_rate / 1000.0)), 1)
    win = np.hanning(N).astype(np.float32)

    n_frames = max(int((len(x) - N - tol) / Ha), 1)
    out_len = (n_frames - 1) * Hs + N
    out = np.zeros(out_len, np.float32)
    norm = np.zeros(out_len, np.float32)

    seg_start = 0                                 # first frame: no search
    out[:N] += win * x[:N]
    norm[:N] += win
    for k in range(1, n_frames):
        natural = x[seg_start + Hs: seg_start + Hs + N]  # ideal continuation
        nominal = int(round(k * Ha))
        lo = max(nominal - tol, 0)
        hi = min(nominal + tol, len(x) - N)
        if hi <= lo:
            seg_start = max(min(nominal, len(x) - N), 0)
        else:
            # best-matching segment within the tolerance window
            search = x[lo: hi + N]
            corr = np.correlate(search, natural, mode="valid")[: hi - lo + 1]
            seg_start = lo + int(np.argmax(corr))
        pos = k * Hs
        out[pos: pos + N] += win * x[seg_start: seg_start + N]
        norm[pos: pos + N] += win
    out /= np.maximum(norm, 1e-6)
    # drop the tail where the final window tapers out (norm ~ 0 there, so
    # the un-overlapped samples are attenuated garbage), then trim to the
    # exact stretched length when shorter than synthesized
    covered = np.nonzero(norm >= 0.1)[0]
    out = out[: covered[-1] + 1] if len(covered) else out[:0]
    target = int(round(len(x) / tempo))
    return out[:target] if target < len(out) else out


def augment_tempo_gain(audio, sample_rate: int = 16000,
                       tempo_range=(0.85, 1.15), gain_range=(-6, 8),
                       rng=None):
    """Random pitch-preserving tempo (WSOLA) + gain (dB) perturbation
    (reference spectrogram_parser.py:103-129: sox `tempo {t} gain {g}`)."""
    rng = rng or np.random.default_rng()
    tempo = rng.uniform(*tempo_range)
    gain_db = rng.uniform(*gain_range)
    out = wsola_time_stretch(audio, tempo, sample_rate)
    return (out * (10.0 ** (gain_db / 20.0))).astype(np.float32)
