"""Manifest-CSV spectrogram dataset (speech-recognition style, vestigial in
the reference but part of its surface — src/dataset/spectrogram_dataset.py:30-68).

Each manifest line is ``/path/to/audio.wav,/path/to/transcript.txt``; items
are (log1p-magnitude spectrogram, transcript string).

Counterpart of ``vqvae_speech_tpu/data/spectrogram_dataset.py`` on the port's
``data/audio.py`` and ``eval/evaluator.py::log1p_spectrogram`` (numpy and
scipy on the host).
"""
import numpy as np

from vqvae_speech_tpu_torch.data.audio import load_wav, trim_silence
from vqvae_speech_tpu_torch.eval.evaluator import log1p_spectrogram


class SpectrogramDataset:
    def __init__(self, manifest_filepath, sample_rate: int = 16000,
                 normalize: bool = False, augment: bool = False, rng=None):
        with open(manifest_filepath) as f:
            self.ids = [line.strip().split(",") for line in f if line.strip()]
        self.sample_rate = sample_rate
        self.normalize = normalize
        self.augment = augment
        self._rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.ids)

    def parse_audio(self, audio_path):
        y = load_wav(audio_path, self.sample_rate)
        y, _ = trim_silence(y)
        peak = np.abs(y).max()
        if peak > 0:
            y = y / peak
        if self.augment:
            from vqvae_speech_tpu_torch.data.noise_injector import (
                augment_tempo_gain)

            y = augment_tempo_gain(y, self.sample_rate, rng=self._rng)
        spect = log1p_spectrogram(y, self.sample_rate)
        if self.normalize:
            spect = (spect - spect.mean()) / (spect.std() + 1e-8)
        return spect

    def parse_transcript(self, transcript_path):
        with open(transcript_path, encoding="utf-8") as f:
            return f.read().strip()

    def __getitem__(self, index):
        audio_path, transcript_path = self.ids[index][0], self.ids[index][1]
        return (self.parse_audio(audio_path),
                self.parse_transcript(transcript_path))
