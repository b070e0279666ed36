"""LJSpeech preprocessing + dataset for the vocoder pipelines.

Counterpart of ``vqvae_speech_tpu/data/ljspeech.py`` (reference
src/clarinet/preprocessing.py:34-113, src/clarinet/data.py:33-143 and
their flow_wavenet twins, the r9y9-style src/preprocess.py +
src/ljspeech.py): metadata.csv walk -> per-utterance audio/mel npy pairs +
train.txt manifest; a dataset with a train/test tail split and a
random-crop batcher aligned to hop_length.

Audio I/O is scipy (``data/audio.py``), the mel the port's
``ops/mel.py::normalized_log_mel`` on the CPU, mu-law the port's
``ops/mu_law.py``; the batcher emits fixed-size numpy arrays.
"""
import os

import numpy as np
import torch

from vqvae_speech_tpu_torch.data.audio import load_wav
from vqvae_speech_tpu_torch.models.wavenet.util import is_mulaw_quantize
from vqvae_speech_tpu_torch.ops.mel import normalized_log_mel
from vqvae_speech_tpu_torch.ops.mu_law import mu_law_encode
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger

SR = 22050
N_FFT = 1024
HOP_LENGTH = 256
MAX_TIME_STEPS = 6400  # reference data.py:33


def start_and_end_indices(quantized, silence_threshold: int = 2,
                          mid: int = 128):
    """First/last indices where the mu-law signal leaves the silence band
    around the zero bin (reference r9y9 audio.start_and_end_indices, used
    at src/dataset/ljspeech.py:67)."""
    loud = np.abs(quantized.astype(np.int64) - mid) > silence_threshold
    nz = np.nonzero(loud)[0]
    if len(nz) == 0:
        return 0, len(quantized)
    return int(nz[0]), int(nz[-1]) + 1


def process_utterance(out_dir, index, wav_path, input_type: str = "raw",
                      quantize_channels: int = 256,
                      silence_threshold: int = 2):
    """One utterance -> (audio_filename, mel_filename, timesteps).

    input_type 'raw' follows the ClariNet/FloWaveNet preprocessing
    (reference src/clarinet/preprocessing.py:49-96); 'mulaw-quantize'
    follows the r9y9-style pipeline (reference
    src/dataset/ljspeech.py:55-107): mu-law bins as int16 with silence
    trimming around the zero bin, padded with the mu-law zero bin.
    """
    wav = load_wav(wav_path, SR)
    wav = wav / np.abs(wav).max() * 0.999

    if is_mulaw_quantize(input_type):
        out = mu_law_encode(torch.from_numpy(wav),
                            quantize_channels).numpy()
        start, end = start_and_end_indices(out, silence_threshold,
                                           quantize_channels // 2)
        wav, out = wav[start:end], out[start:end]
        constant_values = quantize_channels // 2
        out_dtype = np.int16
    else:
        out = wav
        constant_values = 0.0
        out_dtype = np.float32

    mel = normalized_log_mel(torch.from_numpy(
        np.ascontiguousarray(wav, np.float32))).numpy().astype(np.float32)
    N = mel.shape[0]
    pad = (len(wav) // HOP_LENGTH + 1) * HOP_LENGTH - len(wav)
    out = np.pad(out, (pad // 2, pad // 2 + pad % 2),
                 constant_values=constant_values)
    assert len(out) >= N * HOP_LENGTH
    out = out[: N * HOP_LENGTH]

    audio_filename = f"ljspeech-audio-{index:05d}.npy"
    mel_filename = f"ljspeech-mel-{index:05d}.npy"
    np.save(os.path.join(out_dir, audio_filename), out.astype(out_dtype),
            allow_pickle=False)
    np.save(os.path.join(out_dir, mel_filename), mel, allow_pickle=False)
    return audio_filename, mel_filename, len(out)


def preprocess(in_dir, out_dir, limit=None, input_type: str = "raw",
               num_workers: int = 4):
    """metadata.csv -> npy pairs + train.txt (reference preprocessing.py;
    its process pool becomes a thread pool: scipy's resampling and torch's
    mel release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            parts = line.strip().split("|")
            wav_path = os.path.join(in_dir, "wavs", f"{parts[0]}.wav")
            jobs.append((i + 1, wav_path, parts[-1]))

    def run(job):
        index, wav_path, text = job
        a, m, t = process_utterance(out_dir, index, wav_path,
                                    input_type=input_type)
        return (a, m, t, text)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        metadata = list(pool.map(run, jobs))
    with open(os.path.join(out_dir, "train.txt"), "w", encoding="utf-8") as f:
        for m in metadata:
            f.write("|".join(str(x) for x in m) + "\n")
    ConsoleLogger.success(
        f"Wrote {len(metadata)} utterances "
        f"({sum(m[2] for m in metadata) / SR / 3600:.2f} hours)")
    return metadata


class LJSpeechDataset:
    """train.txt-backed dataset with a tail test split (reference
    data.py:38-76)."""

    def __init__(self, data_root, train=True, test_size=0.05):
        self.data_root = data_root
        with open(os.path.join(data_root, "train.txt"), encoding="utf-8") as f:
            lines = [l.strip().split("|") for l in f if l.strip()]
        n_test = int(test_size * len(lines))
        lines = lines[: len(lines) - n_test] if train else \
            lines[len(lines) - n_test:]
        self.audio_paths = [os.path.join(data_root, l[0]) for l in lines]
        self.mel_paths = [os.path.join(data_root, l[1]) for l in lines]
        self.lengths = [int(l[2]) for l in lines]

    def __len__(self):
        return len(self.audio_paths)

    def __getitem__(self, idx):
        return np.load(self.audio_paths[idx]), np.load(self.mel_paths[idx])


def crop_batch(items, max_time_steps=MAX_TIME_STEPS, hop_length=HOP_LENGTH,
               rng=None):
    """Random-crop each (wav, mel) to hop-aligned max_time_steps and stack
    (reference collate_fn, data.py:90-143). Returns a dict with x (B, T, 1)
    inputs, y (B, T) targets, c (B, T//hop, n_mels)."""
    rng = rng or np.random.default_rng()
    max_steps = max_time_steps - max_time_steps % hop_length
    frames = max_steps // hop_length
    xs, cs = [], []
    for wav, mel in items:
        assert len(wav) % len(mel) == 0 and len(wav) // len(mel) == hop_length
        if len(wav) > max_steps:
            s = int(rng.integers(0, len(mel) - frames))
            wav = wav[s * hop_length:(s + frames) * hop_length]
            mel = mel[s:s + frames]
        else:  # pad short clips to the fixed crop size
            pad_t = frames - len(mel)
            mel = np.pad(mel, ((0, pad_t), (0, 0)))
            wav = np.pad(wav, (0, max_steps - len(wav)))
        xs.append(wav)
        cs.append(mel)
    x = np.stack(xs).astype(np.float32)
    return {"x": x[..., None], "y": x, "c": np.stack(cs).astype(np.float32)}


class LJSpeechLoader:
    """Shuffled crop-batch iterator (drop_last: every batch full)."""

    def __init__(self, dataset: LJSpeechDataset, batch_size: int,
                 seed: int = 0, max_time_steps=MAX_TIME_STEPS):
        self._ds = dataset
        self._bs = batch_size
        self._rng = np.random.default_rng(seed)
        self._max_time_steps = max_time_steps

    def __len__(self):
        return len(self._ds) // self._bs

    def __iter__(self):
        order = self._rng.permutation(len(self._ds))
        for start in range(0, len(self._ds) - self._bs + 1, self._bs):
            items = [self._ds[i] for i in order[start:start + self._bs]]
            yield crop_batch(items, self._max_time_steps, rng=self._rng)
