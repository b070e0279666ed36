"""VCTK corpus ingest: manifest, transcriptions, speakers, split, download.

Capability-parity with reference src/dataset/vctk.py:54-141 and the raw-audio
dataset semantics of src/dataset/vctk_dataset.py:39-164, without torch
DataLoader machinery: the corpus object yields preprocessed utterances
directly (TextGrid leading-silence cut, resample+trim+peak-normalize, mu-law
quantize, pad-or-random-crop to length+1).

A copy of ``vqvae_speech_tpu/data/vctk.py`` (the port imports nothing of the
JAX package), held equal to it by tests/test_torch_data.py, with two
differences: ``preprocess_utterance`` computes the mu-law bins with the
port's ``ops.mu_law_encode`` (bit-equal to the JAX package's native and jnp
encoders), and ``VCTK.download`` raises: the port fetches nothing, the corpus
is put under ``{root}/raw/VCTK-Corpus`` by hand.
"""
import os
import pathlib
import random

import numpy as np
import torch

from vqvae_speech_tpu_torch.data.audio import (
    load_and_preprocess,
    pad_or_random_crop,
)
from vqvae_speech_tpu_torch.data.textgrid import leading_silence_duration
from vqvae_speech_tpu_torch.ops.mu_law import mu_law_encode

DSET_PATH = "VCTK-Corpus"
AUDIO_EXTENSIONS = (".wav", ".WAV", ".flac", ".FLAC")


def make_manifest(dset_path: str):
    """Sorted walk of the corpus tree for audio files
    (reference vctk.py:21-33)."""
    audios = []
    dset_path = os.path.expanduser(dset_path)
    for target in sorted(os.listdir(dset_path)):
        d = os.path.join(dset_path, target)
        if not os.path.isdir(d):
            continue
        for root, _, fnames in sorted(os.walk(d)):
            for fname in sorted(fnames):
                if fname.endswith(AUDIO_EXTENSIONS):
                    audios.append(os.path.join(root, fname))
    return audios


def load_txts(dset_path: str):
    """{utterance-id: transcription} from the txt tree
    (reference vctk.py:35-52)."""
    utterences = {}
    dset_path = os.path.expanduser(dset_path)
    for target in sorted(os.listdir(dset_path)):
        d = os.path.join(dset_path, target)
        if not os.path.isdir(d):
            continue
        for root, _, fnames in sorted(os.walk(d)):
            for fname in sorted(fnames):
                if fname.endswith(".txt"):
                    with open(os.path.join(root, fname), "r") as f:
                        utterences[fname.rsplit(".", 1)[0]] = f.readline()
    return utterences


def make_speaker_dic(dset_path: str):
    """speaker name -> id from wav48/* dirs (reference vctk.py:58-63)."""
    speakers = sorted(str(p.name)
                      for p in pathlib.Path(dset_path).glob("wav48/*/"))
    return {speaker: i for i, speaker in enumerate(speakers)}


class VCTK:
    """Corpus handle: manifest + speakers + transcripts + 80/20 split."""

    def __init__(self, root: str, ratio: float = 0.8, download: bool = False,
                 shuffle_seed=None):
        self.root = os.path.expanduser(root)
        self.raw_folder = os.path.join(self.root, "raw")
        dset_abs_path = os.path.join(self.raw_folder, DSET_PATH)
        if download and not self._check_exists(dset_abs_path):
            self.download()
        if not os.path.isdir(dset_abs_path):
            raise FileNotFoundError(
                f"VCTK corpus not found at '{dset_abs_path}'")
        self.dset_path = dset_abs_path
        self.audios = make_manifest(dset_abs_path)
        self.utterences = load_txts(dset_abs_path)
        self.speaker_dic = make_speaker_dic(dset_abs_path)
        # Reference uses the global `random` module state for the split
        # (vctk.py:93-97); we take an explicit seed for reproducibility.
        rng = random.Random(shuffle_seed)
        rng.shuffle(self.audios)
        split = int(len(self.audios) * ratio)
        self.audios_train = self.audios[:split]
        self.audios_val = self.audios[split:]

    def _check_exists(self, dset_abs_path):
        return os.path.exists(os.path.join(dset_abs_path, "speaker-info.txt"))

    def download(self):
        """The JAX package downloads and unpacks the corpus here (reference
        vctk.py:102-141); the port fetches nothing."""
        raise NotImplementedError(
            f"the port does not download VCTK: put the corpus at "
            f"'{os.path.join(self.raw_folder, DSET_PATH)}'")


def textgrid_path_for_wav(wav_filename: str) -> str:
    """phonemes/<speaker>/<utt>.TextGrid next to the wav tree
    (reference vctk_dataset.py:106-108)."""
    parts = wav_filename.split(os.sep)
    return os.sep.join(parts[:-3] + ["phonemes", parts[-2],
                                     parts[-1].rsplit(".", 1)[0] + ".TextGrid"])


def preprocess_utterance(wav_filename: str, speaker_dic: dict,
                         sampling_rate: int = 16000, top_db: float = 20.0,
                         length: int = 7680, quantize: int = 256, rng=None):
    """One utterance -> dict matching the reference's per-item tuple
    (vctk_dataset.py:102-136): leading-silence cut (TextGrid if present, else
    RMS trim), peak-normalize, mu-law quantize, pad-or-random-crop to
    length+1 samples.
    """
    tg_path = textgrid_path_for_wav(wav_filename)
    sil = leading_silence_duration(tg_path) if os.path.isfile(tg_path) else 0.0
    audio, trimming_time = load_and_preprocess(
        wav_filename, sampling_rate, top_db,
        trimming_duration=sil if sil != 0.0 else None)

    target_len = None if length is None else length + 1
    start_trimming = None
    if target_len is not None:
        audio, start_trimming = pad_or_random_crop(audio, target_len, rng)
    quantized = mu_law_encode(torch.from_numpy(audio), quantize).numpy()

    speaker = pathlib.Path(wav_filename).parent.name
    shifting_time = trimming_time + (
        0 if start_trimming is None else start_trimming / sampling_rate)
    return {
        "preprocessed_audio": audio,
        "quantized": quantized,
        "speaker_id": np.int64(speaker_dic.get(speaker, 0)),
        "wav_filename": wav_filename,
        "sampling_rate": sampling_rate,
        "shifting_time": shifting_time,
        "random_starting_index": 0 if start_trimming is None else start_trimming,
        "preprocessed_length": (length if length is not None else len(audio)),
        "top_db": top_db,
    }
