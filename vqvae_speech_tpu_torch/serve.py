"""Batch wav -> VQ-code serving with wave-length buckets.

Counterpart of ``BucketedEncodeServer`` in ``vqvae_speech_tpu/serve.py``,
with the same API and exactness contract: for every request, the returned
codes equal a standalone batch-1 encode of the same wave zero-padded to its
bucket length.

Requests are grouped into wave-length buckets and each launch is padded to
``max_batch`` waves, so every launch of a bucket has one shape. The JAX
server runs ``jax.vmap`` of a batch-1 encode, because the reference's
(C, T, B)-order VQ flatten would mix batch items in one row at B > 1. Here
that vmap is written out as a batch dimension: features, encoder and pre-VQ
conv run on the whole (max_batch, C, T) batch; item b's batch-1 flatten is
``z[b].reshape(-1, D)`` (the reference flatten of a (1, C, T) tensor), so
the whole launch is ``z.reshape(-1, D)`` and ONE ``vq_search`` over all
max_batch * C * T / D rows — the fused CUDA kernel on a GPU.
"""
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vqvae_speech_tpu_torch.convert import load_jax_params
from vqvae_speech_tpu_torch.models import ConvVQVAE
from vqvae_speech_tpu_torch.ops import num_frames, speech_features, vq_search
from vqvae_speech_tpu_torch.utils import resolve_device


@dataclass
class EncodeResult:
    """codes: (T_lat,) int32 VQ indices of the zero-padded wave (reference
    .view(B, -1) stream order); n_frames: feature frames of the TRUE wave;
    bucket: the padded wave length actually encoded."""
    codes: np.ndarray
    n_frames: int
    bucket: int


class BucketedEncodeServer:
    """Batch wav -> VQ-code serving over a trained ConvolutionalVQVAE.

    Parameters
    ----------
    params, state, config : the trained model triple as numpy trees (see
        train/checkpoint.py:load_checkpoint, or convert.numpy_params).
    wave_buckets : ascending wave lengths (samples). Requests longer than
        the largest bucket are rejected.
    max_batch : waves per launch.
    normalizer : optional {"train_mean", "train_std"} feature normalizer.
    device : where the model runs ("cuda", "cuda:1", "cpu"); no default.
    """

    def __init__(self, params, state, config: dict, *,
                 wave_buckets: Sequence[int] = (7680, 15360, 30720),
                 max_batch: int = 64,
                 normalizer: Optional[dict] = None,
                 device):
        self._device = resolve_device(device)
        self._config = dict(config)
        self._buckets = tuple(sorted(int(b) for b in wave_buckets))
        self._max_batch = int(max_batch)
        self.model = load_jax_params(ConvVQVAE.from_config(config), params,
                                     state).to(self._device).eval()
        self._mean = self._std = None
        if normalizer is not None:
            self._mean = torch.as_tensor(normalizer["train_mean"],
                                         dtype=torch.float32, device=self._device)
            self._std = torch.as_tensor(normalizer["train_std"],
                                        dtype=torch.float32, device=self._device)
        self._served = set()
        self._launches = 0

    def bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise ValueError(
            f"wave of {n} samples exceeds the largest bucket "
            f"{self._buckets[-1]}; add a bucket or chunk the input")

    @torch.inference_mode()
    def features(self, waves: torch.Tensor) -> torch.Tensor:
        """(B, bucket) f32 waves -> (B, T, C_in) (normalized) features."""
        cfg = self._config
        feats = speech_features(cfg.get("input_features_type", "mfcc"), waves,
                                cfg.get("sampling_rate", 16000),
                                cfg["input_features_filters"],
                                cfg.get("augment_input_features", True))
        if self._mean is not None:
            feats = (feats - self._mean) / self._std
        return feats

    @torch.inference_mode()
    def encode_batch(self, waves: torch.Tensor) -> torch.Tensor:
        """(B, bucket) f32 waves on the server's device -> (B, T_lat) int32
        codes, each row on batch-1 reference semantics."""
        z = self.model.latents(self.features(waves))      # (B, D, T')
        D = self.model.vq.codebook.shape[1]
        res = vq_search(z.contiguous().view(-1, D), self.model.vq.codebook)
        return res.indices.view(waves.shape[0], -1)

    def padded_batch(self, waves: Sequence[np.ndarray], bucket: int):
        """Zero-pad up to max_batch waves to (max_batch, bucket) on device."""
        batch = np.zeros((self._max_batch, bucket), np.float32)
        for row, w in enumerate(waves):
            batch[row, :len(w)] = np.asarray(w, np.float32)
        return torch.from_numpy(batch).to(self._device)

    def _frames(self, n_samples: int) -> int:
        rate = self._config.get("sampling_rate", 16000)
        return num_frames(n_samples, int(0.025 * rate), int(0.010 * rate))

    def encode(self, waves: Sequence[np.ndarray]) -> List[EncodeResult]:
        """Encode a heterogeneous batch of float waves (any lengths that fit
        the buckets). Returns one EncodeResult per input, in order."""
        order: Dict[int, List[int]] = {}
        for i, w in enumerate(waves):
            order.setdefault(self.bucket_for(len(w)), []).append(i)

        results: List[Optional[EncodeResult]] = [None] * len(waves)
        for bucket, idxs in sorted(order.items()):
            self._served.add(bucket)
            for at in range(0, len(idxs), self._max_batch):
                chunk = idxs[at:at + self._max_batch]
                batch = self.padded_batch([waves[i] for i in chunk], bucket)
                codes = self.encode_batch(batch).cpu().numpy()
                self._launches += 1
                for row, i in enumerate(chunk):
                    results[i] = EncodeResult(
                        codes=codes[row],
                        n_frames=self._frames(len(waves[i])),
                        bucket=bucket)
        return results  # type: ignore[return-value]

    @property
    def stats(self) -> dict:
        return {"served_buckets": sorted(self._served),
                "launches": self._launches,
                "max_batch": self._max_batch}
