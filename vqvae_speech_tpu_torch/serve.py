"""Batch wav -> VQ-code serving, and batch AR synthesis, with buckets.

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

``BucketedSynthesisServer`` is the counterpart of the JAX server of the same
name: local-conditioning frame buckets, launches padded to ``max_batch``,
each a greedy (or sampled) AR decode whose f32 layer stack runs as one
prepared ``glu_stack_step`` per step — on a GPU one launch of the
hand-written CUDA kernel, bound to the weights once a decode.

``BucketedParallelSynthesisServer`` is the counterpart of the JAX server of
the same name: one-pass synthesis with the ClariNet IAF student or the
FloWaveNet reverse pass over mel-frame buckets; with ``use_fused_chain`` at
``max_batch=1`` every resblock chain is one call of the fused chain kernels
(``ops/fused_resblock.py``) on a GPU.
"""
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vqvae_speech_tpu_torch.convert import (
    load_flowavenet_params,
    load_jax_params,
    load_student_params,
    load_upsample_params,
    load_wavenet_params,
)
from vqvae_speech_tpu_torch.models import ConvVQVAE, WaveNet
from vqvae_speech_tpu_torch.models.clarinet import (
    gaussian_wavenet_upsample,
    wavenet_student_generate,
)
from vqvae_speech_tpu_torch.models.flowavenet import flowavenet_reverse
from vqvae_speech_tpu_torch.models.wavenet import wavenet_incremental_generate
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


def _frame_bucket(buckets: Sequence[int], n: int) -> int:
    """The smallest of the ascending ``buckets`` that holds n frames."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"conditioning of {n} frames exceeds the largest "
                     f"bucket {buckets[-1]}")


@dataclass
class SynthesisResult:
    """wave: (n_samples,) trimmed to the request's true conditioning length,
    int32 mu-law bins from the AR server and a float32 waveform from the
    one-pass server; bucket: the padded frame count decoded."""
    wave: np.ndarray
    bucket: int


class BucketedSynthesisServer:
    """Batch vocoder synthesis: local-conditioning buckets + padded batches.

    WaveNet rows are batch-independent and generation is causal, so padded
    batch rows are exact and tail padding only perturbs samples within the
    conditioning upsampler's reach of the true end: greedy decode of a
    request is the same in any batch composition.

    Parameters
    ----------
    params, cfg : a ``wavenet_init``-shaped numpy tree and its WaveNetConfig.
    frame_buckets : conditioning lengths (frames) each launch is padded to.
    max_batch : streams per launch (the kernel takes up to 32).
    sample : categorical sampling (a ``torch.Generator`` seeded per launch)
        instead of greedy argmax.
    compute_dtype, weight_quant, mesh : the JAX server's bf16, int8 and
        tensor-parallel decodes; not ported yet, anything but None raises.
    device : where the model runs ("cuda", "cpu"); no default.
    """

    def __init__(self, params, cfg, *,
                 frame_buckets: Sequence[int] = (10, 20, 40),
                 max_batch: int = 8,
                 sample: bool = False,
                 compute_dtype=None,
                 weight_quant: Optional[str] = None,
                 mesh=None,
                 device):
        for name, value in (("compute_dtype", compute_dtype),
                            ("weight_quant", weight_quant), ("mesh", mesh)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}={value!r}: only the f32 single-device decode is "
                    "ported to PyTorch yet")
        self._device = resolve_device(device)
        self._cfg = cfg
        self._buckets = tuple(sorted(int(b) for b in frame_buckets))
        self._max_batch = int(max_batch)
        self._sample = sample
        self.model = load_wavenet_params(WaveNet(cfg), params).to(
            self._device).eval()
        self._launches = 0
        self._upsample_factor = self.model.upsample_factor

    def generate_batch(self, c: torch.Tensor, g=None, seed: int = 0):
        """One padded launch: c (B, bucket, cin) and g (B,) speaker ids (or
        None) on the server's device -> (outs (B, T, out) logits, emitted
        (B, T) int32), T = bucket * upsample_factor, both on the device."""
        gen = None
        if self._sample:
            gen = torch.Generator(device=self._device).manual_seed(seed)
        return wavenet_incremental_generate(
            self.model, self._cfg, c.shape[1] * self._upsample_factor, c=c,
            g=g, sample=self._sample, generator=gen, use_fused_stack=True)

    def padded_batch(self, conds: Sequence, speaker_ids: Optional[Sequence[int]],
                     bucket: int):
        """Zero-pad up to max_batch (Tc, cin) conditionings to (max_batch,
        bucket, cin) on the device, with speaker ids (max_batch,) (0 in
        padded rows) or None."""
        c = torch.zeros((self._max_batch, bucket, conds[0].shape[-1]),
                        dtype=torch.float32, device=self._device)
        for row, cond in enumerate(conds):
            c[row, :cond.shape[0]] = torch.as_tensor(
                cond, dtype=torch.float32, device=self._device)
        g = None
        if speaker_ids is not None:
            g = torch.zeros((self._max_batch,), dtype=torch.long,
                            device=self._device)
            g[:len(speaker_ids)] = torch.as_tensor(list(speaker_ids),
                                                   device=self._device)
        return c, g

    def synthesize(self, conds: Sequence, speaker_ids: Optional[Sequence[int]] = None,
                   seed: int = 0) -> List[SynthesisResult]:
        """conds: per-request (Tc, cin) local-conditioning arrays or tensors
        (e.g. ``WaveNetVQVAE.local_conditioning`` rows). Returns trimmed
        waves in order."""
        order: Dict[int, List[int]] = {}
        for i, c in enumerate(conds):
            order.setdefault(_frame_bucket(self._buckets, c.shape[0]),
                             []).append(i)

        results: List[Optional[SynthesisResult]] = [None] * len(conds)
        for bucket, idxs in sorted(order.items()):
            for at in range(0, len(idxs), self._max_batch):
                chunk = idxs[at:at + self._max_batch]
                c, g = self.padded_batch(
                    [conds[i] for i in chunk],
                    None if speaker_ids is None
                    else [speaker_ids[i] for i in chunk], bucket)
                _, emitted = self.generate_batch(c, g, seed)
                emitted = emitted.cpu().numpy()
                self._launches += 1
                for row, i in enumerate(chunk):
                    n = conds[i].shape[0] * self._upsample_factor
                    results[i] = SynthesisResult(wave=emitted[row, :n],
                                                 bucket=bucket)
        return results  # type: ignore[return-value]

    @property
    def stats(self) -> dict:
        return {"launches": self._launches, "max_batch": self._max_batch,
                "upsample_factor": self._upsample_factor}


class BucketedParallelSynthesisServer:
    """Batch ONE-PASS vocoder synthesis: ClariNet IAF student or FloWaveNet
    reverse, the high-throughput synthesis tier.

    Conditioning-length (mel-frame) buckets and launches padded to
    ``max_batch``, so every launch of a bucket has one shape.

    Determinism contract: each request's latent noise z is drawn from a
    ``torch.Generator`` seeded from (seed, its index in ``conds``), so a
    request's wave depends only on (seed, its position, its conditioning),
    never on batch composition. Both vocoders are per-row feed-forward
    convs, so padded batch rows are exact; because the coupling nets are
    NON-causal, samples within the conv receptive field of the padded tail
    differ from an unpadded run (send exact bucket-length conditioning when
    that matters).

    kind : 'flowavenet' (params, cfg: a ``flowavenet_init``-shaped numpy
        tree and its FlowavenetConfig) or 'iaf_student' (a
        ``wavenet_student_init``-shaped tree and its StudentConfig;
        requires teacher_params/teacher_cfg, whose conv stack performs the
        mel upsampling, as reference synthesize.py does).
    temp : scale on z (reference flow_wavenet/synthesize.py:60 uses 0.8).
    compute_dtype : the JAX server's bf16 path; not ported yet, anything
        but None raises.
    use_fused_chain : max_batch=1 only: run the vocoder's resblock chains
        through the fused chain (causal for iaf_student, non-causal for
        flowavenet): the hand-written CUDA kernel on a GPU.
    device : where the model runs ("cuda", "cpu"); no default.
    """

    def __init__(self, kind: str, params, cfg, *,
                 teacher_params=None, teacher_cfg=None,
                 frame_buckets: Sequence[int] = (20, 40, 80),
                 max_batch: int = 8,
                 temp: float = 0.8,
                 compute_dtype=None,
                 use_fused_chain: bool = False,
                 device):
        if kind not in ("flowavenet", "iaf_student"):
            raise ValueError(f"unknown parallel vocoder kind: {kind!r}")
        if kind == "iaf_student" and (teacher_params is None
                                      or teacher_cfg is None):
            raise ValueError("iaf_student needs teacher_params/teacher_cfg "
                             "for mel upsampling")
        if use_fused_chain and max_batch != 1:
            raise ValueError("use_fused_chain is the single-stream "
                             "(max_batch=1) path")
        if compute_dtype is not None:
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: only the f32 vocoders are "
                "ported to PyTorch yet")
        self._device = resolve_device(device)
        self._kind = kind
        self._cfg = cfg
        self._teacher_cfg = teacher_cfg
        if kind == "flowavenet":
            self._params = load_flowavenet_params(params, cfg, self._device)
            scales = cfg.upsample_scales
        else:
            self._params = load_student_params(params, cfg, self._device)
            # only the teacher's upsampling stack is used
            self._upsample = {"upsample_conv": load_upsample_params(
                teacher_params["upsample_conv"], self._device)}
            scales = teacher_cfg.upsample_scales
        self._buckets = tuple(sorted(int(b) for b in frame_buckets))
        self._max_batch = int(max_batch)
        self._temp = float(temp)
        self._use_fused_chain = bool(use_fused_chain)
        self._served = set()
        self._launches = 0
        self._upsample_factor = int(np.prod([int(s) for s in scales]))

    @torch.inference_mode()
    def generate_batch(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """One padded launch: z (B, T, 1) noise (already scaled by temp) and
        c (B, bucket, cin) mel frames on the server's device -> waves
        (B, T, 1), T = bucket * upsample_factor."""
        if self._kind == "flowavenet":
            return flowavenet_reverse(self._params, self._cfg, z, c,
                                      use_fused=self._use_fused_chain)
        c_up = gaussian_wavenet_upsample(self._upsample, c, self._teacher_cfg)
        return wavenet_student_generate(self._params, self._cfg, z, c_up,
                                        use_fused=self._use_fused_chain)

    def _noise(self, seed: int, index: int, T: int, noises) -> np.ndarray:
        """Request ``index``'s unit-normal z (T, 1): the caller's, or drawn
        from a generator seeded from (seed, index)."""
        if noises is not None:
            z = np.asarray(noises[index], np.float32)
            if z.shape != (T, 1):
                raise ValueError(f"noise {index} has shape {z.shape}; its "
                                 f"bucket needs {(T, 1)}")
            return z
        # the CPU generator keeps 32 bits of its seed: mix the pair into them
        mixed = np.random.SeedSequence([seed, index]).generate_state(1)[0]
        gen = torch.Generator(device="cpu").manual_seed(int(mixed))
        return torch.randn((T, 1), generator=gen).numpy()

    def synthesize(self, conds: Sequence[np.ndarray], seed: int = 0,
                   noises: Optional[Sequence[np.ndarray]] = None
                   ) -> List[SynthesisResult]:
        """conds: per-request (Tc, cin) mel arrays. ``noises``: optionally
        one unit-normal (bucket * upsample_factor, 1) array a request, used
        in place of the seeded draw. Returns float waves trimmed to each
        request's true length, in order."""
        if seed < 0:
            raise ValueError(f"seed {seed} is negative")
        if noises is not None and len(noises) != len(conds):
            raise ValueError(f"{len(noises)} noises for {len(conds)} requests")
        order: Dict[int, List[int]] = {}
        for i, c in enumerate(conds):
            order.setdefault(_frame_bucket(self._buckets, c.shape[0]),
                             []).append(i)

        results: List[Optional[SynthesisResult]] = [None] * len(conds)
        for bucket, idxs in sorted(order.items()):
            self._served.add(bucket)
            T = bucket * self._upsample_factor
            for at in range(0, len(idxs), self._max_batch):
                chunk = idxs[at:at + self._max_batch]
                cin = conds[chunk[0]].shape[-1]
                c = np.zeros((self._max_batch, bucket, cin), np.float32)
                z = np.zeros((self._max_batch, T, 1), np.float32)
                for row, i in enumerate(chunk):
                    c[row, :conds[i].shape[0]] = conds[i]
                    z[row] = self._noise(seed, i, T, noises) * np.float32(
                        self._temp)
                waves = self.generate_batch(
                    torch.from_numpy(z).to(self._device),
                    torch.from_numpy(c).to(self._device)).cpu().numpy()
                self._launches += 1
                for row, i in enumerate(chunk):
                    n = conds[i].shape[0] * self._upsample_factor
                    results[i] = SynthesisResult(wave=waves[row, :n, 0],
                                                 bucket=bucket)
        return results  # type: ignore[return-value]

    @property
    def stats(self) -> dict:
        return {"served_buckets": sorted(self._served),
                "launches": self._launches, "max_batch": self._max_batch,
                "upsample_factor": self._upsample_factor}
