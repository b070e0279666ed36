"""Batch wav -> VQ-code serving, and AR and one-pass synthesis serving.

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
hand-written CUDA kernel, bound to the weights once a decode. Its bf16 and
int8 decodes run the layer stack layer by layer, as JAX runs them.

``ContinuousSynthesisServer`` is the counterpart of the JAX server of the
same name: continuous batching over device-resident decode slots
(``models/wavenet/chunked.py``); every launch advances all slots one chunk,
and requests join and retire at chunk boundaries.

``BucketedParallelSynthesisServer`` is the counterpart of the JAX server of
the same name: one-pass synthesis with the ClariNet IAF student or the
FloWaveNet reverse pass over mel-frame buckets; with ``use_fused_chain`` at
``max_batch=1`` every resblock chain is one call of the fused chain kernels
(``ops/fused_resblock.py``) on a GPU.
"""
from collections import deque
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
from vqvae_speech_tpu_torch.models.clarinet.modules import check_compute_dtype
from vqvae_speech_tpu_torch.models.flowavenet import flowavenet_reverse
from vqvae_speech_tpu_torch.models.wavenet import (
    cast_floating,
    wavenet_incremental_generate,
)
from vqvae_speech_tpu_torch.models.wavenet.chunked import (
    admit_slot,
    decode_chunk,
    init_decode_slots,
    noise_width,
    slot_conditioning,
)
from vqvae_speech_tpu_torch.models.wavenet.incremental import (
    check_decode_options,
)
from vqvae_speech_tpu_torch.models.wavenet.mixture import (
    gumbel_noise,
    logistic_uniform,
)
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
    max_batch : streams per launch (any number: the kernel computes them in
        groups of 32, one launch a group).
    sample : categorical sampling (a ``torch.Generator`` seeded per launch)
        instead of greedy argmax.
    compute_dtype : None or torch.float32 (f32: the layer stack through the
        decode-step kernel on a GPU), or torch.bfloat16: the parameters cast
        to bf16 at load, the weight norm resolved after, the decode in bf16
        with f32 logits, layer by layer.
    weight_quant : None, "int8" (one scale an output channel) or
        "int8_block" (one a 128-input block and output): the JAX decode's
        weight-only int8 GLU stack, layer by layer.
    mesh : the tensor-parallel decode; not ported yet, anything but None
        raises.
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
        if mesh is not None:
            raise NotImplementedError(
                f"mesh={mesh!r}: the tensor-parallel decode is not ported "
                "to PyTorch yet")
        self._fused = compute_dtype != torch.bfloat16 and weight_quant is None
        check_decode_options(compute_dtype, weight_quant, self._fused)
        self._device = resolve_device(device)
        self._cfg = cfg
        self._buckets = tuple(sorted(int(b) for b in frame_buckets))
        self._max_batch = int(max_batch)
        self._sample = sample
        self._compute_dtype = compute_dtype
        self._weight_quant = weight_quant
        self.model = cast_floating(load_wavenet_params(WaveNet(cfg), params).to(
            self._device).eval(), compute_dtype)
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
            g=g, sample=self._sample, generator=gen,
            use_fused_stack=self._fused, compute_dtype=self._compute_dtype,
            weight_quant=self._weight_quant)

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
    compute_dtype : None or torch.float32 (f32), or torch.bfloat16, the JAX
        server's bf16 serving path: the vocoder's parameters are loaded in
        bf16 (cast before the weight norm is resolved, as JAX does) and the
        model runs in bf16; for iaf_student the teacher's mel upsampler
        stays f32 and only its output is cast. Noise is drawn in f32 and
        cast in the model; waves come back f32. Anything else raises.
    use_fused_chain : max_batch=1 only: run the vocoder's resblock chains
        through the fused chain (causal for iaf_student, non-causal for
        flowavenet): the hand-written CUDA kernel on a GPU (its bf16 form at
        bf16), every chain's weights bound to it once, at load (about twice
        the chains' weights of device memory more at f32, as much at
        bf16).
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
        check_compute_dtype(compute_dtype)
        self._device = resolve_device(device)
        self._kind = kind
        self._cfg = cfg
        self._teacher_cfg = teacher_cfg
        self._compute_dtype = compute_dtype
        load = dict(prepare_chains=use_fused_chain,
                    compute_dtype=compute_dtype)
        if kind == "flowavenet":
            self._params = load_flowavenet_params(params, cfg, self._device,
                                                  **load)
            scales = cfg.upsample_scales
        else:
            self._params = load_student_params(params, cfg, self._device,
                                               **load)
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
                                      compute_dtype=self._compute_dtype,
                                      use_fused=self._use_fused_chain)
        c_up = gaussian_wavenet_upsample(self._upsample, c, self._teacher_cfg)
        return wavenet_student_generate(self._params, self._cfg, z, c_up,
                                        compute_dtype=self._compute_dtype,
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


def _distribution(xs) -> Optional[dict]:
    if not xs:
        return None
    a = np.asarray(xs, np.float64)
    return {"mean": round(float(a.mean()), 2),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "max": float(a.max())}


class ContinuousSynthesisServer:
    """Continuous-batching AR synthesis over device-resident decode slots.

    ``slots`` decode streams live on the device; every launch advances all
    of them ``chunk_size`` samples (``chunked.decode_chunk``) and requests
    join and retire at chunk boundaries, so the batch stays full under
    mixed-length traffic and a queued request starts within one chunk
    instead of one utterance.

    Contracts (tests/test_torch_continuous_serve.py):

    * a greedy stream equals a standalone batch-1 greedy decode of the same
      request where the arithmetic agrees: conditioning is hoisted at
      admission at batch 1, as the standalone decode hoists it;
    * a request's stream, greedy or sampled, does not depend on what shares
      the pool or when it is admitted: every launch has the same
      (slots, chunk_size) shape, and a sampled stream reads only its own
      draws, made at admission from a ``torch.Generator`` seeded from
      (seed, request id) mixed by ``np.random.SeedSequence`` (or given:
      ``noise=`` / ``noises=``).

    Online API: ``submit()`` enqueues a request and returns its id,
    ``step()`` advances the pool one chunk and returns the ids that completed
    in it, ``collect()`` takes a finished result; ``run()`` is the offline
    drain built on them. ``stats`` has the JAX server's keys and values.

    params, cfg : a ``wavenet_init``-shaped numpy tree and its WaveNetConfig.
    max_frames : the longest admissible conditioning (frames); fixes the
        slots' conditioning buffer (slots, max_frames * upsample, L, G).
    compute_dtype, weight_quant : as ``BucketedSynthesisServer``'s. At f32
        every step's layer stack is one call of the decode-step kernel on a
        GPU (one launch a group of 32 slots); the bf16 and int8 decodes run
        layer by layer.
    device : where the model runs ("cuda", "cpu"); no default.
    """

    def __init__(self, params, cfg, *,
                 slots: int = 8,
                 chunk_size: int = 256,
                 max_frames: int = 40,
                 sample: bool = False,
                 compute_dtype=None,
                 weight_quant: Optional[str] = None,
                 device):
        fused = compute_dtype != torch.bfloat16 and weight_quant is None
        check_decode_options(compute_dtype, weight_quant, fused)
        self._device = resolve_device(device)
        self._cfg = cfg
        self._slots = int(slots)
        self._chunk = int(chunk_size)
        self._sample = bool(sample)
        self.model = cast_floating(load_wavenet_params(WaveNet(cfg), params).to(
            self._device).eval(), compute_dtype)
        self._upsample_factor = self.model.upsample_factor
        self._max_frames = int(max_frames)
        self._max_t = self._max_frames * self._upsample_factor
        self._prep, self._state = init_decode_slots(
            self.model, cfg, self._slots, self._max_t,
            weight_quant=weight_quant, use_fused_stack=fused)
        self._queue = deque()                # request ids awaiting a slot
        self._requests: Dict[int, dict] = {}
        self._results: Dict[int, SynthesisResult] = {}
        self._active: Dict[int, list] = {}   # slot -> [id, remaining, parts]
        self._next_id = 0
        self._launches = 0
        self._busy_steps = 0
        self._slot_steps = 0
        # per request, in chunks: submit -> completion, submit -> slot and
        # slot -> completion
        self._wait_chunks: List[int] = []
        self._admission_wait_chunks: List[int] = []
        self._decode_chunks: List[int] = []

    @property
    def pending(self) -> int:
        """Requests submitted but not yet completed."""
        return len(self._queue) + len(self._active)

    def _check_size(self, cond) -> None:
        if cond.shape[0] > self._max_frames:
            raise ValueError(f"conditioning of {cond.shape[0]} frames "
                             f"exceeds max_frames {self._max_frames}")

    def _noise(self, n: int, seed: int, rid: int, given) -> torch.Tensor:
        """A sampled request's draws (n, noise_width): ``given``, or drawn
        from a CPU generator seeded from (seed, rid)."""
        width = noise_width(self._cfg)
        if given is not None:
            return torch.from_numpy(np.array(given, np.float32))
        # the CPU generator keeps 32 bits of its seed: mix the pair into them
        mixed = np.random.SeedSequence([seed, rid]).generate_state(1)[0]
        gen = torch.Generator(device="cpu").manual_seed(int(mixed))
        if not self._cfg.scalar_input:
            return gumbel_noise((n, width), gen)
        return torch.cat([gumbel_noise((n, width - 1), gen),
                          logistic_uniform((n, 1), gen)], dim=1)

    def submit(self, cond, speaker_id: Optional[int] = None, seed: int = 0,
               noise=None) -> int:
        """Enqueue one request, (Tc, cin) local conditioning; returns its id.
        Its stream depends only on (params, cond, speaker_id, seed, id), or
        on ``noise`` in place of the seeded draws of a sampled stream:
        (Tc * upsample, noise_width) Gumbel draws (the categorical output)
        or [Gumbel | u] (the mixture)."""
        self._check_size(cond)
        if seed < 0:
            raise ValueError(f"seed {seed} is negative")
        want = (cond.shape[0] * self._upsample_factor, noise_width(self._cfg))
        if noise is not None and np.shape(noise) != want:
            raise ValueError(f"noise of shape {np.shape(noise)}; the request "
                             f"needs {want}")
        rid = self._next_id
        self._next_id += 1
        self._requests[rid] = dict(cond=cond, speaker_id=speaker_id,
                                   seed=seed, noise=noise,
                                   submitted=self._launches)
        self._queue.append(rid)
        return rid

    def _admit(self, slot: int, rid: int) -> None:
        req = self._requests[rid]
        cond = req["cond"]
        n = cond.shape[0] * self._upsample_factor
        # zero-padded to the slots' capacity: every admission has one shape
        with torch.inference_mode():
            c = torch.zeros((self._max_frames, cond.shape[-1]),
                            dtype=torch.float32, device=self._device)
            c[:cond.shape[0]] = torch.as_tensor(cond, dtype=torch.float32,
                                                device=self._device)
        rows = slot_conditioning(self.model, self._cfg, c, req["speaker_id"],
                                 self._max_t)
        noise = None
        if self._sample:
            noise = self._noise(n, req["seed"], rid, req["noise"])
        req["admitted"] = self._launches
        admit_slot(self._prep, self._state, slot, rows, noise)
        self._active[slot] = [rid, n, []]

    def step(self) -> List[int]:
        """Admit queued requests into free slots, advance every slot one
        chunk, and return the ids of requests that completed in it."""
        if not self._queue and not self._active:
            return []
        if not self._active:
            # pool drained: rewind the shared clock (a busy pool only
            # advances it while streams are in flight)
            self._state["g"] = 0
            with torch.inference_mode():
                self._state["start"].zero_()
        for s in range(self._slots):
            if s not in self._active and self._queue:
                self._admit(s, self._queue.popleft())
        self._state, emitted = decode_chunk(
            self._prep, self._state, self._cfg, self._chunk,
            sample=self._sample)
        emitted = emitted.cpu().numpy()
        self._launches += 1
        self._slot_steps += self._slots * self._chunk
        done = []
        for s in list(self._active):
            rid, remaining, parts = self._active[s]
            take = min(remaining, self._chunk)
            parts.append(emitted[s, :take])
            self._busy_steps += take
            if remaining > self._chunk:
                self._active[s][1] = remaining - take
                continue
            req = self._requests.pop(rid)
            self._results[rid] = SynthesisResult(wave=np.concatenate(parts),
                                                 bucket=self._max_frames)
            self._wait_chunks.append(self._launches - req["submitted"])
            self._admission_wait_chunks.append(req["admitted"]
                                               - req["submitted"])
            self._decode_chunks.append(self._launches - req["admitted"])
            del self._active[s]
            done.append(rid)
        return done

    def collect(self, request_id: int) -> Optional[SynthesisResult]:
        """Take a completed request's result (once), or None while it is in
        flight."""
        return self._results.pop(request_id, None)

    def run(self, conds: Sequence, speaker_ids: Optional[Sequence[int]] = None,
            seed: int = 0, noises: Optional[Sequence] = None
            ) -> List[SynthesisResult]:
        """Offline drain: submit everything, step until empty. conds:
        per-request (Tc, cin) local conditioning; ``noises``: optionally one
        array a request, as ``submit``'s ``noise``. Returns trimmed waves
        (int32 bins, or f32 samples for the scalar input) in order."""
        for c in conds:                 # validate before enqueuing any
            self._check_size(c)
        if noises is not None and len(noises) != len(conds):
            raise ValueError(f"{len(noises)} noises for {len(conds)} requests")
        ids = [self.submit(c, None if speaker_ids is None else speaker_ids[i],
                           seed, None if noises is None else noises[i])
               for i, c in enumerate(conds)]
        while self.pending:
            self.step()
        return [self.collect(rid) for rid in ids]  # type: ignore[misc]

    @property
    def stats(self) -> dict:
        util = (self._busy_steps / self._slot_steps
                if self._slot_steps else 0.0)
        waits = self._wait_chunks
        return {"launches": self._launches, "slots": self._slots,
                "chunk_size": self._chunk,
                "slot_utilization": round(util, 4),
                "mean_latency_chunks": (round(sum(waits) / len(waits), 2)
                                        if waits else 0.0),
                "latency_chunks": _distribution(self._wait_chunks),
                "admission_wait_chunks": _distribution(
                    self._admission_wait_chunks),
                "decode_chunks": _distribution(self._decode_chunks),
                "upsample_factor": self._upsample_factor}
