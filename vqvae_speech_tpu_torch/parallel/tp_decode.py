"""Tensor-parallel (channel-sharded) autoregressive WaveNet decode.

Counterpart of ``vqvae_speech_tpu/parallel/tp_decode.py``. A single stream's
AR decode streams the whole GLU layer stack from memory every step; this
module shards the stack over the mesh's ``model`` axis, so that each rank
streams 1/m of it a step:

* the gate columns are permuted once to ``[a_0 b_0 | a_1 b_1 | ...]``, so
  rank i's contiguous block of gate/m columns holds the i-th slice of BOTH
  GLU halves and the gate needs no communication,
* the rows of ``wskip`` and ``wout`` (indexed by h = tanh(a) * sigmoid(b))
  shard with them; their products are partial sums,
* per layer ONE all-reduce of the (B, C_res) output partial (the next layer
  reads it); per step ONE all-reduce of the skip partials, each layer's
  with the legacy sqrt(1/2) powers folded in before the sum (the skip path
  is linear in them), and the skip biases added after it,
* the carried sample, the history ring, the first and last convs and the
  emission are replicated: the all-reduces keep them equal on every rank.

``weight_quant="int8"`` composes as in the JAX package: the stack is
quantized before it is sharded, with one scale an output channel, so the
tap scales shard with the gate columns and the skip and output scales
(per output) are every rank's.

The decode is the per-layer path (``models/wavenet/incremental.py``'s
``_gate`` and ``_project``), plain PyTorch as the JAX version is plain jnp:
the decode-step kernel fuses all L layers into one launch and has no place
for a collective between them.
"""
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vqvae_speech_tpu_torch.models.clarinet.modules import scaled, sigmoid
from vqvae_speech_tpu_torch.models.wavenet.incremental import (
    _gate,
    _project,
    first_input,
    hoist_conditioning,
    init_buffers,
    output_head,
    prepare_decode_weights,
    tap_lags,
)
from vqvae_speech_tpu_torch.models.wavenet.mixture import (
    sample_from_discretized_mix_logistic,
)
from vqvae_speech_tpu_torch.models.wavenet.model import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.parallel.mesh import axis_rank, axis_size

_SQRT_HALF = math.sqrt(0.5)


def _gate_permutation(gate: int, m: int) -> torch.Tensor:
    """Column order [a_0 b_0 | a_1 b_1 | ...]: rank i's contiguous block of
    gate/m columns holds the i-th slice of both GLU halves."""
    half = gate // 2
    h = half // m
    order = []
    for i in range(m):
        order.extend(range(i * h, (i + 1) * h))                   # a_i
        order.extend(range(half + i * h, half + (i + 1) * h))     # b_i
    return torch.tensor(order, dtype=torch.long)


def _skip_scales(cfg: WaveNetConfig):
    """Layer l's factor on its skip: under ``legacy`` the running sum is
    scaled by sqrt(1/2) after every layer but the first, so skip l carries
    q^(L-l) for l >= 1 and skip 0 q^(L-1); f32 powers, as JAX takes them."""
    if not cfg.legacy:
        return [1.0] * cfg.layers
    q = np.float32(_SQRT_HALF)
    return [float(q ** (max(cfg.layers - l, 1) if l else cfg.layers - 1))
            for l in range(cfg.layers)]


def prepare_tp_decode(module: WaveNet, cfg: WaveNetConfig, mesh,
                      weight_quant: Optional[str] = None,
                      axis: str = "model"):
    """Prepare the decode once: resolve (and with ``weight_quant="int8"``
    quantize) the layer stack, permute its gate columns and keep this rank's
    shard. Returns ``generate(T, c=None, g=None, sample=False,
    generator=None) -> (outputs (B, T, out_channels) f32, emitted (B, T))``,
    the same on every rank of ``axis``; ``c`` (B, Tc, cin) and ``g`` (B,)
    are every rank's. Sampling draws from ``generator``, which every rank
    must seed alike: the draws are then the same on every rank.

    Needs ``gate_channels % (2 * m) == 0`` for an axis of m ranks."""
    if weight_quant not in (None, "int8"):
        raise ValueError(f"weight_quant={weight_quant!r}: the tensor-parallel "
                         "decode takes None or 'int8'")
    m, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    gate = cfg.gate_channels
    if gate % (2 * m):
        raise ValueError(f"gate_channels {gate} does not shard over the "
                         f"{axis} axis of {m} ranks (needs a multiple of "
                         f"{2 * m})")
    w = prepare_decode_weights(module, cfg, weight_quant)
    dev = w["bias"].device
    cols = _gate_permutation(gate, m).to(dev)[r * gate // m:
                                              (r + 1) * gate // m]
    rows = slice(r * gate // (2 * m), (r + 1) * gate // (2 * m))
    shard = {"wtap": w["wtap"][..., cols].contiguous(),
             "bias": w["bias"][:, cols].contiguous(),
             "wskip": w["wskip"][:, rows].contiguous(),
             "wout": w["wout"][:, rows].contiguous()}
    if weight_quant == "int8":
        shard["wtap_scale"] = w["wtap_scale"][..., cols].contiguous()
        shard["wskip_scale"] = w["wskip_scale"]
        shard["wout_scale"] = w["wout_scale"]
    skip_scales = _skip_scales(cfg)
    bias_total = sum(w["bskip"][l] * skip_scales[l]
                     for l in range(cfg.layers))
    # a one-rank axis still takes its all-reduces (the path the ranks of a
    # wider axis take); without a mesh there are none
    group = None if mesh is None else mesh.get_group(axis)
    k = cfg.kernel_size
    lags = tap_lags(cfg)

    def psum(t):
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    @torch.inference_mode()
    def generate(T: int, c=None, g=None, sample: bool = False,
                 generator: Optional[torch.Generator] = None):
        if sample and generator is None:
            raise ValueError("sample=True needs a torch.Generator")
        if c is not None:
            c = torch.as_tensor(c, device=dev, dtype=torch.float32)
            B = c.shape[0]
            if cfg.upsample_conditional_features:
                c = module.upsample_lc(c)
            if c.shape[1] < T:
                raise ValueError(f"conditioning of {c.shape[1]} samples is "
                                 f"shorter than the {T} steps to generate")
            c = c[:, :T]
        else:
            B = 1
        if g is not None:
            g = torch.as_tensor(g, device=dev)
        cond = hoist_conditioning(module, cfg, c, g, B, T)  # (T, L, B, G)
        if cond is not None:
            cond = cond[..., cols].contiguous()
        ring = init_buffers(cfg, B, dev)
        cap = ring.shape[1]
        outs = torch.empty((T, B, cfg.out_channels), device=dev)
        emitted = torch.empty((T, B), device=dev, dtype=(
            torch.float32 if cfg.scalar_input else torch.int32))
        x = first_input(cfg, B, dev, torch.float32) @ w["w_first"] \
            + w["b_first"]
        for t in range(T):
            skips = torch.zeros((B, cfg.skip_out_channels), device=dev)
            for l in range(cfg.layers):
                taps = [ring[l, (t - lag) % cap] if t >= lag else None
                        for lag in lags[l]]
                acc = _gate(shard, l, x, taps, k) + shard["bias"][l]
                if cond is not None:
                    acc = acc + cond[t, l]
                a, b = acc.chunk(2, dim=-1)
                h = torch.tanh(a) * sigmoid(b)
                skips = skips + _project(shard, l, h, "wskip") * skip_scales[l]
                out = psum(_project(shard, l, h, "wout")) + w["bout"][l]
                ring[l, t % cap] = x
                x = scaled(out + x, _SQRT_HALF)
            out = output_head(w, psum(skips) + bias_total)
            outs[t] = out
            if cfg.scalar_input:
                nxt = (sample_from_discretized_mix_logistic(
                    out[:, None, :], generator=generator)[:, 0] if sample
                    else out[:, 0])
                emitted[t] = nxt
                x = nxt[:, None] @ w["w_first"] + w["b_first"]
                continue
            if sample:
                noise = torch.empty_like(out).exponential_(generator=generator)
                idx = torch.argmax(out - noise.log(), dim=-1)
            else:
                idx = torch.argmax(out, dim=-1)
            emitted[t] = idx
            x = F.one_hot(idx, cfg.out_channels).float() @ w["w_first"] \
                + w["b_first"]
        return outs.transpose(0, 1), emitted.transpose(0, 1)

    return generate


def wavenet_incremental_generate_tp(module: WaveNet, cfg: WaveNetConfig,
                                    T: int, mesh, c=None, g=None,
                                    sample: bool = False, generator=None,
                                    weight_quant: Optional[str] = None,
                                    axis: str = "model"):
    """One-shot ``prepare_tp_decode`` then ``generate`` (a server prepares
    once and generates per launch)."""
    return prepare_tp_decode(module, cfg, mesh, weight_quant, axis)(
        T, c=c, g=g, sample=sample, generator=generator)
