"""Autoregressive WaveNet decode, one sample per step, f32.

Counterpart of ``vqvae_speech_tpu/models/wavenet/incremental.py``. The JAX
package runs the whole generation as one ``lax.scan``; here it is a Python
loop over T steps that keeps everything on the device: no ``.item()``, no
host sync, emitted bins accumulate in a device tensor and come back in one
copy at the end. Per step:

* the first 1x1 conv of the previous sample's one-hot (a row gather of its
  weight, which equals the one-hot matmul exactly),
* the layer stack: with ``use_fused_stack`` ONE call of the step that
  ``ops.prepare_glu_stack_step`` bound to the weights before the loop (the
  hand-written CUDA kernel for CUDA tensors, one launch; its checks, plan and
  buffers are made once a decode), else ``step_layer`` per layer (the JAX
  package's ``use_fused_stack=False`` path),
* ReLU -> 1x1 -> ReLU -> 1x1 to the logits, then argmax (greedy) or a
  categorical draw by the Gumbel-max trick with noise from an explicit
  ``torch.Generator`` on the model's device.

History: one ring buffer (L, cap, B, C) for all layers, cap = the largest
lag (k-1) * max dilation; slot ``t mod cap`` holds a layer's input at time
t. A tap of lag <= cap at ``t - lag < 0`` lands on a slot not yet written,
which is still zero, so zero history needs no mask in the fused path. A
step's taps are ONE gather with precomputed slot indices and its
write-back ONE slice copy.

Conditioning is hoisted out of the loop: every layer's local + global
projection for all T steps is computed once into a (T, L, B, G) tensor, so
a step's (L, B, G) slice is contiguous and read in place.

Not ported yet: ``compute_dtype`` (bf16), ``weight_quant`` (int8) and the
``scalar_input`` (mixture-of-logistics) branch; each raises
NotImplementedError.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.models.wavenet.model import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.ops.wavenet_step import prepare_glu_stack_step

_SQRT_HALF = math.sqrt(0.5)


def _lags(cfg: WaveNetConfig):
    """(L, k-1) lags: tap j of layer l reads x[t - (k-1-j) * d_l]."""
    k = cfg.kernel_size
    return [[(k - 1 - j) * cfg.dilation(l) for j in range(k - 1)]
            for l in range(cfg.layers)]


def init_buffers(cfg: WaveNetConfig, B: int, device) -> torch.Tensor:
    """The zeroed f32 (L, cap, B, C) history ring, cap = the largest lag."""
    cap = max([1] + [lag for row in _lags(cfg) for lag in row])
    return torch.zeros((cfg.layers, cap, B, cfg.residual_channels),
                       dtype=torch.float32, device=device)


def hoist_conditioning(module: WaveNet, cfg: WaveNetConfig, c, g, B: int,
                       T: int) -> Optional[torch.Tensor]:
    """Every layer's pre-projected local + global conditioning for all T
    steps, as one (T, L, B, G) tensor (zero for a layer without any), or
    None when no layer is conditioned. ``c`` is already upsampled and
    trimmed to (B, T, cin)."""
    g_b = module.expand_global(g, B)
    c_tb = None if c is None else c.transpose(0, 1).contiguous()  # (T, B, cin)
    cond = None
    for l, layer in enumerate(module.conv_layers):
        ct = None
        if c_tb is not None and layer.conv1x1c is not None:
            w = layer.conv1x1c.resolved_weight()[:, :, 0]     # (G, cin)
            ct = c_tb @ w.t() + layer.conv1x1c.bias           # (T, B, G)
        if g_b is not None and layer.conv1x1g is not None:
            gh = layer.conv1x1g(g_b)[:, :, 0]                 # (B, G)
            ct = gh if ct is None else gh + ct
        if ct is None:
            continue
        if cond is None:
            cond = torch.zeros((T, cfg.layers, B, cfg.gate_channels),
                               dtype=ct.dtype, device=ct.device)
        cond[:, l] = ct
    return cond


def prepare_decode_weights(module: WaveNet, cfg: WaveNetConfig,
                           weight_quant=None) -> dict:
    """Resolve every weight-norm kernel once, in the JAX (in, out) layout,
    with the layer stack stacked as ``glu_stack_step`` takes it: wtap (L, k, C, G),
    bias (L, G), wskip (L, G/2, S), bskip (L, S), wout (L, G/2, C),
    bout (L, C)."""
    if weight_quant is not None:
        raise NotImplementedError(
            f"weight_quant={weight_quant!r} is not ported to PyTorch yet")

    def mat(conv):  # 1x1 conv -> (in, out)
        return conv.resolved_weight()[:, :, 0].t().contiguous()

    layers = module.conv_layers
    return {
        "w_first": mat(module.first_conv), "b_first": module.first_conv.bias,
        "w_last1": mat(module.last_conv_1), "b_last1": module.last_conv_1.bias,
        "w_last2": mat(module.last_conv_2), "b_last2": module.last_conv_2.bias,
        "wtap": torch.stack([m.conv.resolved_weight().permute(2, 1, 0)
                             for m in layers]).contiguous(),
        "bias": torch.stack([m.conv.bias for m in layers]),
        "wskip": torch.stack([mat(m.conv1x1_skip) for m in layers]),
        "bskip": torch.stack([m.conv1x1_skip.bias for m in layers]),
        "wout": torch.stack([mat(m.conv1x1_out) for m in layers]),
        "bout": torch.stack([m.conv1x1_out.bias for m in layers]),
    }


def step_layer(w: dict, l: int, x_t, ring, t: int, cond_t,
               cfg: WaveNetConfig):
    """Layer l at step t, the plain per-layer path (``_step_layer``):
    x_t (B, C) -> (out (B, C), skip (B, S)); writes x_t into the ring."""
    k, d = cfg.kernel_size, cfg.dilation(l)
    cap = ring.shape[1]
    acc = x_t @ w["wtap"][l, k - 1]
    for j in range(k - 1):
        lag = (k - 1 - j) * d
        if t >= lag:  # zero history before generation started
            acc = acc + ring[l, (t - lag) % cap] @ w["wtap"][l, j]
    acc = acc + w["bias"][l]
    if cond_t is not None:
        acc = acc + cond_t[l]
    a, b = acc.chunk(2, dim=-1)
    h = torch.tanh(a) * torch.sigmoid(b)
    skip = h @ w["wskip"][l] + w["bskip"][l]
    out = h @ w["wout"][l] + w["bout"][l]
    ring[l, t % cap] = x_t
    return (out + x_t) * _SQRT_HALF, skip


@torch.inference_mode()
def wavenet_incremental_generate(module: WaveNet, cfg: WaveNetConfig, T: int,
                                 c=None, g=None, initial_input=None,
                                 sample: bool = True,
                                 generator: Optional[torch.Generator] = None,
                                 use_fused_stack: bool = False,
                                 compute_dtype=None, weight_quant=None):
    """Generate T samples autoregressively on the module's device.

    c: (B, Tc, cin) local conditioning (upsampled here when configured);
    g: (B,) speaker ids; initial_input: (B, out_channels) first input
    (default the one-hot of mu-law bin 127). Returns (outputs (B, T,
    out_channels) f32 logits, emitted (B, T) int32 bins), both on the
    module's device.
    """
    if compute_dtype is not None:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r} is not ported to PyTorch yet")
    if cfg.scalar_input:
        raise NotImplementedError(
            "scalar_input (mixture-of-logistics) decode is not ported yet")
    if sample and generator is None:
        raise ValueError("sample=True needs a torch.Generator")
    w = prepare_decode_weights(module, cfg, weight_quant)
    dev = w["w_first"].device
    if c is not None:
        c = torch.as_tensor(c, dtype=torch.float32, device=dev)
        B = c.shape[0]
        if cfg.upsample_conditional_features:
            c = module.upsample_lc(c)
        if c.shape[1] < T:
            raise ValueError(f"conditioning of {c.shape[1]} samples is "
                             f"shorter than the {T} steps to generate")
        c = c[:, :T]
    else:
        B = 1 if initial_input is None else initial_input.shape[0]
    if g is not None:
        g = torch.as_tensor(g, device=dev)
    cond = hoist_conditioning(module, cfg, c, g, B, T)   # (T, L, B, G)

    if initial_input is None:
        x_in = torch.zeros((B, cfg.out_channels), device=dev)
        # mu-law mid bin (reference wavenet.py:345-348); with fewer than 128
        # bins JAX drops the out-of-range write and starts from zeros
        if cfg.out_channels > 127:
            x_in[:, 127] = 1.0
    else:
        x_in = torch.as_tensor(initial_input, dtype=torch.float32,
                               device=dev).reshape(B, cfg.out_channels)

    ring = init_buffers(cfg, B, dev)
    cap = ring.shape[1]
    lags = torch.tensor(_lags(cfg), dtype=torch.long,
                        device=dev).reshape(cfg.layers, -1)
    # every step's tap slots at once: (T, L, k-1)
    slots = (torch.arange(T, device=dev)[:, None, None] - lags) % cap
    layer_idx = torch.arange(cfg.layers, device=dev)[:, None]
    zero_cond = torch.zeros((cfg.layers, B, cfg.gate_channels), device=dev)

    stack_step = None
    if use_fused_stack:
        stack_step = prepare_glu_stack_step(
            w["wtap"], w["bias"], w["wskip"], w["bskip"], w["wout"],
            w["bout"], batch=B, legacy=cfg.legacy)

    outs = torch.empty((T, B, cfg.out_channels), device=dev)
    emitted = torch.empty((T, B), dtype=torch.int32, device=dev)
    x = x_in @ w["w_first"] + w["b_first"]
    for t in range(T):
        cond_t = None if cond is None else cond[t]
        if use_fused_stack:
            taps = ring[layer_idx, slots[t]]                 # (L, k-1, B, C)
            # On the card the step's three outputs are buffers it reuses:
            # x_all is copied into the ring here, skips feeds the head below
            # and x is replaced by the next sample's first conv, all enqueued
            # on this stream before the next step overwrites them.
            x, skips, x_all = stack_step(
                x, taps, zero_cond if cond_t is None else cond_t)
            ring[:, t % cap] = x_all
        else:
            skips = None
            for l in range(cfg.layers):
                x, h = step_layer(w, l, x, ring, t, cond_t, cfg)
                if skips is None:
                    skips = h
                else:
                    skips = skips + h
                    if cfg.legacy:
                        skips = skips * _SQRT_HALF
        out = F.relu(skips)
        out = F.relu(out @ w["w_last1"] + w["b_last1"])
        out = out @ w["w_last2"] + w["b_last2"]
        outs[t] = out
        if sample:
            # Gumbel-max: argmax(logits + Gumbel) is a categorical draw
            noise = torch.empty_like(out).exponential_(generator=generator)
            idx = torch.argmax(out - noise.log(), dim=-1)
        else:
            idx = torch.argmax(out, dim=-1)
        emitted[t] = idx
        # the next input is one_hot(idx): its first conv is a row gather
        x = w["w_first"][idx] + w["b_first"]
    return outs.transpose(0, 1), emitted.transpose(0, 1)
