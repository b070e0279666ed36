"""Autoregressive WaveNet decode, one sample per step.

Counterpart of ``vqvae_speech_tpu/models/wavenet/incremental.py``. The JAX
package runs the whole generation as one ``lax.scan``; here it is a Python
loop over T steps that keeps everything on the device: no ``.item()``, no
host sync, emitted samples accumulate in a device tensor and come back in
one copy at the end. Per step:

* the first 1x1 conv of the previous sample: a row gather of its weight for
  the one-hot input (which equals the one-hot matmul exactly), a real
  (B, 1) @ (1, C) product for the scalar input,
* the layer stack: with ``use_fused_stack`` ONE call of the step that
  ``ops.prepare_glu_stack_step`` bound to the weights before the loop (the
  hand-written CUDA kernel for CUDA tensors, one launch; its checks, plan and
  buffers are made once a decode), else ``step_layer`` per layer (the JAX
  package's scan body),
* ReLU -> 1x1 -> ReLU -> 1x1 to the logits (f32 whatever the compute
  dtype), then for the categorical output argmax (greedy) or a Gumbel-max
  draw, and for the scalar input (mixture of logistics) the first channel
  unclipped (greedy, as JAX emits it) or a draw of ``mixture.py``'s sampler;
  the noise comes from an explicit ``torch.Generator`` on the model's device.

The JAX decode's other configurations run the per-layer path, as the JAX
package runs them through its scan and never through its kernel:

* ``compute_dtype=torch.bfloat16``: the parameters are cast first and the
  weight norm resolved after (``cast_floating``); activations, ring and
  conditioning are bf16, the logits f32.
* ``weight_quant="int8"``: weight-only int8 with one absmax scale an output
  channel over all taps (the taps' products are summed first, then scaled);
  ``"int8_block"``: one scale a (tap, 128-input block, output), the block
  products summed in f32 over the blocks (``_block_matmul``).

The kernel is f32 only: ``use_fused_stack`` with either of them raises.

History: one ring buffer (L, cap, B, C) for all layers, cap = the largest
lag (k-1) * max dilation; slot ``t mod cap`` holds a layer's input at time
t. A tap of lag <= cap at ``t - lag < 0`` lands on a slot not yet written,
which is still zero, so zero history needs no mask in the fused path. A
step's taps are ONE gather with precomputed slot indices and its
write-back ONE slice copy.

Conditioning is hoisted out of the loop: every layer's local + global
projection for all T steps is computed once into a (T, L, B, G) tensor, so
a step's (L, B, G) slice is contiguous and read in place.
"""
import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.models.clarinet.modules import (
    check_compute_dtype,
    scaled,
    sigmoid,
)
from vqvae_speech_tpu_torch.models.wavenet.mixture import (
    sample_from_discretized_mix_logistic,
)
from vqvae_speech_tpu_torch.models.wavenet.model import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.ops.wavenet_step import prepare_glu_stack_step

_SQRT_HALF = math.sqrt(0.5)
WEIGHT_QUANTS = (None, "int8", "int8_block")
INT8_BLOCK = 128  # input rows a scale covers in "int8_block"


def check_decode_options(compute_dtype, weight_quant, use_fused_stack):
    """Raises ValueError for a compute dtype or weight quantization the
    decode does not take, or one that the f32-only kernel cannot run."""
    check_compute_dtype(compute_dtype)
    if weight_quant not in WEIGHT_QUANTS:
        raise ValueError(f"weight_quant={weight_quant!r}: takes one of "
                         f"{WEIGHT_QUANTS}")
    if use_fused_stack and (compute_dtype == torch.bfloat16
                            or weight_quant is not None):
        raise ValueError(
            "use_fused_stack runs the f32 decode-step kernel: it takes "
            f"neither compute_dtype={compute_dtype!r} nor "
            f"weight_quant={weight_quant!r} (those decode layer by layer)")


def cast_floating(module: WaveNet, compute_dtype) -> WaveNet:
    """``module`` itself when ``compute_dtype`` is None or already its
    parameters' dtype, else a copy with every floating parameter cast to it
    (the weight norm is resolved after the cast, as JAX resolves it)."""
    if compute_dtype is None or all(
            p.dtype == compute_dtype for p in module.parameters()
            if p.is_floating_point()):
        return module
    return copy.deepcopy(module).to(compute_dtype)


def tap_lags(cfg: WaveNetConfig):
    """(L, k-1) lags: tap j of layer l reads x[t - (k-1-j) * d_l]."""
    k = cfg.kernel_size
    return [[(k - 1 - j) * cfg.dilation(l) for j in range(k - 1)]
            for l in range(cfg.layers)]


def ring_capacity(cfg: WaveNetConfig) -> int:
    """The history ring's slots: the largest lag (at least 1)."""
    return max([1] + [lag for row in tap_lags(cfg) for lag in row])


def init_buffers(cfg: WaveNetConfig, B: int, device,
                 dtype=torch.float32) -> torch.Tensor:
    """The zeroed (L, cap, B, C) history ring, cap = the largest lag."""
    return torch.zeros((cfg.layers, ring_capacity(cfg), B,
                        cfg.residual_channels), dtype=dtype, device=device)


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


def _quantize_int8(w, dims):
    """Weight-only int8 with absmax scales over ``dims`` (one an output
    channel): w == w_i8 * scale, scale (1, out) f32."""
    absmax = w.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    w_i8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_i8, scale.reshape(1, -1).float()


def _quantize_int8_block(w):
    """Blockwise int8 on the last two axes of ``w`` (..., C, G): one absmax
    scale a (block of INT8_BLOCK input rows, output), one block when C is
    not a multiple of it. Returns (w_i8 in w's layout, scales (..., nb, G)
    f32)."""
    C = w.shape[-2]
    block = INT8_BLOCK if C % INT8_BLOCK == 0 else C
    nb = C // block
    wb = w.reshape(*w.shape[:-2], nb, block, w.shape[-1])
    absmax = wb.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    w_i8 = torch.clamp(torch.round(wb / scale), -127, 127).to(torch.int8)
    return w_i8.reshape(w.shape), scale.squeeze(-2).float()


def _block_matmul(x, w, scale, out_dtype):
    """x (B, C) @ a blockwise-quantized w (C, G) held as its int8 values:
    one f32 product a block, times the block's (G,) scale row, summed over
    the blocks."""
    B, C = x.shape
    nb = scale.shape[0]
    xb = x.reshape(B, nb, C // nb).transpose(0, 1).float()   # (nb, B, blk)
    partial = torch.bmm(xb, w.reshape(nb, C // nb, -1).float())
    return (partial * scale[:, None, :]).sum(0).to(out_dtype)


def _quantized(w, weight_quant, dims):
    """(int8 weight, its scales as the decode reads them)."""
    if weight_quant == "int8":
        return _quantize_int8(w, dims)
    return _quantize_int8_block(w)


def prepare_decode_weights(module: WaveNet, cfg: WaveNetConfig,
                           weight_quant=None) -> dict:
    """Resolve every weight-norm kernel once, in the JAX (in, out) layout
    and the module's dtype, with the layer stack stacked as
    ``glu_stack_step`` takes it: wtap (L, k, C, G), bias (L, G), wskip
    (L, G/2, S), bskip (L, S), wout (L, G/2, C), bout (L, C).

    With ``weight_quant`` the three stacked matrices are quantized layer by
    layer as JAX's ``prepare_decode_weights`` does: ``<name>_int8`` holds
    the int8 weights, ``<name>`` their values in the compute dtype (exact;
    what JAX's ``astype`` makes at every use, made once here) and
    ``<name>_scale`` (L, 1, out) or ``<name>_bscale`` (L, [k,] nb, out) the
    f32 scales."""
    if weight_quant not in WEIGHT_QUANTS:
        raise ValueError(f"weight_quant={weight_quant!r}: takes one of "
                         f"{WEIGHT_QUANTS}")

    def mat(conv):  # 1x1 conv -> (in, out)
        return conv.resolved_weight()[:, :, 0].t().contiguous()

    layers = module.conv_layers
    prep = {
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
    if weight_quant is not None:
        suffix = "_scale" if weight_quant == "int8" else "_bscale"
        # per-output scales: the conv's over (tap, input), a projection's
        # over its input
        for name, dims in (("wtap", (0, 1)), ("wskip", (0,)),
                           ("wout", (0,))):
            pairs = [_quantized(w, weight_quant, dims) for w in prep[name]]
            w_i8 = torch.stack([p[0] for p in pairs])
            prep[name + "_int8"] = w_i8
            prep[name + suffix] = torch.stack([p[1] for p in pairs])
            prep[name] = w_i8.to(prep["bias"].dtype)
    return prep


def _gate(w: dict, l: int, x, taps, k: int):
    """Layer l's dilated conv at one step: x @ wtap[l, k-1] + taps[j] @
    wtap[l, j] in that order, dequantized as JAX's ``_step_layer`` does (a
    None tap is zero history and adds nothing)."""
    wl = w["wtap"][l]
    bscale = w.get("wtap_bscale")

    def mm(v, j):
        if bscale is not None:
            return _block_matmul(v, wl[j], bscale[l, j], v.dtype)
        return v @ wl[j]

    acc = mm(x, k - 1)
    for j, tap in enumerate(taps):
        if tap is not None:
            acc = acc + mm(tap, j)
    if "wtap_scale" in w:
        acc = (acc * w["wtap_scale"][l]).to(x.dtype)
    return acc


def _project(w: dict, l: int, h, name: str):
    """h @ w[name][l], dequantized as JAX's ``_mm`` does: an int8 product
    in f32, then its per-output scale."""
    m = w[name][l]
    if name + "_bscale" in w:
        return _block_matmul(h, m, w[name + "_bscale"][l], h.dtype)
    if name + "_scale" in w:
        return ((h.float() @ m.float()) * w[name + "_scale"][l]).to(h.dtype)
    return h @ m


def layer_step(w: dict, l: int, x, taps, cond_l, cfg: WaveNetConfig):
    """Gated layer l at one step on history ``taps`` ((k-1) tensors (B, C),
    None where there is no history yet): x (B, C) -> (out (B, C), skip
    (B, S))."""
    acc = _gate(w, l, x, taps, cfg.kernel_size) + w["bias"][l]
    if cond_l is not None:
        acc = acc + cond_l
    a, b = acc.chunk(2, dim=-1)
    h = torch.tanh(a) * sigmoid(b)
    skip = _project(w, l, h, "wskip") + w["bskip"][l]
    out = _project(w, l, h, "wout") + w["bout"][l]
    return scaled(out + x, _SQRT_HALF), skip


def step_layer(w: dict, l: int, x_t, ring, t: int, cond_t,
               cfg: WaveNetConfig):
    """Layer l at step t, the plain per-layer path (``_step_layer``):
    x_t (B, C) -> (out (B, C), skip (B, S)); writes x_t into the ring."""
    k, d = cfg.kernel_size, cfg.dilation(l)
    cap = ring.shape[1]
    lags = [(k - 1 - j) * d for j in range(k - 1)]
    # zero history before generation started
    taps = [ring[l, (t - lag) % cap] if t >= lag else None for lag in lags]
    out = layer_step(w, l, x_t, taps, None if cond_t is None else cond_t[l],
                     cfg)
    ring[l, t % cap] = x_t
    return out


def add_skip(skips, s, legacy: bool):
    """The skip sum: the reference's progressive sqrt(1/2) scaling after
    the first layer under ``legacy``."""
    if skips is None:
        return s
    return scaled(skips + s, _SQRT_HALF) if legacy else skips + s


def output_head(w: dict, skips):
    """ReLU -> 1x1 -> ReLU -> 1x1: the logits, f32 whatever the compute
    dtype (the JAX decode casts them for stable sampling)."""
    out = F.relu(skips)
    out = F.relu(out @ w["w_last1"] + w["b_last1"])
    return (out @ w["w_last2"] + w["b_last2"]).float()


def first_input(cfg: WaveNetConfig, B: int, device, dtype,
                  given=None) -> torch.Tensor:
    """The first step's input (B, in_ch): ``given``, else the one-hot of
    mu-law bin 127 (all zeros with fewer than 128 bins: JAX drops the
    out-of-range write), or zero for the scalar input."""
    in_ch = 1 if cfg.scalar_input else cfg.out_channels
    if given is not None:
        given = torch.as_tensor(given, device=device)
        if given.numel() != B * in_ch:
            raise ValueError(f"initial_input has shape {tuple(given.shape)}; "
                             f"the decode takes ({B}, {in_ch})")
        return given.reshape(B, in_ch).to(dtype)
    x_in = torch.zeros((B, in_ch), dtype=dtype, device=device)
    # mu-law mid bin (reference wavenet.py:345-348)
    if not cfg.scalar_input and cfg.out_channels > 127:
        x_in[:, 127] = 1.0
    return x_in


@torch.inference_mode()
def wavenet_incremental_generate(module: WaveNet, cfg: WaveNetConfig, T: int,
                                 c=None, g=None, initial_input=None,
                                 sample: bool = True,
                                 generator: Optional[torch.Generator] = None,
                                 log_scale_min: float = -50.0,
                                 use_fused_stack: bool = False,
                                 compute_dtype=None, weight_quant=None):
    """Generate T samples autoregressively on the module's device.

    c: (B, Tc, cin) local conditioning (upsampled here when configured);
    g: (B,) speaker ids; initial_input: (B, in_ch) first input (default the
    one-hot of mu-law bin 127, or 0 for the scalar input). Returns (outputs
    (B, T, out_channels) f32 logits, emitted (B, T): int32 bins, or f32
    samples for the scalar input), both on the module's device.
    """
    check_decode_options(compute_dtype, weight_quant, use_fused_stack)
    if sample and generator is None:
        raise ValueError("sample=True needs a torch.Generator")
    module = cast_floating(module, compute_dtype)
    w = prepare_decode_weights(module, cfg, weight_quant)
    dev, act = w["bias"].device, w["bias"].dtype
    if c is not None:
        c = torch.as_tensor(c, device=dev).to(act)
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
    x_in = first_input(cfg, B, dev, act, initial_input)

    ring = init_buffers(cfg, B, dev, act)
    cap = ring.shape[1]
    lags = torch.tensor(tap_lags(cfg), dtype=torch.long,
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
    emitted = torch.empty((T, B), device=dev, dtype=(
        torch.float32 if cfg.scalar_input else torch.int32))
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
                skips = add_skip(skips, h, cfg.legacy)
        out = output_head(w, skips)
        outs[t] = out
        if cfg.scalar_input:
            if sample:
                nxt = sample_from_discretized_mix_logistic(
                    out[:, None, :], log_scale_min, generator=generator)[:, 0]
            else:
                nxt = out[:, 0]
            emitted[t] = nxt
            x = nxt[:, None].to(act) @ w["w_first"] + w["b_first"]
            continue
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
