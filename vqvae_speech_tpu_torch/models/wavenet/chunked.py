"""Resumable chunked AR WaveNet decode for continuous-batching serving.

Counterpart of ``vqvae_speech_tpu/models/wavenet/chunked.py``. The server
keeps ``slots`` decode streams on the device and advances all of them K
samples a launch; requests join and retire at chunk boundaries.

* **One shared clock** ``g`` (a host int: the decode loop runs on the host).
  Every slot's ring position at a step is the same, ``(g - lag) mod cap``
  in the one (L, cap + 1, B, C) ring of ``incremental.py``, and per-slot-ness
  is an admission offset ``start[b]``.
* **Causal mask by age.** A tap is zero where ``g - lag < start[b]``: the
  rows a slot's previous occupant wrote stay in the ring and must read as
  the zero history a fresh decode sees. A masked tap's index points at ring
  slot ``cap``, which is never written, so a step's taps are still ONE
  gather (indices for the whole chunk are computed once).
* **Conditioning** is upsampled and projected at admission, at batch 1 and
  zero-padded to ``max_frames`` (``slot_conditioning``), exactly the
  standalone decode's hoisting, so a slot's stream does not depend on its
  neighbours; a step gathers each slot's (L, G) row at its slot-local time
  ``clamp(g - start, 0, max_t - 1)``.
* **Noise** for sampled streams is the request's own, installed at
  admission (Gumbel draws for the categorical output, [Gumbel | u] for the
  mixture) and read at slot-local time: a request's stream depends on its
  draws alone, never on what shares the pool.
* At f32 with ``use_fused_stack`` the layer stack is one call of the step
  ``ops.prepare_glu_stack_step(batch=slots)`` bound once (the decode-step
  kernel on the card); the bf16 and int8 decodes run ``layer_step`` per
  layer, as the JAX package's chunk does for every configuration.
"""
import torch

from vqvae_speech_tpu_torch.models.wavenet.incremental import (
    add_skip,
    cast_floating,
    check_decode_options,
    first_input,
    hoist_conditioning,
    layer_step,
    output_head,
    prepare_decode_weights,
    ring_capacity,
    tap_lags,
)
from vqvae_speech_tpu_torch.models.wavenet.mixture import (
    sample_from_discretized_mix_logistic,
)
from vqvae_speech_tpu_torch.models.wavenet.model import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.ops.wavenet_step import prepare_glu_stack_step

__all__ = ["init_decode_slots", "admit_slot", "decode_chunk",
           "slot_conditioning", "noise_width"]


def noise_width(cfg: WaveNetConfig) -> int:
    """A sampled step's draws a slot: one Gumbel a bin, or one a mixture
    component and the logistic's u."""
    return cfg.out_channels // 3 + 1 if cfg.scalar_input else cfg.out_channels


@torch.inference_mode()
def init_decode_slots(module: WaveNet, cfg: WaveNetConfig, slots: int,
                      max_t: int, compute_dtype=None, weight_quant=None,
                      use_fused_stack: bool = False):
    """Build the device-resident server state on the module's device.

    Returns ``(prep, state)``: prep, the decode weights
    (``prepare_decode_weights`` in the compute dtype), the first conv of the
    initial input ``x_start``, the lags and, with ``use_fused_stack``, the
    prepared step; state, ``x`` (B, C) each slot's next layer-0 input,
    ``g`` the shared clock, ``start`` (B,) the admission clocks, ``ring``
    (L, cap + 1, B, C) and, when the model is conditioned, ``cond``
    (B, max_t, L, G) (zeros until admission). Sampled admissions add
    ``noise`` (B, max_t, noise_width)."""
    check_decode_options(compute_dtype, weight_quant, use_fused_stack)
    module = cast_floating(module, compute_dtype)
    prep = prepare_decode_weights(module, cfg, weight_quant)
    dev, act = prep["bias"].device, prep["bias"].dtype
    x_in = first_input(cfg, 1, dev, act)
    prep["x_start"] = (x_in @ prep["w_first"] + prep["b_first"])[0]
    prep["lags"] = torch.tensor(tap_lags(cfg), dtype=torch.long,
                                device=dev).reshape(cfg.layers, -1)
    if use_fused_stack:
        prep["stack_step"] = prepare_glu_stack_step(
            prep["wtap"], prep["bias"], prep["wskip"], prep["bskip"],
            prep["wout"], prep["bout"], batch=slots, legacy=cfg.legacy)
    state = {
        "x": prep["x_start"].expand(slots, -1).clone(),
        "g": 0,
        "start": torch.zeros((slots,), dtype=torch.long, device=dev),
        # slot cap is never written: masked taps read its zeros
        "ring": torch.zeros((cfg.layers, ring_capacity(cfg) + 1, slots,
                             cfg.residual_channels), dtype=act, device=dev),
        "max_t": int(max_t),
    }
    if cfg.cin_channels > 0 or cfg.gin_channels > 0:
        state["cond"] = torch.zeros(
            (slots, max_t, cfg.layers, cfg.gate_channels), dtype=act,
            device=dev)
    return prep, state


@torch.inference_mode()
def slot_conditioning(module: WaveNet, cfg: WaveNetConfig, c, g, max_t: int,
                      compute_dtype=None) -> torch.Tensor:
    """Per-layer conditioning rows (max_t, L, G) for ONE request.

    c: (max_frames, cin) local conditioning zero-padded to the server's
    frame capacity, or None; g: a speaker id or None. Upsampled and
    projected at batch 1, the standalone decode's hoisting; the subpixel
    upsamplers draw one input frame an output sample, so the padding never
    reaches the true range. Rows past the conditioning are zero."""
    module = cast_floating(module, compute_dtype)
    dev, act = module.first_conv.bias.device, module.first_conv.bias.dtype
    if c is not None:
        c = torch.as_tensor(c, device=dev)[None].to(act)
        if cfg.upsample_conditional_features:
            c = module.upsample_lc(c)
        c = c[:, :max_t]
    g = None if g is None else torch.tensor([int(g)], device=dev)
    T = c.shape[1] if c is not None else max_t
    rows = torch.zeros((max_t, cfg.layers, cfg.gate_channels), dtype=act,
                       device=dev)
    cond = hoist_conditioning(module, cfg, c, g, 1, T)   # (T, L, 1, G)
    if cond is not None:
        rows[:T] = cond[:, :, 0]
    return rows


@torch.inference_mode()
def admit_slot(prep: dict, state: dict, slot: int, cond_rows,
               noise=None) -> dict:
    """Admit a request into ``slot``: pin its admission clock to the shared
    clock, reset its next input, install its conditioning rows and, for a
    sampled stream, its draws (n, noise_width) for its n steps. The ring
    needs no reset: the age mask makes the rows written before admission
    unreadable. Updates ``state`` in place and returns it."""
    state["x"][slot] = prep["x_start"]
    state["start"][slot] = state["g"]
    if "cond" in state:
        state["cond"][slot] = cond_rows
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=torch.float32)
        buf = state.get("noise")
        if buf is None:
            slots, max_t = state["x"].shape[0], state["max_t"]
            buf = state["noise"] = torch.zeros(
                (slots, max_t, noise.shape[-1]), device=state["x"].device)
        if noise.shape[0] > buf.shape[1] or noise.shape[1] != buf.shape[2]:
            raise ValueError(f"noise of shape {tuple(noise.shape)} does not "
                             f"fit the slots' {tuple(buf.shape[1:])}")
        buf[slot].zero_()
        buf[slot, :noise.shape[0]] = noise.to(buf.device)
    return state


@torch.inference_mode()
def decode_chunk(prep: dict, state: dict, cfg: WaveNetConfig, K: int,
                 sample: bool = True, log_scale_min: float = -50.0,
                 return_logits: bool = False):
    """Advance every slot K samples. Returns ``(state, emitted)`` with
    emitted (B, K) int32 bins (f32 samples for the scalar input) on the
    device, and the f32 logits (B, K, out_channels) third with
    ``return_logits``; the caller slices each slot's span by its own
    progress (g - start). ``state`` is updated in place."""
    ring, start, cond = state["ring"], state["start"], state.get("cond")
    L, cap, B, _ = ring.shape
    cap -= 1
    dev, act = ring.device, ring.dtype
    noise = state.get("noise") if sample else None
    if sample and noise is None:
        raise ValueError("a sampled chunk needs each slot's draws: admit "
                         "the requests with noise=")
    g0 = state["g"]
    gs = torch.arange(g0, g0 + K, device=dev)
    pos = gs[:, None, None] - prep["lags"]                     # (K, L, k-1)
    alive = pos[..., None] >= start                            # (K, L, k-1, B)
    tap_slot = torch.where(alive, (pos % cap)[..., None], cap)
    tc = (gs[:, None] - start).clamp(0, state["max_t"] - 1)    # (K, B)
    l_idx = torch.arange(L, device=dev)
    b_idx = torch.arange(B, device=dev)
    stack_step = prep.get("stack_step")
    zero_cond = None
    if stack_step is not None and cond is None:
        zero_cond = torch.zeros((L, B, cfg.gate_channels), device=dev)

    outs = torch.empty((K, B, cfg.out_channels), device=dev)
    emitted = torch.empty((K, B), device=dev, dtype=(
        torch.float32 if cfg.scalar_input else torch.int32))
    x = state["x"]
    for t in range(K):
        g = g0 + t
        taps = ring[l_idx[:, None, None], tap_slot[t], b_idx]  # (L, k-1, B, C)
        cond_t = None
        if cond is not None:                                   # (L, B, G)
            cond_t = cond[b_idx, tc[t], l_idx[:, None]]
        if stack_step is not None:
            x, skips, x_all = stack_step(
                x, taps, zero_cond if cond_t is None else cond_t)
            ring[:, g % cap] = x_all
        else:
            skips, x_all = None, []
            for l in range(L):
                x_all.append(x)
                x, h = layer_step(prep, l, x, list(taps[l]),
                                  None if cond_t is None else cond_t[l], cfg)
                skips = add_skip(skips, h, cfg.legacy)
            ring[:, g % cap] = torch.stack(x_all)
        out = output_head(prep, skips)
        outs[t] = out
        draws = None if noise is None else noise[b_idx, tc[t]]   # (B, W)
        if cfg.scalar_input:
            if sample:
                nr = cfg.out_channels // 3
                nxt = sample_from_discretized_mix_logistic(
                    out[:, None, :], log_scale_min,
                    gumbel=draws[:, None, :nr], u=draws[:, None, nr])[:, 0]
            else:
                nxt = out[:, 0]
            emitted[t] = nxt
            x = nxt[:, None].to(act) @ prep["w_first"] + prep["b_first"]
        else:
            # a sampled bin is the Gumbel-max of the slot's own draws
            idx = torch.argmax(out if draws is None else draws + out, dim=-1)
            emitted[t] = idx
            x = prep["w_first"][idx] + prep["b_first"]
    state["x"] = x
    state["g"] = g0 + K
    if return_logits:
        return state, emitted.transpose(0, 1), outs.transpose(0, 1)
    return state, emitted.transpose(0, 1)
