"""ClariNet Gaussian WaveNet (mean + log_std output): the batch core.

Counterpart of ``vqvae_speech_tpu/models/clarinet/wavenet.py:28-141``
(reference src/clarinet/wavenet.py:30-127): front causal conv (kernel 32) +
num_blocks x num_layers gated resblocks with dilation ``kernel_size**n`` +
ReLU/1x1 head with out_channels=2 (mean, log_std), and LC upsampling (16x16
= hop 256). Parameters are the resolved tensor trees of
``convert.load_gaussian_wavenet_params`` (serving) or
``convert.resolve_gaussian_wavenet`` (training, inside autograd).

``gaussian_wavenet_generate`` is the teacher's autoregressive synthesis
(JAX ``:147-242``, one ``lax.scan`` over per-layer ring buffers). Here each
sample step runs the whole gated layer stack through
``ops.wavenet_step.prepare_glu_stack_step``: on CUDA tensors one launch of
the hand-written decode-step kernel (``csrc/wavenet_step.cu``) a step, on
the CPU its plain twin. JAX's scan is plain jnp; the function is the same:
the layer's ``hf/hg = taps @ wf/wg + h @ wf/wg[k-1] + b + cond``, gated
``tanh(hf) * sigmoid(hg)``, skip and residual 1x1s, ``(h + res) * sqrt(1/2)``.
"""
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.models.clarinet.modules import (
    conv_apply,
    resblock_apply,
    upsample_apply,
)
from vqvae_speech_tpu_torch.ops.fused_resblock import fused_block_chain_tiled
from vqvae_speech_tpu_torch.ops.wavenet_step import (
    glu_stack_step_torch,
    prepare_glu_stack_step,
)


@dataclass(frozen=True)
class GaussianWaveNetConfig:
    out_channels: int = 2
    num_blocks: int = 4
    num_layers: int = 6
    front_channels: int = 32       # front conv kernel size (reference :47)
    residual_channels: int = 128
    gate_channels: int = 256
    skip_channels: int = 128
    kernel_size: int = 3
    cin_channels: int = 80
    upsample_scales: Sequence[int] = (16, 16)
    causal: bool = True

    def dilation(self, i):
        return self.kernel_size ** (i % self.num_layers)

    @property
    def total_layers(self):
        return self.num_blocks * self.num_layers

    def receptive_field_size(self):
        dil = [self.dilation(i) for i in range(self.total_layers)]
        return (self.kernel_size - 1) * sum(dil) + self.front_channels


def gaussian_wavenet_upsample(params, c, cfg: GaussianWaveNetConfig):
    return upsample_apply(params["upsample_conv"], c, cfg.upsample_scales)


def _head(params, skip):
    out = torch.relu(skip)
    out = torch.relu(conv_apply(params["final_conv_1"], out, 1))
    return conv_apply(params["final_conv_2"], out, 1)


def gaussian_wavenet_core(params, cfg: GaussianWaveNetConfig, x, c_up):
    """x: (B, T, 1) waveform; c_up: (B, T, cin) upsampled conditioning."""
    h = torch.relu(conv_apply(params["front_conv"], x, cfg.front_channels,
                              causal=cfg.causal))
    skip = 0.0
    for i, p in enumerate(params["res_blocks"]):
        h, s = resblock_apply(p, h, c_up, cfg.kernel_size, cfg.dilation(i),
                              cfg.causal)
        skip = skip + s
    return _head(params, skip)


def gaussian_wavenet_core_fused(params, cfg: GaussianWaveNetConfig, x, c_up):
    """Batch-1 core with every ``num_layers``-deep resblock chain run by
    ``ops.fused_resblock.fused_block_chain_tiled``: on a CUDA tensor one
    call of the hand-written chain kernel per chain, over
    ``params["chains"]`` (the weights stacked once, at load). The front
    conv and the two head 1x1s stay plain PyTorch. The chains' skip sums
    are f32 at any dtype and are summed in f32, then cast to x's dtype
    before the head, as in the JAX package (at bf16 the plain core sums
    skip in bf16)."""
    if x.shape[0] != 1:
        raise ValueError("fused core is the batch-1 (single-stream) path; "
                         f"got batch {x.shape[0]}")
    if not cfg.causal:
        raise ValueError("fused core implements the causal chain only")
    h = torch.relu(conv_apply(params["front_conv"], x, cfg.front_channels,
                              causal=cfg.causal))[0].contiguous()
    T = h.shape[0]
    c = c_up[0, :T].contiguous()
    skip = None
    for stacked in params["chains"]:
        h, s = fused_block_chain_tiled(h, c, stacked, layers=cfg.num_layers,
                                       kernel_size=cfg.kernel_size)
        skip = s if skip is None else skip + s
    return _head(params, skip[None].to(x.dtype))


def gaussian_wavenet_apply(params, cfg: GaussianWaveNetConfig, x, c):
    """Upsample c (B, Tc, cin) then run the core on x (B, T, 1) (reference
    forward, wavenet.py:77-80) -> (B, T, 2) [mean, log_std]."""
    return gaussian_wavenet_core(params, cfg, x,
                                 gaussian_wavenet_upsample(params, c, cfg))


def pack_layer_stack(params):
    """The resblocks as the decode-step kernel's stacked weights: wtap
    (L, k, C, 2*gate) = [filter | gate] taps, bias (L, 2*gate), wskip
    (L, gate, S), bskip (L, S), wout (L, gate, C), bout (L, C)."""
    def taps(p, name):                                   # (k, C, gate)
        return p[name]["w"].permute(2, 1, 0)

    def one_by_one(p, name):                             # (gate, out)
        return p[name]["w"][:, :, 0].T

    blocks = params["res_blocks"]
    packed = (
        [torch.cat([taps(p, "filter_conv"), taps(p, "gate_conv")], -1)
         for p in blocks],
        [torch.cat([p["filter_conv"]["b"], p["gate_conv"]["b"]])
         for p in blocks],
        [one_by_one(p, "skip_conv") for p in blocks],
        [p["skip_conv"]["b"] for p in blocks],
        [one_by_one(p, "res_conv") for p in blocks],
        [p["res_conv"]["b"] for p in blocks])
    return [torch.stack(t).contiguous() for t in packed]


def gaussian_wavenet_generate(params, cfg: GaussianWaveNetConfig,
                              num_samples: int, c, *, noise=None,
                              generator=None, log_std_min: float = -7.0,
                              scale_factor: float = 1.0, plain: bool = False):
    """Generate (B, num_samples) waveform from conditioning c (B, Tc, cin),
    f32, on c's device.

    The standard-normal draws are ``noise`` (num_samples, B) when given (a
    test feeds the JAX package's own), else drawn at once from
    ``generator`` on c's device. As in the JAX scan: the front conv reads
    the last ``front_channels`` emitted samples (the sample of step t is the
    input of step t+1; before t=0 zeros), each layer reads its input at lags
    ``(k-1-j) * d`` from a history of its inputs (zeros before t=0), the
    conditioning projections are hoisted over all steps, and the head's
    ``log_std`` is clamped at ``log_std_min`` and the sample clipped to
    ``[-scale_factor, scale_factor]``.

    The layer stack is packed once and bound once
    (``prepare_glu_stack_step``): on CUDA one decode-step kernel launch a
    step. ``plain=True`` runs the plain stack (``glu_stack_step_torch``) on
    any device instead: the reference the kernel is held to."""
    if params["front_conv"]["w"].dtype != torch.float32:
        raise ValueError("gaussian_wavenet_generate runs in f32; got "
                         f"{params['front_conv']['w'].dtype} parameters")
    with torch.no_grad():
        c_up = gaussian_wavenet_upsample(params, c, cfg)
        B, T = c_up.shape[0], int(num_samples)
        if c_up.shape[1] < T:
            raise ValueError(f"conditioning upsamples to {c_up.shape[1]} "
                             f"samples, fewer than num_samples={T}")
        dev = c_up.device
        L, k = cfg.total_layers, cfg.kernel_size
        C, S = cfg.residual_channels, cfg.skip_channels
        wtap, bias, wskip, bskip, wout, bout = pack_layer_stack(params)
        G = wtap.shape[-1]
        if plain:
            def step(x0, taps, cond):
                return glu_stack_step_torch(x0, taps, cond, wtap, bias, wskip,
                                            bskip, wout, bout)
        else:
            step = prepare_glu_stack_step(wtap, bias, wskip, bskip, wout,
                                          bout, batch=B)

        # every layer's conditioning projections over all T in one product,
        # laid out (T, L, B, G) so that a step reads one contiguous (L, B, G)
        blocks = params["res_blocks"]
        wc = torch.cat([torch.cat([p["filter_conv_c"]["w"][:, :, 0],
                                   p["gate_conv_c"]["w"][:, :, 0]])
                        for p in blocks])                     # (L*G, cin)
        bc = torch.cat([torch.cat([p["filter_conv_c"]["b"],
                                   p["gate_conv_c"]["b"]]) for p in blocks])
        cond = F.linear(c_up[:, :T], wc, bc).view(B, T, L, G)
        cond = cond.permute(1, 2, 0, 3).contiguous()

        # each layer's input history: a ring of R >= the largest lag slots;
        # slot t % R is written after step t, so a lag beyond t reads a
        # slot not written yet (zeros), as JAX's mask gives
        lags = [[(k - 1 - j) * cfg.dilation(i) for j in range(k - 1)]
                for i in range(L)]
        R = max([1] + [lag for row in lags for lag in row])
        hist = torch.zeros((R * L, B, C), device=dev)
        slots = torch.tensor(
            [[((t - lag) % R) * L + i for i in range(L) for lag in lags[i]]
             for t in range(R)], dtype=torch.long, device=dev)

        Kf = cfg.front_channels
        w_front = params["front_conv"]["w"][:, 0, :]           # (C, Kf)
        b_front = params["front_conv"]["b"]
        # the emitted samples after Kf zeros: x[t] (the input at step t) is
        # xs[:, Kf - 1 + t], and x[0] = 0
        xs = torch.zeros((B, Kf + T), device=dev)
        if noise is None:
            noise = torch.randn((T, B), generator=generator, device=dev)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
            if tuple(noise.shape) != (T, B):
                raise ValueError(f"noise has shape {tuple(noise.shape)}, "
                                 f"expected {(T, B)}")
        for t in range(T):
            h = torch.relu(F.linear(xs[:, t:t + Kf], w_front, b_front))
            taps = hist.index_select(0, slots[t % R]).view(L, k - 1, B, C)
            _, skip, x_all = step(h, taps, cond[t])
            hist.view(R, L, B, C)[t % R] = x_all
            o = torch.relu(F.linear(
                torch.relu(skip), params["final_conv_1"]["w"][:, :, 0],
                params["final_conv_1"]["b"]))
            o = F.linear(o, params["final_conv_2"]["w"][:, :, 0],
                         params["final_conv_2"]["b"])
            sample = o[:, 0] + torch.exp(
                o[:, 1].clamp_min(log_std_min)) * noise[t]
            xs[:, Kf + t] = sample.clamp(-scale_factor, scale_factor)
        return xs[:, Kf:].clone()
