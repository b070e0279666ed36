"""One autoregressive WaveNet decode step through the whole GLU layer stack.

Counterpart of ``vqvae_speech_tpu/ops/wavenet_step.py``. Layout (all stacked
over the L layers):

  x0    (B, C)          layer-0 input (the first conv's output)
  taps  (L, k-1, B, C)  ring-buffer history; tap j is lag (k-1-j)*dilation
  cond  (L, B, G)       pre-projected local + global conditioning at this t
  wtap  (L, k, C, G)    dilated-conv taps (tap k-1 multiplies the current x)
  bias  (L, G)
  wskip (L, G/2, S), bskip (L, S)
  wout  (L, G/2, C), bout (L, C)

Returns (x (B, C), skip (B, S), x_all (L, B, C)): the last layer's output,
the skip sum (the reference's progressive sqrt(1/2) scaling after layer 0
under ``legacy``) and every layer's input, for the ring-buffer writes.

``glu_stack_step_torch`` is the plain chain (the counterpart of
``glu_stack_step_xla``). ``glu_stack_step`` dispatches on the device of its
input: a CUDA tensor always goes to the hand-written kernel
``csrc/wavenet_step.cu`` (the port of the Pallas ``_kernel``), a CPU tensor
to the plain chain. There is no threshold and no fallback.

``prepare_glu_stack_step`` is the form a decode loop uses: it binds the
stack's weights and the batch size once and returns ``step(x0, taps, cond)``.
For CUDA weights that is the kernel's prepared launch, which checks shapes,
dtypes, devices and alignment of the weights, plans the launch and
allocates the outputs and scratch ONCE; a step then only checks its three
tensors and passes pointers. Its outputs are reused from call to call (each
call overwrites what the previous one returned), which is safe for a caller
that consumes a step's outputs on the same stream before the next call.
For CPU weights ``step`` is the plain chain.
"""
import math

import torch

from vqvae_speech_tpu_torch.ops._kernels import (
    PreparedWaveNetStep,
    wavenet_step_cuda,
)

_SQRT_HALF = math.sqrt(0.5)


def glu_stack_step_torch(x0, taps, cond, wtap, bias, wskip, bskip, wout,
                         bout, legacy: bool = False):
    """The plain PyTorch chain, layer by layer, as ``glu_stack_step_xla``."""
    k = wtap.shape[1]
    x = x0
    x_all = []
    skip = x0.new_zeros((x0.shape[0], wskip.shape[2]))
    for l in range(wtap.shape[0]):
        x_all.append(x)
        acc = cond[l] + bias[l]
        for j in range(k - 1):
            acc = acc + taps[l, j] @ wtap[l, j]
        acc = acc + x @ wtap[l, k - 1]
        a, b = acc.chunk(2, dim=-1)
        h = torch.tanh(a) * torch.sigmoid(b)
        s = h @ wskip[l] + bskip[l]
        skip = (skip + s) * _SQRT_HALF if legacy and l > 0 else skip + s
        x = (x + h @ wout[l] + bout[l]) * _SQRT_HALF
    return x, skip, torch.stack(x_all)


def glu_stack_step(x0, taps, cond, wtap, bias, wskip, bskip, wout, bout,
                   legacy: bool = False):
    """The hand-written kernel for CUDA tensors, the plain chain for CPU
    tensors; a CUDA input the kernel refuses raises."""
    if x0.is_cuda:
        return wavenet_step_cuda(x0, taps, cond, wtap, bias, wskip, bskip,
                                 wout, bout, legacy)
    if x0.device.type != "cpu":
        raise ValueError(f"glu_stack_step: no path for device {x0.device}")
    return glu_stack_step_torch(x0, taps, cond, wtap, bias, wskip, bskip,
                                wout, bout, legacy)


def prepare_glu_stack_step(wtap, bias, wskip, bskip, wout, bout, batch: int,
                           legacy: bool = False):
    """Bind one layer stack and batch size; returns ``step(x0, taps, cond)
    -> (x, skip, x_all)`` with the contract of ``glu_stack_step``. On CUDA
    weights the returned outputs are buffers that the next call overwrites."""
    if wtap.is_cuda:
        return PreparedWaveNetStep(wtap, bias, wskip, bskip, wout, bout,
                                   batch, legacy)
    if wtap.device.type != "cpu":
        raise ValueError(f"prepare_glu_stack_step: no path for device "
                         f"{wtap.device}")

    def step(x0, taps, cond):
        if x0.shape[0] != batch:
            raise ValueError(f"prepare_glu_stack_step: x0 has batch "
                             f"{x0.shape[0]}, prepared for {batch}")
        return glu_stack_step_torch(x0, taps, cond, wtap, bias, wskip, bskip,
                                    wout, bout, legacy)

    return step
