"""Running a module on a cast of its parameters, inside autograd.

The JAX package's mixed precision casts the params tree (``_cast``,
``train/trainer.py:88-91``; the decoder's tree in
``models/wavenet_vqvae.py:91-95``) and differentiates through the cast, so
the gradients reach the f32 masters as f32. ``cast_call`` does the same with
``torch.func.functional_call``: the module's own parameters stay f32 and are
what autograd differentiates.
"""
from typing import Optional

import torch
from torch.func import functional_call


def cast_call(module: torch.nn.Module, compute_dtype: Optional[torch.dtype],
              args: tuple, kwargs: Optional[dict] = None):
    """``module(*args, **kwargs)``, with its floating parameters cast to
    ``compute_dtype`` when that is not None. Buffers are not cast: an EMA
    quantizer's state stays f32, and its in-place replacement stays on the
    module."""
    kwargs = kwargs or {}
    if compute_dtype is None:
        return module(*args, **kwargs)
    cast = {name: p.to(compute_dtype) if p.is_floating_point() else p
            for name, p in module.named_parameters()}
    return functional_call(module, cast, args, kwargs)
