"""PyTorch port: the plain decode-step chain against the JAX package's Pallas
kernel (``fused_glu_stack_step`` in interpret mode) and its XLA reference.

The cases are those of tests/test_wavenet_step.py. Tolerance: rtol 1e-4 /
atol 1e-5, the JAX test's own bound between its kernel and its reference.
On CPU tensors ``glu_stack_step`` takes the plain chain and launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vqvae_speech_tpu.ops.wavenet_step import (
    fused_glu_stack_step,
    glu_stack_step_xla,
)
from vqvae_speech_tpu_torch.ops import (
    glu_stack_step,
    glu_stack_step_torch,
    prepare_glu_stack_step,
)
from vqvae_speech_tpu_torch.ops._kernels import wavenet_step_cuda

CASES = [((4, 3, 1), False), ((6, 2, 2), True), ((3, 3, 4), True)]
NAMES = ("x0", "taps", "cond", "wtap", "bias", "wskip", "bskip", "wout", "bout")


def rand_stack(L, k, B, C=16, G=32, S=8, seed=0):
    rng = np.random.default_rng(seed)
    shapes = dict(x0=(B, C), taps=(L, k - 1, B, C), cond=(L, B, G),
                  wtap=(L, k, C, G), bias=(L, G), wskip=(L, G // 2, S),
                  bskip=(L, S), wout=(L, G // 2, C), bout=(L, C))
    return {n: (rng.standard_normal(shapes[n]) * 0.3).astype(np.float32)
            for n in NAMES}


def check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("shape,legacy", CASES)
def test_plain_chain_matches_pallas_interpret(shape, legacy):
    args = rand_stack(*shape)
    with pltpu.force_tpu_interpret_mode():
        want = fused_glu_stack_step(
            legacy=legacy, **{n: jnp.asarray(a) for n, a in args.items()})
    got = glu_stack_step_torch(
        legacy=legacy, **{n: torch.from_numpy(a) for n, a in args.items()})
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    check(got, want)


@pytest.mark.parametrize("shape,legacy", CASES)
def test_plain_chain_matches_xla_reference(shape, legacy):
    args = rand_stack(*shape, seed=1)
    want = glu_stack_step_xla(
        legacy=legacy, **{n: jnp.asarray(a) for n, a in args.items()})
    got = glu_stack_step_torch(
        legacy=legacy, **{n: torch.from_numpy(a) for n, a in args.items()})
    check(got, want)


def test_legacy_never_scales_layer_zero():
    """With one layer, legacy and non-legacy skip sums are the same."""
    args = {n: torch.from_numpy(a) for n, a in rand_stack(1, 3, 2).items()}
    a = glu_stack_step_torch(legacy=True, **args)
    b = glu_stack_step_torch(legacy=False, **args)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_dispatch_on_cpu_takes_the_plain_chain():
    args = {n: torch.from_numpy(a) for n, a in rand_stack(3, 3, 4).items()}
    before = wavenet_step_cuda.launches
    got = glu_stack_step(legacy=True, **args)
    want = glu_stack_step_torch(legacy=True, **args)
    assert wavenet_step_cuda.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,legacy", CASES)
def test_prepared_step_matches_pallas_interpret(shape, legacy):
    """The form the decode loop uses: weights bound once, then one call a
    step. On CPU weights it is the plain chain and launches nothing."""
    args = rand_stack(*shape, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = fused_glu_stack_step(
            legacy=legacy, **{n: jnp.asarray(a) for n, a in args.items()})
    t = {n: torch.from_numpy(a) for n, a in args.items()}
    before = wavenet_step_cuda.launches
    step = prepare_glu_stack_step(*(t[n] for n in NAMES[3:]), batch=shape[2],
                                  legacy=legacy)
    got = step(t["x0"], t["taps"], t["cond"])
    assert wavenet_step_cuda.launches == before
    check(got, want)
    for g, w in zip(got, glu_stack_step_torch(legacy=legacy, **t)):
        assert torch.equal(g, w)
    # a second step through the same prepared form, other activations
    more = rand_stack(*shape, seed=3)
    t2 = dict(t, **{n: torch.from_numpy(more[n]) for n in NAMES[:3]})
    want2 = glu_stack_step_xla(
        legacy=legacy, **{n: jnp.asarray(a.numpy()) for n, a in t2.items()})
    check(step(t2["x0"], t2["taps"], t2["cond"]), want2)


def test_prepared_step_refuses_another_batch():
    t = {n: torch.from_numpy(a) for n, a in rand_stack(3, 3, 4).items()}
    step = prepare_glu_stack_step(*(t[n] for n in NAMES[3:]), batch=2)
    with pytest.raises(ValueError, match="batch 4"):
        step(t["x0"], t["taps"], t["cond"])
