"""PyTorch port: ``train.trainer.Amsgrad`` against ``optax.amsgrad`` on an
identical gradient sequence.

Tolerance: parameters and moments within rtol 2e-6 / atol 1e-9 after 6 steps
(the same f32 formula; the frameworks fuse multiplies and adds differently).
The sequence has |g1| > |g2| on every element, where optax's maximum over
the BIAS-CORRECTED second moment and ``torch.optim.Adam(amsgrad=True)``'s
maximum over the raw one part ways: the same check fails for PyTorch's own
optimizer.

optax computes the bias corrections ``1 - b^t`` in JAX's default float type:
f32 as the JAX package runs (``1 - f32(0.999)`` is 1.3e-5 off 0.001), f64
under the test harness's ``jax_enable_x64``. The port computes them in f32,
and the optax runs here switch x64 off to compare like with like.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from vqvae_speech_tpu_torch.train import make_optimizer

LR = 2e-4
SHAPES = ((3, 4, 5), (7,), (2, 6))


def sequence(steps=6, seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = []
    for t in range(steps):
        scale = 1.0 if t == 0 else 0.05      # |g1| > |g2|, ...
        grads.append([(scale * rng.uniform(0.5, 1.0, s)
                       * rng.choice([-1.0, 1.0], s)).astype(np.float32)
                      for s in SHAPES])
    return params, grads


def optax_run(params, grads, **options):
    with jax.enable_x64(False):
        opt = optax.amsgrad(options.pop("lr", LR), **options)
        p = [jnp.asarray(a) for a in params]
        state = opt.init(p)
        for g in grads:
            updates, state = opt.update([jnp.asarray(a) for a in g], state, p)
            p = optax.apply_updates(p, updates)
        return [np.asarray(a) for a in p], jax.tree_util.tree_map(
            np.asarray, state[0])


def assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=2e-6,
                                   atol=1e-9)


def test_port_follows_optax_term_for_term():
    params, grads = sequence()
    want_p, want_state = optax_run(params, grads)
    opt = make_optimizer(LR)
    p = [torch.from_numpy(a.copy()) for a in params]
    state = opt.init(p)
    for g in grads:
        opt.update(p, [torch.from_numpy(a) for a in g], state)
    assert state.count == int(want_state.count) == len(grads)
    assert_close([t.numpy() for t in p], want_p)
    assert_close([t.numpy() for t in state.mu], want_state.mu)
    assert_close([t.numpy() for t in state.nu], want_state.nu)
    assert_close([t.numpy() for t in state.nu_max], want_state.nu_max)


def test_torch_adam_amsgrad_is_a_different_optimizer():
    """The same sequence through ``torch.optim.Adam(amsgrad=True)`` leaves
    the tolerance from the second step on."""
    params, grads = sequence()
    want_p, _ = optax_run(params, grads)
    p = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = torch.optim.Adam(p, lr=LR, amsgrad=True)
    for g in grads:
        for t, a in zip(p, g):
            t.grad = torch.from_numpy(a.copy())
        opt.step()
    with pytest.raises(AssertionError):
        assert_close([t.detach().numpy() for t in p], want_p)
    # while one step alone agrees: the two part only when the maximum binds
    one_p, _ = optax_run(params, grads[:1])
    p = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = torch.optim.Adam(p, lr=LR, amsgrad=True)
    for t, a in zip(p, grads[0]):
        t.grad = torch.from_numpy(a.copy())
    opt.step()
    assert_close([t.detach().numpy() for t in p], one_p)


def test_other_learning_rate_matches_optax():
    """b1, b2 and eps are optax.amsgrad's defaults and fixed; the learning
    rate is the one setting."""
    from vqvae_speech_tpu_torch.train import Amsgrad

    params, grads = sequence(steps=3, seed=1)
    want_p, _ = optax_run(params, grads, lr=1e-3)
    opt = Amsgrad(1e-3)
    with pytest.raises(TypeError):
        Amsgrad(1e-3, b1=0.8)
    p = [torch.from_numpy(a.copy()) for a in params]
    state = opt.init(p)
    for g in grads:
        opt.update(p, [torch.from_numpy(a) for a in g], state)
    assert_close([t.numpy() for t in p], want_p)
