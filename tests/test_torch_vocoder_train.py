"""PyTorch port: the vocoder train steps (``train/vocoder.py``) against the
JAX package's, 3 steps each of the ClariNet teacher, the IAF student and
FloWaveNet (the flow's cases are in tests/test_torch_flow_train.py, with
these helpers), in f32 and at ``compute_dtype`` bf16, on the same
numpy weights and batches (the student fed JAX's own z draws, recomputed
from its key chain).

Gradients are compared leaf by leaf through the optimizers' first moments:
each step's (clipped) gradient is ``(mu_t - 0.9 mu_{t-1}) / 0.1``, taken in
float64 from either package's f32 moments.

Tolerances. f32: losses rtol 2e-6; gradients per leaf within 1e-4 of the
leaf's largest |gradient| plus 1e-6 of the largest |gradient| of all leaves
(a leaf whose gradient is a sum that cancels, such as the flow's upsampler
bias, sits orders below the rest: measured 2.0e-4 of its own largest);
Adam's second moments rtol 1e-4. Parameters and the EMA: an Adam step moves
an element by about lr * sign(g) when |g| >> eps, and by a ratio of two
tiny numbers near g = 0, where f32 noise in g moves the update most. So at
least 99% of the elements agree to an ulp or two (2e-7 + 3e-7 relative;
measured: every element of the teacher, all but 1 of the student's 8240,
all but 23 of the flow's 1.29 M after 3 steps) and every element within
1e-4 (measured 9.5e-7; a sign flip would give 2 lr = 2e-3).
bf16: the port against JAX's jitted bf16 step: the loss at each step within
a bf16 ulp of it (2**-8 relative); the gradients (all leaves together, and
the worst leaf) and the parameters within 1.5 times JAX's own bf16 spread
(its bf16 step against its f32 step, measured here on the same run; the
port measured 0.4-0.9 times it together, up to 1.24 times it on a leaf).
JAX's bf16 on the CPU is an XLA compile that keeps f32 inside fusions, so its loss can
sit closer to its f32 loss than a bf16 ulp; the port rounds op by op, as
JAX's eager bf16 does (tests/test_torch_flowavenet_forward.py holds the
flow's forward to that within 2e-6).

optax computes its bias corrections in JAX's default float: f32 as the JAX
package runs, f64 under tests/conftest.py's x64. The JAX runs here switch
x64 off, as test_torch_amsgrad.py does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_leaves

from vqvae_speech_tpu.models import clarinet as jax_clarinet
from vqvae_speech_tpu.models import flowavenet as jax_flow
from vqvae_speech_tpu.train import vocoder as jax_vocoder
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models import clarinet, flowavenet
from vqvae_speech_tpu_torch.train import vocoder

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These widths run as fast on one thread, and the Tier-1 command runs
    six test processes on the machine's cores: PyTorch's default of a
    thread a core in each of them oversubscribes it many times over. The
    other vocoder test files import this fixture."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# vocoder_main.py's --tiny presets (the flow with a split, so its prior
# trains too)
TEACHER = dict(num_blocks=1, num_layers=2, front_channels=4,
               residual_channels=8, gate_channels=8, skip_channels=8,
               kernel_size=2, cin_channels=80, upsample_scales=(16, 16))
STUDENT = dict(num_blocks_student=(1, 1), num_layers=2, front_channels=4,
               residual_channels=8, gate_channels=8, skip_channels=8,
               kernel_size=3, cin_channels=80)
FLOW = dict(in_channel=1, cin_channel=80, n_block=2, n_flow=1, n_layer=1,
            filter_size=8, block_per_split=1, upsample_scales=(16, 16))
LR = 1e-3
CLIP = {"teacher": 10.0, "student": 10.0, "flow": 1.0}
STEPS = 3
B, T = 2, 2048


def batch():
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)
    c = rng.random((B, T // 256, 80)).astype(np.float32)
    return {"x": x, "c": c}


def trees():
    teacher = convert.numpy_gaussian_wavenet_params(
        clarinet.GaussianWaveNetConfig(**TEACHER), 0)
    student = convert.numpy_student_params(clarinet.StudentConfig(**STUDENT),
                                           1)
    flow = convert.numpy_flowavenet_params(
        flowavenet.FlowavenetConfig(**FLOW), 2)
    return {"teacher": teacher, "student": student, "flow": flow}


def jax_z_draws(steps=STEPS):
    """The JAX student step's z: ``rng, sub = split(rng)``, then
    ``normal(sub, x.shape)``, from the state's ``PRNGKey(0)``."""
    with jax.enable_x64(False):
        key, out = jax.random.PRNGKey(0), []
        for _ in range(steps):
            key, sub = jax.random.split(key)
            out.append(np.asarray(jax.random.normal(sub, (B, T, 1))))
    return out


def _record(out, loss, mu, nu, params, ema):
    out.append(dict(loss=float(loss), mu=[np.array(a, np.float64)
                                          for a in tree_leaves(mu)],
                    nu=[np.array(a) for a in tree_leaves(nu)],
                    params=[np.array(a) for a in tree_leaves(params)],
                    ema=[np.array(a) for a in tree_leaves(ema)]))


@functools.lru_cache(maxsize=None)
def jax_run(kind, bf16=False, clip=None):
    clip = CLIP[kind] if clip is None else clip
    tree = jax.tree_util.tree_map(jnp.asarray, trees()[kind])
    cd = jnp.bfloat16 if bf16 else None
    data = batch()
    with jax.enable_x64(False):
        halve = 200_000 if kind == "flow" else None
        opt = jax_vocoder.make_vocoder_optimizer(LR, clip, halve)
        if kind == "teacher":
            step = jax_vocoder.make_teacher_train_step(
                jax_clarinet.GaussianWaveNetConfig(**TEACHER), opt,
                compute_dtype=cd)
        elif kind == "student":
            step = jax_vocoder.make_student_train_step(
                jax_clarinet.GaussianWaveNetConfig(**TEACHER),
                jax_clarinet.StudentConfig(**STUDENT),
                jax.tree_util.tree_map(jnp.asarray, trees()["teacher"]), opt,
                compute_dtype=cd)
        else:
            step = jax_vocoder.make_flow_train_step(
                jax_flow.FlowavenetConfig(**FLOW), opt, compute_dtype=cd)
        state = jax_vocoder.create_vocoder_state(jax.random.PRNGKey(0), tree,
                                                 opt)
        out = []
        for _ in range(STEPS):
            state, res = step(state, data)
            loss = res[0] if isinstance(res, tuple) else res
            adam = state.opt_state[1]
            _record(out, loss, adam.mu, adam.nu, state.params,
                    state.ema_params)
    return out


@functools.lru_cache(maxsize=None)
def port_run(kind, bf16=False, clip=None):
    clip = CLIP[kind] if clip is None else clip
    cd = torch.bfloat16 if bf16 else None
    data = {k: torch.from_numpy(v) for k, v in batch().items()}
    halve = 200_000 if kind == "flow" else None
    opt = vocoder.make_vocoder_optimizer(LR, clip, halve)
    if kind == "teacher":
        step = vocoder.make_teacher_train_step(
            clarinet.GaussianWaveNetConfig(**TEACHER), opt, compute_dtype=cd)
    elif kind == "student":
        step = vocoder.make_student_train_step(
            clarinet.GaussianWaveNetConfig(**TEACHER),
            clarinet.StudentConfig(**STUDENT), trees()["teacher"], opt,
            compute_dtype=cd, device="cpu")
        draws = iter(jax_z_draws())
        step = functools.partial(
            lambda s, st, b: s(st, b, z=torch.tensor(next(draws))), step)
    else:
        step = vocoder.make_flow_train_step(
            flowavenet.FlowavenetConfig(**FLOW), opt, compute_dtype=cd)
    state = vocoder.create_vocoder_state(trees()[kind], opt, device="cpu")
    out = []
    for _ in range(STEPS):
        state, res = step(state, data)
        loss = res[0] if isinstance(res, tuple) else res
        host = convert.numpy_tree
        _record(out, loss, host(state.opt_state.mu),
                host(state.opt_state.nu), host(state.params),
                host(state.ema_params))
    assert state.step == STEPS and state.opt_state.count == STEPS
    return out


def gradients(run):
    """Each step's gradient leaves from the first moments."""
    out, prev = [], [np.zeros_like(m) for m in run[0]["mu"]]
    for rec in run:
        out.append([(m - 0.9 * p) / 0.1 for m, p in zip(rec["mu"], prev)])
        prev = rec["mu"]
    return out


def worst_leaf(got, want, ref):
    """The largest per-leaf relative distance ||got - want|| / ||ref||."""
    return max(np.linalg.norm(g - w) / max(np.linalg.norm(r), 1e-30)
               for g, w, r in zip(got, want, ref))


def whole(got, want, ref):
    """The relative distance of all the leaves together."""
    return np.sqrt(sum(np.sum((g - w) ** 2) for g, w in zip(got, want))
                   / sum(np.sum(r ** 2) for r in ref))


def assert_bf16_gradients_within_jax_spread(jf, jb, pb):
    """Each step's gradients: the port's bf16 against JAX's bf16 within 1.5
    times JAX's bf16 against its f32, over all leaves together and on the
    worst leaf."""
    for t, (gf, gb, gp) in enumerate(zip(gradients(jf), gradients(jb),
                                         gradients(pb))):
        for measure in (whole, worst_leaf):
            spread = measure(gb, gf, gf)
            assert spread > 0, (t, measure.__name__)
            assert measure(gp, gb, gf) <= 1.5 * spread, (t, measure.__name__)


@pytest.mark.parametrize("kind", ["teacher", "student"])
def test_f32_steps_follow_jax(kind):
    want, got = jax_run(kind), port_run(kind)
    for t, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-6,
                                   err_msg=f"loss, step {t}")
        for i, (a, b) in enumerate(zip(g["nu"], w["nu"])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-12,
                                       err_msg=f"nu leaf {i}, step {t}")
        for name in ("params", "ema"):
            assert_parameters_close(g[name], w[name], f"{name}, step {t}")
    assert_gradients_close(gradients(got), gradients(want))


def assert_parameters_close(got, want, what):
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    ulps = diff > 2e-7 + 3e-7 * np.concatenate(
        [np.abs(b).ravel() for b in want])
    assert ulps.mean() < 0.01, (what, ulps.sum(), ulps.size)
    assert diff.max() < 1e-4, (what, diff.max())


def assert_gradients_close(got, want):
    for t, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws)
        largest = max(np.abs(b).max() for b in ws)
        for i, (a, b) in enumerate(zip(gs, ws)):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6 * largest,
                err_msg=f"gradient leaf {i}, step {t}")


def test_a_clip_that_triggers():
    """At clip 1e-3 every step's gradient norm is far above the clip: the
    first moment of step 1 is 0.1 x the clipped gradient, whose global norm
    is the clip; the port's steps follow JAX's."""
    want, got = jax_run("teacher", clip=1e-3), port_run("teacher", clip=1e-3)
    unclipped = np.sqrt(sum(np.sum(g ** 2)
                            for g in gradients(jax_run("teacher"))[0]))
    assert unclipped > 1.0
    for run in (want, got):
        norm = np.sqrt(sum(np.sum(g ** 2) for g in gradients(run)[0]))
        np.testing.assert_allclose(norm, 1e-3, rtol=1e-5)
    assert_gradients_close(gradients(got), gradients(want))
    assert_parameters_close(got[-1]["params"], want[-1]["params"], "params")


@pytest.mark.parametrize("kind", ["teacher", "student"])
def test_bf16_steps_within_jax_spread(kind):
    jf, jb, pb = jax_run(kind), jax_run(kind, True), port_run(kind, True)
    for t in range(STEPS):
        # within a bf16 ulp of the loss, 2**-8 relative
        assert abs(pb[t]["loss"] - jb[t]["loss"]) <= 2 ** -8 * abs(
            jb[t]["loss"]), t
    assert_bf16_gradients_within_jax_spread(jf, jb, pb)
    spread = max(np.abs(a - b).max() for a, b in zip(jb[-1]["params"],
                                                     jf[-1]["params"]))
    dist = max(np.abs(a - b).max() for a, b in zip(pb[-1]["params"],
                                                   jb[-1]["params"]))
    assert dist <= 1.5 * spread


def test_schedules_match_jax():
    steps = [0, 1, 199_999, 200_000, 399_999, 400_000, 599_999, 600_000,
             1_000_000]
    with jax.enable_x64(False):
        for port, ref in ((vocoder.step_lr_schedule(LR),
                           jax_vocoder.step_lr_schedule(LR)),
                          (vocoder.steplr_schedule(LR),
                           jax_vocoder.steplr_schedule(LR))):
            got = [np.float32(port(s)) for s in steps]
            want = [np.float32(ref(jnp.int32(s))) for s in steps]
            assert got == want
    assert vocoder.step_lr_schedule(LR)(10 ** 7) == LR / 8
    assert vocoder.steplr_schedule(LR)(1_000_000) == LR / 32


def test_mesh_raises():
    """A mesh that is not a (data, model) DeviceMesh raises TypeError (a
    real one trains: tests/test_torch_parallel_train.py)."""
    opt = vocoder.make_vocoder_optimizer(LR, 10.0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        vocoder.make_teacher_train_step(
            clarinet.GaussianWaveNetConfig(**TEACHER), opt, mesh=object())


def test_bf16_sigmoid_takes_the_logistics_gradient():
    """The bf16 gated units compute XLA's expansion 1 / (1 + exp(-x)) op by
    op; their gradient is the logistic's, g * (y * (1 - y)), as JAX's rule
    for ``lax.logistic`` gives it, bit for bit. Autograd through the
    expansion gave NaN where exp(-x) overflows (x < -88.7): the paper-width
    student's first bf16 step at its init did (F5)."""
    from vqvae_speech_tpu_torch.models.clarinet.modules import sigmoid

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(200) * 8,
                        [-100.0, -1000.0, 100.0, 0.0]]).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    with jax.enable_x64(False), jax.disable_jit():
        want_y, vjp = jax.vjp(jax.nn.sigmoid, jnp.asarray(x, jnp.bfloat16))
        (want_g,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.tensor(x).bfloat16().requires_grad_(True)
    y = sigmoid(xt)
    y.backward(torch.tensor(g).bfloat16())
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want_g, np.float32))
