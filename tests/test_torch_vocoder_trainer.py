"""PyTorch port: ``VocoderTrainer`` (loss histories, best gating,
``on_best``) and the vocoder checkpoints across the two packages.

* Gating, on a scripted step and test loss: the histories in
  ``{name}_train.npy`` / ``{name}.npy``, ``{name}_{epoch}.pkl`` every
  epoch, ``{name}_best.pkl`` and ``on_best`` only on a new best, and a
  resume that keeps the running best (a worse epoch after it writes no
  best file).
* Checkpoints, on the JAX package's mini LJSpeech corpus at the CLI's
  --tiny widths: JAX's ``VocoderTrainer`` trains epoch 0, then both
  packages resume epoch 1 from that file; the port trains epoch 0, then
  both resume from the port's file. The epoch-1 checkpoints agree leaf by
  leaf (parameters, EMA, Adam moments and counts, the schedule's count, the
  step and the histories) for the teacher and the flow. The student's draws
  come from each package's own generator, so its runs part; its files load
  and train in both directions.

Tolerances: the losses rtol 1e-5. On these tones the gradients of the
conditioning path and the upsampler are sums over time that cancel, so the
two packages' f32 sums part by up to 1.8e-3 of a leaf's largest element
(measured on the teacher after 2 steps; 2e-6 on the random batches of
tests/test_torch_vocoder_train.py), and Adam turns that into parameter
differences: the moments are held within 1e-2 of each leaf's largest
element, the parameters and the EMA by their distribution (measured after
2 steps: median 4.5e-8, 90th percentile 1.0e-6, largest 1.2e-4): median
within 1e-6, 90th percentile within 1e-5, every element within lr / 2 =
5e-4. A resume that lost the moments or the counts would move most
elements by about lr.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_leaves

from tests.test_ljspeech_vocoder import _mini_ljspeech
from tests.test_torch_vocoder_train import (  # noqa: F401
    FLOW,
    STUDENT,
    TEACHER,
    one_torch_thread,
)
from vqvae_speech_tpu.data import ljspeech as jax_ljspeech
from vqvae_speech_tpu.models import clarinet as jax_clarinet
from vqvae_speech_tpu.models import flowavenet as jax_flow
from vqvae_speech_tpu.train import vocoder as jax_vocoder
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.data import ljspeech
from vqvae_speech_tpu_torch.models import clarinet, flowavenet
from vqvae_speech_tpu_torch.train import vocoder

LR = 1e-3
BATCH = 2
CROP = 2048


# ---------------- gating ----------------


def test_histories_gating_and_on_best(tmp_path):
    """A step that returns scripted train losses and a test loss that returns
    scripted values: 3, 1, 2, 0.5 -> best at epochs 0, 1, 3."""
    opt = vocoder.make_vocoder_optimizer(LR, 10.0)
    state = vocoder.create_vocoder_state({"w": np.ones(3, np.float32)}, opt,
                                         device="cpu")
    train = iter([4.0, 6.0, 2.0, 2.0, 3.0, 3.0, 1.0, 1.0])
    test = iter([3.0, 1.0, 2.0, 0.5])

    def step(state, batch):
        assert batch["x"].device.type == "cpu" and "y" not in batch
        return state, torch.tensor(next(train))

    batches = [{"x": np.zeros((1, 4, 1), np.float32),
                "c": np.zeros((1, 1, 80), np.float32),
                "y": np.zeros((1, 4), np.float32)}] * 2
    best = []
    trainer = vocoder.VocoderTrainer(
        step, state, batches, str(tmp_path), "m", eval_loader=[batches[0]],
        eval_loss_fn=lambda params, batch: next(test),
        on_best=lambda state, epoch: best.append(epoch))
    for epoch in range(3):
        trainer.train_epoch(epoch)
    np.testing.assert_array_equal(np.load(tmp_path / "m_train.npy"),
                                  [5.0, 2.0, 3.0])
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"), [3, 1, 2])
    assert best == [0, 1]
    ckpt = vocoder.load_vocoder_checkpoint(str(tmp_path / "m_best.pkl"))
    assert ckpt["epoch"] == 1 and ckpt["loss"] == 1.0
    assert ckpt["best_loss"] == 1.0
    assert sorted(os.listdir(tmp_path)) == [
        "m.npy", "m_0.pkl", "m_1.pkl", "m_2.pkl", "m_best.pkl",
        "m_train.npy"]
    # a resume from epoch 2 keeps the running best: its worse epochs write
    # no best file, a better one does
    test = iter([1.5, 0.5])
    resumed = vocoder.VocoderTrainer(
        step, state, batches, str(tmp_path), "m", eval_loader=[batches[0]],
        eval_loss_fn=lambda params, batch: next(test),
        on_best=lambda state, epoch: best.append(epoch))
    assert vocoder.restore_vocoder_trainer(
        resumed, str(tmp_path / "m_2.pkl")) == 3
    assert resumed.best_loss == 1.0 and resumed.eval_losses == [3, 1, 2]
    train = iter([1.0, 1.0, 1.0, 1.0])
    resumed.train_epoch(3)
    assert best == [0, 1]
    resumed.train_epoch(4)
    assert best == [0, 1, 4]
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"),
                                  [3, 1, 2, 1.5, 0.5])


def test_without_a_test_loader_the_train_loss_gates(tmp_path):
    opt = vocoder.make_vocoder_optimizer(LR, 10.0)
    state = vocoder.create_vocoder_state({"w": np.ones(3, np.float32)}, opt,
                                         device="cpu")
    losses = iter([2.0, 3.0])
    trainer = vocoder.VocoderTrainer(
        lambda s, b: (s, (torch.tensor(next(losses)), {})), state,
        [{"x": np.zeros((1, 4, 1), np.float32),
          "c": np.zeros((1, 1, 80), np.float32)}], str(tmp_path), "m")
    trainer.train_epoch(0)
    trainer.train_epoch(1)
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"), [2.0, 3.0])
    assert vocoder.load_vocoder_checkpoint(
        str(tmp_path / "m_best.pkl"))["epoch"] == 0


# ---------------- checkpoints across the packages ----------------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lj"))
    _mini_ljspeech(root, n=6)
    out = os.path.join(root, "data")
    ljspeech.preprocess(root, out)
    return out


def loaders(module, data_root):
    ds = module.LJSpeechDataset(data_root, train=True, test_size=0.34)
    test = module.LJSpeechDataset(data_root, train=False, test_size=0.34)
    return (module.LJSpeechLoader(ds, BATCH, seed=0, max_time_steps=CROP),
            module.LJSpeechLoader(test, BATCH, seed=0, max_time_steps=CROP))


def init_tree(kind):
    if kind == "teacher":
        return convert.numpy_gaussian_wavenet_params(
            clarinet.GaussianWaveNetConfig(**TEACHER), 0)
    if kind == "student":
        return convert.numpy_student_init(clarinet.StudentConfig(**STUDENT),
                                          1)
    return convert.numpy_flowavenet_params(flowavenet.FlowavenetConfig(**FLOW),
                                           2)


@functools.lru_cache(maxsize=None)
def jax_parts(kind):
    """(optimizer, step, eval loss, eval on EMA), built once a kind: a jitted
    step compiles once for all the trainers that share it."""
    teacher = jax_clarinet.GaussianWaveNetConfig(**TEACHER)
    if kind == "teacher":
        opt = jax_vocoder.make_vocoder_optimizer(LR, clip_norm=10.0)
        step = jax_vocoder.make_teacher_train_step(teacher, opt)
        eval_fn, on_ema = jax_vocoder.make_teacher_eval_loss(teacher), True
    elif kind == "student":
        student = jax_clarinet.StudentConfig(**STUDENT)
        t_params = jax.tree_util.tree_map(jnp.asarray, init_tree("teacher"))
        opt = jax_vocoder.make_vocoder_optimizer(LR, clip_norm=10.0)
        step = jax_vocoder.make_student_train_step(teacher, student,
                                                   t_params, opt)
        eval_fn = jax_vocoder.make_student_eval_loss(teacher, student,
                                                     t_params)
        on_ema = True
    else:
        cfg = jax_flow.FlowavenetConfig(**FLOW)
        opt = jax_vocoder.make_vocoder_optimizer(LR, clip_norm=1.0,
                                                 halve_every=200_000)
        step = jax_vocoder.make_flow_train_step(cfg, opt)
        eval_fn, on_ema = jax_vocoder.make_flow_eval_loss(cfg), False
    return opt, step, eval_fn, on_ema


def jax_trainer(kind, data_root, ckpt_dir):
    loader, test = loaders(jax_ljspeech, data_root)
    opt, step, eval_fn, on_ema = jax_parts(kind)
    state = jax_vocoder.create_vocoder_state(
        jax.random.PRNGKey(0),
        jax.tree_util.tree_map(jnp.asarray, init_tree(kind)), opt)
    return jax_vocoder.VocoderTrainer(step, state, loader, ckpt_dir, kind,
                                      eval_loader=test, eval_loss_fn=eval_fn,
                                      eval_on_ema=on_ema)


def port_trainer(kind, data_root, ckpt_dir):
    loader, test = loaders(ljspeech, data_root)
    teacher = clarinet.GaussianWaveNetConfig(**TEACHER)
    if kind == "teacher":
        opt = vocoder.make_vocoder_optimizer(LR, clip_norm=10.0)
        step = vocoder.make_teacher_train_step(teacher, opt)
        eval_fn, on_ema = vocoder.make_teacher_eval_loss(teacher), True
    elif kind == "student":
        student = clarinet.StudentConfig(**STUDENT)
        opt = vocoder.make_vocoder_optimizer(LR, clip_norm=10.0)
        step = vocoder.make_student_train_step(
            teacher, student, init_tree("teacher"), opt, device="cpu")
        eval_fn = vocoder.make_student_eval_loss(
            teacher, student, init_tree("teacher"), device="cpu")
        on_ema = True
    else:
        cfg = flowavenet.FlowavenetConfig(**FLOW)
        opt = vocoder.make_vocoder_optimizer(LR, clip_norm=1.0,
                                             halve_every=200_000)
        step = vocoder.make_flow_train_step(cfg, opt)
        eval_fn, on_ema = vocoder.make_flow_eval_loss(cfg), False
    state = vocoder.create_vocoder_state(init_tree(kind), opt, device="cpu")
    return vocoder.VocoderTrainer(step, state, loader, ckpt_dir, kind,
                                  eval_loader=test, eval_loss_fn=eval_fn,
                                  eval_on_ema=on_ema)


def resume(make, kind, data_root, ckpt_dir, path):
    trainer = make(kind, data_root, ckpt_dir)
    restore = (jax_vocoder.restore_vocoder_trainer
               if make is jax_trainer else vocoder.restore_vocoder_trainer)
    assert restore(trainer, path) == 1
    trainer.train_epoch(1)
    return os.path.join(ckpt_dir, f"{kind}_1.pkl")


def assert_same_checkpoint(got_path, want_path):
    got = vocoder.load_vocoder_checkpoint(got_path)
    want = vocoder.load_vocoder_checkpoint(want_path)
    assert got["epoch"] == want["epoch"] and got["step"] == want["step"]
    np.testing.assert_array_equal(got["rng"], want["rng"])
    for key in ("loss", "best_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    for key in ("train_losses", "eval_losses"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    for key in ("params", "ema_params"):
        diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
            tree_leaves(got[key]), tree_leaves(want[key]))])
        assert np.median(diff) <= 1e-6, key
        assert np.quantile(diff, 0.9) <= 1e-5, key
        assert diff.max() <= LR / 2, key
    (_, adam, sched), (_, jadam, jsched) = got["opt_state"], want["opt_state"]
    assert int(adam[0]) == int(jadam[0]) and int(sched[0]) == int(jsched[0])
    for a, b in zip(tree_leaves(list(adam[1:])), tree_leaves(list(jadam[1:]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * np.abs(b).max())


def resume_across_the_packages(kind, data_root, tmp_path):
    """JAX and the port each train epoch 0; both resume epoch 1 from each
    file; the epoch-1 checkpoints agree, and the port's file is optax's to
    JAX."""
    with jax.enable_x64(False):
        jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
        jax_trainer(kind, data_root, jax_dir).train_epoch(0)
        port_trainer(kind, data_root, port_dir).train_epoch(0)
        assert_same_checkpoint(os.path.join(port_dir, f"{kind}_0.pkl"),
                               os.path.join(jax_dir, f"{kind}_0.pkl"))
        for start in (jax_dir, port_dir):
            path = os.path.join(start, f"{kind}_0.pkl")
            runs = []
            for make in (jax_trainer, port_trainer):
                out = str(tmp_path / f"{make.__name__}_from_"
                          f"{os.path.basename(start)}")
                runs.append(resume(make, kind, data_root, out, path))
            assert_same_checkpoint(runs[1], runs[0])
    # the port's file as the JAX package reads it: optax's own classes
    import pickle

    with open(os.path.join(port_dir, f"{kind}_0.pkl"), "rb") as f:
        raw = pickle.load(f)
    import optax

    assert isinstance(raw["opt_state"][1], optax.ScaleByAdamState)
    assert isinstance(raw["opt_state"][2], optax.ScaleByScheduleState)
    assert isinstance(raw["opt_state"][0], optax.EmptyState)
    assert raw["rng"].dtype == np.uint32 and raw["rng"].shape == (2,)


def test_resume_across_the_packages(data_root, tmp_path):
    """The teacher's (the flow's: tests/test_torch_flow_train.py)."""
    resume_across_the_packages("teacher", data_root, tmp_path)


def test_student_checkpoints_load_and_train_in_both_packages(data_root,
                                                             tmp_path):
    with jax.enable_x64(False):
        jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
        jax_trainer("student", data_root, jax_dir).train_epoch(0)
        port_trainer("student", data_root, port_dir).train_epoch(0)
        for start in (jax_dir, port_dir):
            path = os.path.join(start, "student_0.pkl")
            key = vocoder.load_vocoder_checkpoint(path)["rng"]
            for make in (jax_trainer, port_trainer):
                out = str(tmp_path / f"{make.__name__}_{len(start)}")
                trainer = make("student", data_root, out)
                restore = (jax_vocoder.restore_vocoder_trainer
                           if make is jax_trainer
                           else vocoder.restore_vocoder_trainer)
                assert restore(trainer, path) == 1
                if make is port_trainer:
                    # the port keeps the file's key and seeds its draws
                    # from it
                    np.testing.assert_array_equal(trainer.state.rng, key)
                assert np.isfinite(trainer.train_epoch(1))
                ckpt = vocoder.load_vocoder_checkpoint(
                    os.path.join(out, "student_1.pkl"))
                assert ckpt["step"] == 4 and len(ckpt["train_losses"]) == 2
