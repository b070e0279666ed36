"""Vocoder training: ClariNet teacher, IAF student distillation, FloWaveNet
MLE, with weight-EMA, LR halving and gradient clipping.

Counterpart of ``vqvae_speech_tpu/train/vocoder.py`` (the reference's
src/clarinet/train.py:42-293, train_student.py:42-403 and
src/flow_wavenet/train.py:55-90):

* teacher: Adam, LR x0.5 at 200k/400k/600k steps, grad-clip 10, weight-EMA
  shadow (decay 0.9999), Gaussian NLL on ``y_hat[:-1]`` vs ``y[1:]``,
* student: z ~ N(0, 1), the frozen teacher scores the student's samples,
  KL + 4*reg + STFT frame loss,
* flow: loss = -(log_p + logdet), grad-clip 1, StepLR halving every 200k.

The parameters are a tree in the JAX layout (dicts and lists of f32 leaf
tensors, kernels (K, Cin, Cout): ``convert.tensor_tree``), resolved into the
models' weights inside autograd on every forward (``convert.resolve_*``), so
checkpoints and optimizer moments are the JAX package's trees as they are.

The optimizer is optax's ``chain(clip_by_global_norm(clip),
scale_by_adam(), scale_by_schedule(-lr))`` written out as optax computes
it: the clip divides by the global norm and multiplies by ``clip`` only when
the norm is at least ``clip``; Adam's bias corrections are computed in f32
and applied to each moment before the square root.
``torch.nn.utils.clip_grad_norm_`` (which divides by ``norm + 1e-6``) and
``torch.optim.Adam`` (which folds the corrections into the step size) are
other functions.

``compute_dtype=torch.bfloat16`` is the JAX package's mixed precision: the
tree is cast and then resolved inside the loss (so the gradients reach the
f32 masters as f32), the inputs cast, and the losses, the optimizer and the
EMA stay f32. Draws: the student's z is fed (``z=``) or drawn on the
device from a generator seeded by ``np.random.SeedSequence`` of the state's
JAX key (uint32[2]) and the step; the student's test loss draws its z from a
fixed-seed generator (JAX: ``PRNGKey(0)``).

Data parallelism (``mesh``, a ``parallel.make_mesh`` DeviceMesh): the state
is replicated and each rank's batch is its block of the global batch. The
vocoders have no quantizer and every loss is a mean over equal shards, so
the average of the ranks' gradients, taken in ONE all-reduce before the
global-norm clip (the clip's norm is the global gradient's), is the global
batch's gradient, and the update, the clip and the EMA are the
single-device step's. The student's z is drawn for the global batch from
the same generator on every rank and sliced (a fed z is global too); the
frozen teacher is broadcast from data rank 0. The returned losses are the
global means.
"""
import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from vqvae_speech_tpu_torch.convert import (
    numpy_tree,
    resolve_gaussian_wavenet,
    resolve_student,
    tensor_tree,
)
from vqvae_speech_tpu_torch.models.clarinet import (
    gaussian_wavenet_apply,
    gaussian_wavenet_core,
    gaussian_wavenet_upsample,
    wavenet_student_apply,
)
from vqvae_speech_tpu_torch.models.clarinet.loss import (
    gaussian_loss,
    kl_loss,
    stft_frame_loss,
)
from vqvae_speech_tpu_torch.models.clarinet.modules import check_compute_dtype
from vqvae_speech_tpu_torch.models.flowavenet import flowavenet_forward
from vqvae_speech_tpu_torch.train.checkpoint import (
    EmptyState,
    ScaleByAdamState,
    ScaleByScheduleState,
    dump_pickle,
    load_checkpoint,
)
from vqvae_speech_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    barrier,
    check_mesh,
    global_mean,
    global_rows,
    is_writer,
    replicate,
    shard_batch,
    shard_rows,
)
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger

LR_HALVING_STEPS = (200_000, 400_000, 600_000)  # reference train.py:75-86
# optax.scale_by_adam's defaults (eps_root 0 drops out of the formula)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def step_lr_schedule(base_lr: float, boundaries=LR_HALVING_STEPS):
    """ClariNet milestones: halve at 200k/400k/600k, then hold.

    NOTE (PARITY #31): the reference INTENDS this but its implementation
    mutates ``param_group['learning_rate']`` (torch keys it ``'lr'``), so it
    actually trains at a constant LR. This is the intended schedule."""
    def schedule(step):
        return base_lr * 0.5 ** sum(step >= b for b in boundaries)
    return schedule


def steplr_schedule(base_lr: float, halve_every: int = 200_000):
    """FloWaveNet's torch StepLR(step_size=200000, gamma=0.5) (reference
    flow train.py:253, PARITY #32): halve every 200k steps, indefinitely."""
    def schedule(step):
        return base_lr * 0.5 ** (step // halve_every)
    return schedule


def tree_leaves(tree) -> list:
    """A tree's tensors in JAX's flatten order (dict keys sorted): the
    order of the optimizer's leaf lists."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree, requires_grad=False)


@dataclasses.dataclass
class VocoderOptState:
    """optax's chain state: the clip's (empty), ``ScaleByAdamState(count,
    mu, nu)`` with the moments as trees shaped like the parameters, and
    ``ScaleByScheduleState(count)``."""
    count: int
    mu: Any
    nu: Any
    schedule_count: int

    def as_optax(self):
        """The host form a checkpoint holds (optax's NamedTuples)."""
        return (EmptyState(),
                ScaleByAdamState(np.asarray(self.count, np.int32),
                                 numpy_tree(self.mu), numpy_tree(self.nu)),
                ScaleByScheduleState(np.asarray(self.schedule_count,
                                                np.int32)))

    @classmethod
    def from_optax(cls, opt_state, device):
        """From a checkpoint's (empty, adam, schedule) states, optax's own
        or the stand-ins ``train.checkpoint.load_checkpoint`` gives."""
        _, adam, schedule = opt_state
        count, mu, nu = adam
        return cls(int(np.asarray(count)), tensor_tree(mu, device),
                   tensor_tree(nu, device), int(np.asarray(schedule[0])))


class VocoderOptimizer:
    """``optax.chain(clip_by_global_norm(clip_norm), scale_by_adam(),
    scale_by_schedule(lambda step: -schedule(step)))``, term for term, as
    multi-tensor (``torch._foreach``) operations over the leaf list."""

    def __init__(self, schedule, clip_norm: float):
        self.schedule = schedule
        self.clip_norm = clip_norm

    def init(self, params) -> VocoderOptState:
        return VocoderOptState(0, _zeros_like(params), _zeros_like(params), 0)

    @torch.no_grad()
    def update(self, params, grads, state: VocoderOptState) -> None:
        """One update of ``params`` (a tree) from ``grads`` (its leaves, in
        ``tree_leaves`` order), both it and ``state`` in place."""
        p, g = tree_leaves(params), list(grads)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        # clip_by_global_norm: sqrt of the sum of every leaf's squares;
        # (g / norm) * clip where norm >= clip
        norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
        if norm.item() >= self.clip_norm:
            g = torch._foreach_div(g, norm)
            torch._foreach_mul_(g, self.clip_norm)
        # scale_by_adam: mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu
        torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, g, alpha=1.0 - _B1)
        torch._foreach_mul_(nu, _B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - _B2)
        state.count += 1
        t = np.float32(state.count)
        bc1 = float(np.float32(1) - np.float32(_B1) ** t)
        bc2 = float(np.float32(1) - np.float32(_B2) ** t)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        # scale_by_schedule: the step size at the schedule's own count, in
        # f32, then apply_updates
        lr = float(np.float32(-self.schedule(state.schedule_count)))
        state.schedule_count += 1
        torch._foreach_mul_(update, lr)
        torch._foreach_add_(p, update)


def make_vocoder_optimizer(learning_rate: float, clip_norm: float,
                           halve_every: Optional[int] = None):
    """Adam + global-norm clip + LR schedule. ``halve_every`` selects the
    flow-style StepLR; the default is the ClariNet milestone schedule."""
    schedule = (steplr_schedule(learning_rate, halve_every)
                if halve_every else step_lr_schedule(learning_rate))
    return VocoderOptimizer(schedule, clip_norm)


@dataclasses.dataclass
class VocoderTrainState:
    """The trainable tree (f32 leaf tensors on one device), the optimizer
    state, the weight-EMA shadow (reference modules.py:127-138), the step
    count and the JAX-format key (uint32[2]) the student's draws are
    seeded from."""
    params: Any
    opt_state: VocoderOptState
    ema_params: Any
    step: int
    rng: np.ndarray

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device


def _ema_update(ema, params, decay: float) -> None:
    """shadow = decay * new + (1 - decay) * shadow, in place: the
    reference's direction (modules.py:136-138, PARITY #27: the NEW value
    gets weight ``decay``)."""
    with torch.no_grad():
        shadow = tree_leaves(ema)
        new = torch._foreach_mul(tree_leaves(params), decay)
        torch._foreach_mul_(shadow, 1.0 - decay)
        torch._foreach_add_(shadow, new)


def create_vocoder_state(params, optimizer: VocoderOptimizer, *, device,
                         seed: int = 0) -> VocoderTrainState:
    """A fresh state on ``device`` ("cuda", or "cpu" when the caller asks;
    there is no default) from a JAX-layout tree (numpy or tensors): the
    parameters as trainable f32 leaves, the EMA a copy of them, the key
    ``PRNGKey(seed)``'s uint32[2] (as the JAX package's state holds)."""
    params = tensor_tree(params, device, requires_grad=True)
    return VocoderTrainState(params, optimizer.init(params),
                             tensor_tree(params, device), 0,
                             np.array([0, seed], np.uint32))


def step_generator(key, step: int, device) -> torch.Generator:
    """The generator of one step's draws on ``device``: seeded from the
    state's uint32[2] key and the step, mixed by ``np.random.SeedSequence``
    (a CPU generator keeps 32 bits of its seed)."""
    words = [int(w) for w in np.asarray(key, np.uint32).ravel()] + [step]
    seed = int(np.random.SeedSequence(words).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _check_batch(state: VocoderTrainState, batch) -> None:
    for name in ("x", "c"):
        if batch[name].device != state.device:
            raise ValueError(f"batch[{name!r}] is on {batch[name].device} but "
                             f"the parameters are on {state.device}; move the "
                             "batch to the parameters' device")


def _cast_dtype(compute_dtype):
    """The dtype to cast to: None at f32."""
    check_compute_dtype(compute_dtype)
    return compute_dtype if compute_dtype == torch.bfloat16 else None


def _apply_update(state, loss, optimizer, ema_decay, mesh=None):
    leaves = tree_leaves(state.params)
    # a leaf the loss does not reach (the last resblock's residual conv)
    # gets a zero gradient, as jax.grad gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    grads = all_reduce_mean(grads, mesh)
    optimizer.update(state.params, grads, state.opt_state)
    if ema_decay is not None:
        _ema_update(state.ema_params, state.params, ema_decay)
    state.step += 1


def make_teacher_train_step(cfg, optimizer: VocoderOptimizer,
                            ema_decay: float = 0.9999, mesh=None,
                            compute_dtype=None):
    """Returns ``step(state, batch) -> (state, loss)``: the teacher-forced
    Gaussian NLL of the next sample, backward, the update and the EMA.
    ``batch`` holds ``x`` (B, T, 1) and ``c`` (B, Tc, cin) on the state's
    device; the state is updated in place; ``loss`` is a 0-d f32 tensor on
    the device. With ``mesh`` (module docstring) ``batch`` is this rank's
    block and ``loss`` the global mean."""
    check_mesh(mesh)
    cast = _cast_dtype(compute_dtype)

    def loss_fn(params, batch):
        x, c = batch["x"], batch["c"]
        resolved = resolve_gaussian_wavenet(params, cfg, cast)
        if cast is not None:
            y_hat = gaussian_wavenet_apply(resolved, cfg, x.to(cast),
                                           c.to(cast)).float()
        else:
            y_hat = gaussian_wavenet_apply(resolved, cfg, x, c)
        # predict the NEXT sample (y_hat[:, :-1] vs x[:, 1:])
        return gaussian_loss(y_hat[:, :-1], x[:, 1:]).mean()

    def step(state: VocoderTrainState, batch):
        _check_batch(state, batch)
        loss = loss_fn(state.params, batch)
        _apply_update(state, loss, optimizer, ema_decay, mesh)
        return state, global_mean(loss.detach(), mesh)

    return step


def _distillation_loss(s_params, student_cfg, t_resolved, teacher_cfg, x, c,
                       z, kl_type, stft_filter, stft_hop, cast):
    if cast is not None:
        c, z = c.to(cast), z.to(cast)
    c_up = gaussian_wavenet_upsample(t_resolved, c, teacher_cfg)
    x_s, mu_s, logs_s = wavenet_student_apply(
        resolve_student(s_params, student_cfg, cast), student_cfg, z, c_up)
    mu_logs_t = gaussian_wavenet_core(t_resolved, teacher_cfg, x_s, c_up)
    x_s, mu_s, logs_s = x_s.float(), mu_s.float(), logs_s.float()
    mu_logs_t = mu_logs_t.float()
    mu_t, logs_t = mu_logs_t[:, :-1, 0:1], mu_logs_t[:, :-1, 1:2]
    if kl_type == "pq":
        total, kl, reg = kl_loss(mu_t, logs_t, mu_s, logs_s)
    else:
        total, kl, reg = kl_loss(mu_s, logs_s, mu_t, logs_t)
    frame = stft_frame_loss(x_s[:, 1:, 0], x[:, 1:, 0], stft_filter, stft_hop)
    return total + frame, {"kl": kl, "reg": reg, "frame": frame}


def _frozen_teacher(teacher_params, teacher_cfg, device, cast, mesh=None):
    """The teacher's tree resolved once, without gradients (the student's
    gradient still flows through its activations); with ``mesh``, data rank
    0's tree."""
    with torch.no_grad():
        tree = replicate(tensor_tree(teacher_params, device), mesh)
        return resolve_gaussian_wavenet(tree, teacher_cfg, cast)


def make_student_train_step(teacher_cfg, student_cfg, teacher_params,
                            optimizer: VocoderOptimizer,
                            ema_decay: float = 0.9999, kl_type: str = "qp",
                            stft_filter: int = 1024, stft_hop: int = 256,
                            mesh=None, compute_dtype=None, *, device):
    """Probability-density distillation step: ``step(state, batch, z=None)
    -> (state, (loss, aux))`` with aux the mean KL, reg and frame loss.
    The frozen teacher (a JAX-layout tree, numpy or tensors: the teacher
    checkpoint's EMA params) is resolved once on ``device``. z (B, T, 1)
    is fed, or drawn in f32 on the device from ``step_generator(state.rng,
    state.step)``; at bf16 it is cast after the draw. With ``mesh`` (module
    docstring) z is drawn, or fed, for the global batch and sliced, and the
    losses are global means."""
    check_mesh(mesh)
    cast = _cast_dtype(compute_dtype)
    t_resolved = _frozen_teacher(teacher_params, teacher_cfg, device, cast,
                                 mesh)

    def step(state: VocoderTrainState, batch, z=None):
        _check_batch(state, batch)
        x = batch["x"]
        if z is None:
            z = torch.randn((global_rows(x.shape[0], mesh),) + x.shape[1:],
                            device=x.device,
                            generator=step_generator(state.rng, state.step,
                                                     x.device))
        if mesh is not None:
            z = shard_rows(z, mesh)
        loss, aux = _distillation_loss(
            state.params, student_cfg, t_resolved, teacher_cfg, x,
            batch["c"], z, kl_type, stft_filter, stft_hop, cast)
        _apply_update(state, loss, optimizer, ema_decay, mesh)
        return state, (global_mean(loss.detach(), mesh),
                       {k: global_mean(v.detach(), mesh)
                        for k, v in aux.items()})

    return step


def make_flow_train_step(cfg, optimizer: VocoderOptimizer, mesh=None,
                         compute_dtype=None):
    """FloWaveNet MLE step: ``step(state, batch) -> (state, (loss, aux))``,
    loss = -(log_p + logdet), aux ``log_p`` and ``logdet``; no EMA (the
    reference evaluates and serves the raw flow). With ``mesh`` (module
    docstring) the losses are global means."""
    check_mesh(mesh)
    check_compute_dtype(compute_dtype)

    def step(state: VocoderTrainState, batch):
        _check_batch(state, batch)
        log_p, logdet = flowavenet_forward(state.params, cfg, batch["x"],
                                           batch["c"],
                                           compute_dtype=compute_dtype)
        loss = -(log_p + logdet)
        _apply_update(state, loss, optimizer, None, mesh)
        return state, (global_mean(loss.detach(), mesh),
                       {"log_p": global_mean(log_p.detach(), mesh),
                        "logdet": global_mean(logdet.detach(), mesh)})

    return step


def make_teacher_eval_loss(cfg):
    """Test loss of the teacher (reference train.py:117-136: the Gaussian NLL
    of the EMA model on the test loader): ``loss(params, batch)``."""

    @torch.no_grad()
    def loss(params, batch):
        y_hat = gaussian_wavenet_apply(resolve_gaussian_wavenet(params, cfg),
                                       cfg, batch["x"], batch["c"])
        return gaussian_loss(y_hat[:, :-1], batch["x"][:, 1:]).mean()

    return loss


def make_student_eval_loss(teacher_cfg, student_cfg, teacher_params,
                           kl_type: str = "qp", stft_filter: int = 1024,
                           stft_hop: int = 256, *, device):
    """Distillation test loss (reference train_student.py evaluate(): the
    same KL + reg + frame objective with the EMA student). z is drawn from a
    generator seeded 0 at every call, so the gate is the same function of
    the parameters at every epoch."""
    t_resolved = _frozen_teacher(teacher_params, teacher_cfg, device, None)

    @torch.no_grad()
    def loss(params, batch):
        x = batch["x"]
        z = torch.randn(x.shape, device=x.device,
                        generator=torch.Generator(device=x.device)
                        .manual_seed(0))
        total, _ = _distillation_loss(params, student_cfg, t_resolved,
                                      teacher_cfg, x, batch["c"], z, kl_type,
                                      stft_filter, stft_hop, None)
        return total

    return loss


def make_flow_eval_loss(cfg):
    """Test loss of FloWaveNet (reference flow train.py:92-110)."""

    @torch.no_grad()
    def loss(params, batch):
        log_p, logdet = flowavenet_forward(params, cfg, batch["x"],
                                           batch["c"])
        return -(log_p + logdet)

    return loss


def _device_batch(batch, device):
    """A loader's host batch as tensors on ``device`` (``x`` and ``c``,
    the keys the steps read)."""
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in ("x", "c")}


class VocoderTrainer:
    """Epoch loop + best-loss checkpointing (reference train.py:281-284).

    With an ``eval_loader`` and ``eval_loss_fn`` the 'best' checkpoint is
    gated on the TEST loss after each epoch, the reference's contract
    (clarinet train.py:273-283 evaluates the EMA model, flow
    train.py:288-293 the raw one; ``eval_on_ema`` selects). Without, the
    gate is the train epoch's mean loss. The loaders yield host batches
    (``data.ljspeech.LJSpeechLoader``); each is moved to the state's
    device. On a GPU the trainer turns TF32 off for cuDNN and matmuls: the
    f32 model trains in f32.

    With ``mesh`` (a data-parallel ``step_fn`` made with the same mesh) the
    state is broadcast from data rank 0, each rank's loader yields the same
    global batches and the trainer hands the step this rank's block; the
    test loss is the whole test batch's on every rank; rank 0 alone writes
    the checkpoints, the loss files and the samples, and every rank waits
    for it."""

    def __init__(self, step_fn, state: VocoderTrainState, loader,
                 checkpoint_dir: str, name: str, eval_loader=None,
                 eval_loss_fn=None, eval_on_ema: bool = True, on_best=None,
                 mesh=None):
        check_mesh(mesh)
        self._mesh = mesh
        replicate([state.params, state.ema_params, state.opt_state.mu,
                   state.opt_state.nu], mesh)
        self._step_fn = step_fn
        self.state = state
        self._loader = loader
        self._eval_loader = eval_loader
        self._eval_loss_fn = eval_loss_fn
        self._eval_on_ema = eval_on_ema
        self._on_best = on_best
        self._dir = checkpoint_dir
        self._name = name
        self.best_loss = np.inf
        # per-epoch loss histories persisted like the reference's
        # {name}_train.npy / {name}.npy (train.py:284-296)
        self.train_losses = []
        self.eval_losses = []
        os.makedirs(checkpoint_dir, exist_ok=True)
        if state.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    def evaluate(self):
        """Mean eval loss over the test loader (reference evaluate())."""
        if self._eval_loader is None or self._eval_loss_fn is None:
            return None
        params = (self.state.ema_params if self._eval_on_ema
                  else self.state.params)
        total, count = 0.0, 0
        for batch in self._eval_loader:
            total += float(self._eval_loss_fn(
                params, _device_batch(batch, self.state.device)))
            count += 1
        return total / max(count, 1)

    def train_epoch(self, epoch: int):
        total, count = 0.0, 0
        for batch in self._loader:
            self.state, out = self._step_fn(
                self.state, _device_batch(shard_batch(batch, self._mesh),
                                          self.state.device))
            loss = out[0] if isinstance(out, tuple) else out
            total += float(loss)
            count += 1
        avg = total / max(count, 1)
        gate = self.evaluate()
        if gate is None:
            ConsoleLogger.status(
                f"{self._name} epoch {epoch}: loss {avg:.4f}")
            gate = avg
        else:
            ConsoleLogger.status(
                f"{self._name} epoch {epoch}: loss {avg:.4f} "
                f"test {gate:.4f}")
        self.train_losses.append(avg)
        self.eval_losses.append(gate)
        # the gate is compared BEFORE the epoch's save, so the epoch
        # checkpoint records this epoch's best_loss (a resume from it must
        # not let a later, worse epoch overwrite {name}_best.pkl)
        new_best = gate < self.best_loss
        if new_best:
            self.best_loss = gate
        if is_writer():
            np.save(os.path.join(self._dir, f"{self._name}_train.npy"),
                    np.asarray(self.train_losses))
            np.save(os.path.join(self._dir, f"{self._name}.npy"),
                    np.asarray(self.eval_losses))
            self.save(epoch, avg)
            if new_best:
                self.save(epoch, gate, best=True)
                if self._on_best is not None:
                    # reference: synthesize a sample whenever a new best is
                    # saved (flow train.py:290-295)
                    self._on_best(self.state, epoch)
        barrier(self._mesh)
        return avg

    def save(self, epoch, loss, best=False):
        """``{name}_{epoch}.pkl`` or ``{name}_best.pkl`` in the JAX
        package's format: host trees in the JAX layout, optax-named
        optimizer state, the step and the uint32[2] key."""
        payload = {
            "epoch": epoch,
            "loss": loss,
            "params": numpy_tree(self.state.params),
            "ema_params": numpy_tree(self.state.ema_params),
            "opt_state": self.state.opt_state.as_optax(),
            "step": int(self.state.step),
            "rng": np.asarray(self.state.rng, np.uint32),
            "train_losses": list(self.train_losses),
            "eval_losses": list(self.eval_losses),
            "best_loss": float(min(self.best_loss, loss)
                               if best else self.best_loss),
        }
        suffix = "best" if best else str(epoch)
        return dump_pickle(payload, os.path.join(
            self._dir, f"{self._name}_{suffix}.pkl"))


def restore_vocoder_trainer(trainer: VocoderTrainer, path: str) -> int:
    """Resume a VocoderTrainer from a checkpoint of either package (the
    reference's --load_step, clarinet train.py:261-266: model, optimizer,
    EMA, the loss histories and the running best test loss), on the device
    of the trainer's state. A checkpoint's key is kept as it is: the port
    seeds its draws from it. Returns the next epoch to train."""
    ckpt = load_vocoder_checkpoint(path)
    device = trainer.state.device
    trainer.state = VocoderTrainState(
        tensor_tree(ckpt["params"], device, requires_grad=True),
        VocoderOptState.from_optax(ckpt["opt_state"], device),
        tensor_tree(ckpt["ema_params"], device), int(ckpt["step"]),
        (np.asarray(ckpt["rng"], np.uint32) if "rng" in ckpt
         else trainer.state.rng))
    trainer.train_losses = list(ckpt.get("train_losses", []))
    trainer.eval_losses = list(ckpt.get("eval_losses", []))
    trainer.best_loss = float(ckpt.get(
        "best_loss", min(trainer.eval_losses, default=np.inf)))
    return int(ckpt["epoch"]) + 1


def load_vocoder_checkpoint(path: str) -> dict:
    """A vocoder checkpoint of either package, without optax: the optimizer
    state's NamedTuples come back as tuples (``train.checkpoint``). Unpickling
    runs code named in the file: load only checkpoints this project wrote."""
    return load_checkpoint(path)
