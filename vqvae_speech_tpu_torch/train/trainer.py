"""The convolutional VQ-VAE's train step and epoch loop.

Counterpart of ``vqvae_speech_tpu/train/trainer.py``'s ``make_optimizer``,
``create_train_state``, ``make_train_step``, ``make_grad_stats_fn`` and
``ConvolutionalTrainer``: one step is forward, MSE + VQ loss, backward, an
Adam-amsgrad update and the EMA codebook state update; the trainer runs
epochs of steps over a prefetched loader, with per-epoch checkpoints and the
codebook- and gradient-statistics hooks. The model is an ``nn.Module`` (``models.ConvVQVAE``)
that carries its parameters and its EMA and revival state as buffers; the step
updates it in place.

The optimizer is optax's ``amsgrad`` written out, NOT
``torch.optim.Adam(amsgrad=True)``: optax keeps the running maximum over the
BIAS-CORRECTED second moment and divides by ``sqrt(nu_max) + eps``; PyTorch's
keeps it over the raw second moment and corrects afterwards, and the two part
from the second step whenever |g1| > |g2|. Its state is optax's
``(count, mu, nu, nu_max)``, so checkpoints carry over in both directions
(``convert.export_jax_opt_state`` / ``load_jax_opt_state``).

``compute_dtype: bfloat16`` in the configuration runs the forward and the
backward on a bf16 cast of the floating parameters and of
``input_features`` (``nn.cast.cast_call``, so autograd through the cast delivers f32 gradients to the f32 masters, as
JAX's does); the amsgrad state, the losses, the metrics and the EMA state
stay f32, and the codebook search runs in f32 on the rounded latents
(``models/vq.py``). Not ported: ``mesh`` (data parallelism), which raises.
"""
import dataclasses
import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from vqvae_speech_tpu_torch.convert import (
    export_jax_opt_state,
    export_jax_params,
    jax_param_leaves,
    load_jax_opt_state,
    load_jax_params,
    nest_by_path,
)
from vqvae_speech_tpu_torch.data.prefetch import prefetch_to_device
from vqvae_speech_tpu_torch.models.conv_vqvae import ConvVQVAE
from vqvae_speech_tpu_torch.nn.cast import cast_call
from vqvae_speech_tpu_torch.ops.vq import reference_flatten
from vqvae_speech_tpu_torch.train.checkpoint import save_checkpoint
from vqvae_speech_tpu_torch.train.revival import apply_revival, revival_settings
from vqvae_speech_tpu_torch.utils import resolve_device
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger
from vqvae_speech_tpu_torch.utils.profiling import StepTimer

# optax.amsgrad's defaults, the only values the trainer uses (its eps_root
# is 0 and drops out of the formula)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AmsgradState:
    """optax's ``ScaleByAmsgradState``; the three moment lists are in the
    order of the parameter list the optimizer was initialised with."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    nu_max: List[torch.Tensor]


class Amsgrad:
    """``optax.amsgrad(learning_rate)``: ``scale_by_amsgrad`` then a scale by
    ``-learning_rate``, term for term, as multi-tensor (``torch._foreach``)
    operations over the whole parameter list: a handful of device launches a
    step, not ten a leaf."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params) -> AmsgradState:
        params = list(params)
        return AmsgradState(0, *([torch.zeros_like(p) for p in params]
                                 for _ in range(3)))

    @torch.no_grad()
    def update(self, params, grads, state: AmsgradState) -> None:
        """One update of ``params`` and ``state``, both in place."""
        params, grads = list(params), list(grads)
        b1, b2 = _B1, _B2
        # mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        state.count += 1
        # the bias corrections in f32, as optax computes them
        t = np.float32(state.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        # nu_max = max(nu_max, nu / (1 - b2^t)): over the CORRECTED moment
        torch._foreach_maximum_(state.nu_max, torch._foreach_div(state.nu, bc2))
        denom = torch._foreach_sqrt(state.nu_max)    # optax's eps_root is 0
        torch._foreach_add_(denom, _EPS)
        step = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-self.learning_rate)


def make_optimizer(learning_rate: float) -> Amsgrad:
    """Adam with amsgrad, optax's form (reference
    convolutional_trainer.py:41-42)."""
    return Amsgrad(learning_rate)


@dataclasses.dataclass
class TrainState:
    """The model (parameters, EMA and revival buffers), the optimizer's
    moments over ``list(model.parameters())``, and the generator the jitter
    masks and the revival permutations are drawn from."""
    model: torch.nn.Module
    opt_state: AmsgradState
    rng: torch.Generator


def create_train_state(model, optimizer: Amsgrad, *, device, seed: int = 1234,
                       opt_state: Optional[AmsgradState] = None) -> TrainState:
    """A train state around ``model``, moved to ``device`` ("cuda", or "cpu"
    when the caller asks for it; there is no default) and put into training
    mode. A given ``opt_state`` is moved along. The draws of a step come
    from a CPU generator seeded with ``seed``, so one seed gives one
    sequence of masks on any device."""
    device = resolve_device(device)
    model.to(device).train()
    if opt_state is None:
        opt_state = optimizer.init(model.parameters())
    else:
        for moments in (opt_state.mu, opt_state.nu, opt_state.nu_max):
            moments[:] = [m.to(device) for m in moments]
    return TrainState(model, opt_state, torch.Generator().manual_seed(seed))


_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(config: dict) -> Optional[torch.dtype]:
    """The configuration's ``compute_dtype`` (a dtype name or None) as a
    torch dtype, or None."""
    name = config.get("compute_dtype")
    if name is None:
        return None
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}: expected one of "
                         f"{sorted(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


def _loss(model, batch, jitter_masks, generator, compute_dtype=None):
    x = batch["input_features"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    out = cast_call(model, compute_dtype, (x, batch.get("speaker_id")),
                    dict(jitter_masks=jitter_masks,
                         jitter_generator=generator))
    recon = torch.mean(
        (out.reconstructed_x.float() - batch["output_features"].float()) ** 2)
    return out.vq_loss.float() + recon, recon, out


def _check_batch_device(batch, device) -> None:
    for name, value in batch.items():
        if value.device != device:
            raise ValueError(
                f"batch[{name!r}] is on {value.device} but the model is on "
                f"{device}; move the batch to the model's device")


def _refuse_unported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is not ported (ROADMAP item "
            "14); the step runs on one device")


def make_train_step(config: dict, optimizer: Amsgrad, mesh=None):
    """Returns ``step(state, batch, *, jitter_masks=None, revival_perm=None)
    -> (state, metrics)``.

    ``batch`` holds ``input_features`` and ``output_features`` (B, T, C) and,
    for a speaker-conditioned model, ``speaker_id`` (B,), on the model's
    device: a batch tensor on another device raises, it is not moved. The
    step updates ``state`` in place and returns it. ``metrics``
    has the JAX step's keys (``reconstruction_loss``, ``loss``,
    ``perplexity``, the VQ terms and, with revival, ``revived_codes``) as 0-d
    f32 tensors left on the device: reading one is the caller's sync.
    ``jitter_masks`` = (replace, direction) and ``revival_perm`` stand in for
    the step's own draws (tests feed the JAX package's). With
    ``compute_dtype`` in the configuration the forward and backward run in
    that dtype (see the module docstring); the metrics are f32 either way.
    """
    _refuse_unported(mesh)
    compute_dtype = compute_dtype_of(config)
    revival, rev_decay, rev_threshold = revival_settings(config)

    def step(state: TrainState, batch, *, jitter_masks=None,
             revival_perm=None):
        model = state.model
        params = list(model.parameters())
        _check_batch_device(batch, params[0].device)
        loss, recon, out = _loss(model, batch, jitter_masks, state.rng,
                                 compute_dtype)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        optimizer.update(params, grads, state.opt_state)
        metrics = {k: v.detach().float() for k, v in out.losses.items()}
        metrics["reconstruction_loss"] = recon.detach()
        metrics["loss"] = loss.detach()
        metrics["perplexity"] = out.perplexity.detach().float()
        if revival:
            flat = reference_flatten(
                out.pre_vq_latents.float().transpose(1, 2),
                config["embedding_dim"])
            metrics["revived_codes"] = apply_revival(
                model, out.counts.detach().float(), flat, rev_decay,
                rev_threshold, perm=revival_perm, generator=state.rng)
        return state, metrics

    return step


def make_grad_stats_fn(config: dict):
    """Returns ``fn(state, batch, *, jitter_masks=None) -> (means, maxs)``:
    |grad| mean and max of every parameter leaf (for the gradient-flow plots;
    reference src/evaluation/gradient_stats.py:38-52), as two trees with the
    JAX package's param-tree names. Changes neither parameters nor the
    optimizer; an EMA model's buffers do take the forward's update, so pass a
    model whose state may move or restore it afterwards. The statistics are
    taken in f32 whatever the configuration's ``compute_dtype``, as the JAX
    package takes them."""

    def fn(state: TrainState, batch, *, jitter_masks=None):
        model = state.model
        leaves = jax_param_leaves(model)
        params = [leaf.tensor for leaf in leaves]
        _check_batch_device(batch, params[0].device)
        # the jitter draws come from a copy: the state's generator stays put
        rng = torch.Generator().set_state(state.rng.get_state())
        loss, _, _ = _loss(model, batch, jitter_masks, rng)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        means = nest_by_path((leaf.path, g.abs().mean())
                             for leaf, g in zip(leaves, grads))
        maxs = nest_by_path((leaf.path, g.abs().max())
                            for leaf, g in zip(leaves, grads))
        return means, maxs

    return fn


def _flatten_with_names(tree, prefix=""):
    """(keystr, leaf) pairs of a nested dict in JAX's flatten order (sorted
    keys), named as ``jax.tree_util.keystr`` names them."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(_flatten_with_names(tree[key], f"{prefix}['{key}']"))
    return out


def _named_grad_entries(means, maxs):
    """Flatten grad-stats trees into the reference's gradient entry shape
    ({'layers': [...], 'avg_grads': [...], 'max_grads': [...]})."""
    flat_means = _flatten_with_names(means)
    flat_maxs = _flatten_with_names(maxs)
    return {"layers": [name for name, _ in flat_means],
            "avg_grads": [float(v) for _, v in flat_means],
            "max_grads": [float(v) for _, v in flat_maxs]}


class ConvolutionalTrainer:
    """Epoch loop + recording + per-epoch checkpointing.

    Takes the model as the JAX package's trainer does: ``params`` and
    ``model_state`` trees in the JAX layout (``convert.numpy_params``, or a
    checkpoint's) and, to resume, the checkpoint's ``opt_state`` and
    ``start_epoch``; ``device`` ("cuda", or "cpu" when the caller asks for
    it) is where it trains; on a GPU it turns TF32 off for cuDNN and
    matmuls, so the model trains in the configuration's f32. The loop keeps
    each step's metrics on the device and copies them to the host once an
    epoch, before the epoch's log line and checkpoint."""

    def __init__(self, config: dict, params, model_state, training_loader,
                 experiments_path: str, experiment_name: str,
                 seed: int = 1234, mesh=None, start_epoch: int = 0,
                 opt_state=None, iterations_to_record: int = 10, *, device):
        self._config = config
        self._loader = training_loader
        self._experiments_path = experiments_path
        self._experiment_name = experiment_name
        self._start_epoch = start_epoch
        self._iterations_to_record = iterations_to_record
        self._device = resolve_device(device)
        if self._device.type == "cuda":
            # the configuration's f32 (compute_dtype null): PyTorch's default
            # would let cuDNN run the convolutions in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        optimizer = make_optimizer(config["learning_rate"])
        self._step = make_train_step(config, optimizer, mesh)
        self._grad_stats = make_grad_stats_fn(config)
        model = load_jax_params(ConvVQVAE.from_config(config), params,
                                model_state)
        self._state = create_train_state(model, optimizer,
                                         device=self._device, seed=seed)
        if opt_state is not None:
            load_jax_opt_state(model, opt_state, self._state.opt_state)

    @property
    def state(self) -> TrainState:
        return self._state

    def train(self):
        cfg = self._config
        ConsoleLogger.status(f"start epoch: {self._start_epoch}")
        ConsoleLogger.status(f"num epoch: {cfg['num_epochs']}")
        timer = StepTimer() if cfg.get("profile_steps") else None

        for epoch in range(self._start_epoch, cfg["num_epochs"]):
            n_iter = len(self._loader)
            step_rec = max(int(n_iter / self._iterations_to_record) - 1, 1)
            record_iters = set(range(0, n_iter, step_rec))
            batches = prefetch_to_device(iter(self._loader),
                                         device=self._device)
            device_metrics = []
            for iteration, batch in enumerate(batches):
                if (cfg.get("record_gradient_stats")
                        and iteration in record_iters):
                    self._record_gradient_stats(batch, epoch, iteration)
                if timer is not None:
                    with timer.step():
                        self._state, metrics = self._step(self._state, batch)
                        timer.block_on(metrics)
                else:
                    self._state, metrics = self._step(self._state, batch)
                # keep metrics on the device: fetching per step would make
                # the host wait for every step
                device_metrics.append(metrics)
                if (cfg.get("record_codebook_stats")
                        and iteration in record_iters):
                    self._record_codebook_stats(batch, epoch, iteration)
            losses_list, perplexity_list = self._fetch(device_metrics)
            ConsoleLogger.status(
                "Epoch {}: loss {:.4f} perplexity {:.3f}".format(
                    epoch + 1, losses_list[-1]["loss"], perplexity_list[-1]))
            if timer is not None and timer.num_steps:
                s = timer.summary()
                ConsoleLogger.status(
                    "  steps/sec {:.2f} (p50 {:.1f} ms, p95 {:.1f} ms)".format(
                        s["steps_per_sec"], s["p50_s"] * 1e3,
                        s["p95_s"] * 1e3))
            self.save(epoch, losses_list, perplexity_list)
        return self._state

    @staticmethod
    def _fetch(device_metrics):
        """Every step's metrics in ONE device-to-host copy -> the checkpoint's
        loss dicts (perplexity apart) and perplexity list."""
        if not device_metrics:
            raise ValueError("the training loader yielded no batch: fewer "
                             "examples than batch_size")
        keys = sorted(device_metrics[0])
        host = torch.stack([m[k] for m in device_metrics for k in keys]
                           ).cpu().numpy().reshape(len(device_metrics),
                                                   len(keys))
        losses_list, perplexity_list = [], []
        for row in host:
            metrics = {k: float(v) for k, v in zip(keys, row)}
            perplexity_list.append(metrics.pop("perplexity"))
            losses_list.append(metrics)
        return losses_list, perplexity_list

    def save(self, epoch, losses_list=None, perplexity_list=None):
        model = self._state.model
        params, model_state = export_jax_params(model)
        return save_checkpoint(
            self._experiments_path, self._experiment_name, epoch, params,
            model_state, export_jax_opt_state(model, self._state.opt_state),
            train_res_recon_error=losses_list,
            train_res_perplexity=perplexity_list)

    # ---------------- recording hooks ----------------

    def _record_codebook_stats(self, batch, epoch, iteration):
        model = self._state.model
        model.eval()
        with torch.no_grad():
            out = model.encode(batch["input_features"])
        model.train()
        embedding = model.vq.codebook.detach().cpu().numpy()
        idx = out.indices.cpu().numpy()
        entry = {
            "concatenated_quantized": embedding[idx[:, 0]],
            "embedding": embedding,
            "n_embedding": embedding.shape[0],
            "encoding_indices": idx,
            "speaker_ids": batch["speaker_id"].cpu().numpy(),
            "batch_size": int(batch["input_features"].shape[0]),
        }
        path = os.path.join(
            self._experiments_path,
            f"{self._experiment_name}_{epoch + 1}_{iteration}_codebook-stats.pickle")
        with open(path, "wb") as f:
            pickle.dump(entry, f)

    def _record_gradient_stats(self, batch, epoch, iteration):
        vq = self._state.model.vq
        # the JAX hook leaves the state as it is; the port's training forward
        # replaces an EMA quantizer's buffers, so they are put back
        kept = dict(vq.ema_state()) if vq.ema else {}
        means, maxs = self._grad_stats(self._state, batch)
        for name, tensor in kept.items():
            setattr(vq, name, tensor)
        entry = {"model": _named_grad_entries(means, maxs)}
        for part in ("encoder", "vq", "decoder"):
            if means.get(part):
                entry[part] = _named_grad_entries(means[part], maxs[part])
        path = os.path.join(
            self._experiments_path,
            f"{self._experiment_name}_{epoch + 1}_{iteration}_gradient-stats.pickle")
        with open(path, "wb") as f:
            pickle.dump(entry, f)
