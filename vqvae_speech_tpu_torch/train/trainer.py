"""The convolutional VQ-VAE's train step.

Counterpart of ``vqvae_speech_tpu/train/trainer.py``'s ``make_optimizer``,
``create_train_state``, ``make_train_step`` and ``make_grad_stats_fn``: one
step is forward, MSE + VQ loss, backward, an Adam-amsgrad update and the EMA
codebook state update. The model is an ``nn.Module`` (``models.ConvVQVAE``)
that carries its parameters and its EMA and revival state as buffers; the step
updates it in place.

The optimizer is optax's ``amsgrad`` written out, NOT
``torch.optim.Adam(amsgrad=True)``: optax keeps the running maximum over the
BIAS-CORRECTED second moment and divides by ``sqrt(nu_max) + eps``; PyTorch's
keeps it over the raw second moment and corrects afterwards, and the two part
from the second step whenever |g1| > |g2|. Its state is optax's
``(count, mu, nu, nu_max)``, so checkpoints carry over in both directions
(``convert.export_jax_opt_state`` / ``load_jax_opt_state``).

Not ported here: ``compute_dtype`` (bf16 forward and backward with f32 master
weights) and ``mesh`` (data parallelism); both raise. The epoch loop
(``ConvolutionalTrainer``) is a later slice.
"""
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from vqvae_speech_tpu_torch.convert import nest_by_path, jax_param_leaves
from vqvae_speech_tpu_torch.ops.vq import reference_flatten
from vqvae_speech_tpu_torch.train.revival import apply_revival, revival_settings
from vqvae_speech_tpu_torch.utils import resolve_device

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


def _loss(model, batch, jitter_masks, generator):
    out = model(batch["input_features"], batch.get("speaker_id"),
                jitter_masks=jitter_masks, jitter_generator=generator)
    recon = torch.mean(
        (out.reconstructed_x.float() - batch["output_features"].float()) ** 2)
    return out.vq_loss.float() + recon, recon, out


def _check_batch_device(batch, device) -> None:
    for name, value in batch.items():
        if value.device != device:
            raise ValueError(
                f"batch[{name!r}] is on {value.device} but the model is on "
                f"{device}; move the batch to the model's device")


def _refuse_unported(config: dict, mesh) -> None:
    if config.get("compute_dtype") is not None:
        raise NotImplementedError(
            "compute_dtype (bf16 training with f32 master weights) is not "
            "ported: it lands with the port's bf16 paths (ROADMAP items 11.4 "
            "and 12.6)")
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
    the step's own draws (tests feed the JAX package's).
    """
    _refuse_unported(config, mesh)
    revival, rev_decay, rev_threshold = revival_settings(config)

    def step(state: TrainState, batch, *, jitter_masks=None,
             revival_perm=None):
        model = state.model
        params = list(model.parameters())
        _check_batch_device(batch, params[0].device)
        loss, recon, out = _loss(model, batch, jitter_masks, state.rng)
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
    model whose state may move or restore it afterwards."""
    _refuse_unported(config, None)

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
