"""WaveNet-VQ-VAE training: teacher-forced mu-law cross-entropy + VQ loss.

Counterpart of ``vqvae_speech_tpu/train/wavenet_trainer.py`` (the reference
ships the model and configurations/vctk_wavenet.yaml but no reachable
trainer):

* inputs: the mu-law one-hot of ``preprocessed_audio`` (B, length+1) shifted
  right (teacher forcing: the model sees ``q[:, :-1]`` and predicts
  ``q[:, 1:]``), each input sample zeroed with probability
  ``ar_input_dropout`` when it is set,
* loss: cross-entropy over the ``quantize`` classes + the VQ loss,
* one step: forward (jitter, dropout, the quantizer's EMA state), backward,
  the optax-form amsgrad update (``trainer.Amsgrad``) and, with
  ``codebook_revival``, the revival pass, whose counts are the one-hot sums
  of the step's code indices.

``compute_dtype`` (or ``compute_dtype: bfloat16`` in the configuration) runs
the WaveNet decoder on a bf16 cast of its parameters; the encoder and the
VQ stay f32 (``models/wavenet_vqvae.py``).

The draws of a step come from two generators: ``rng`` (a CPU generator:
the jitter's (T,) masks and revival's permutation, as the flagship step
draws them) and ``dropout_rng`` (on the model's device: the WaveNet's
dropout masks, L of (B, T, C), and the AR-input masks). Tests feed the JAX
package's draws instead (``jitter_masks``, ``dropout_masks``, ``ar_keep``,
``revival_perm``).

With ``mesh`` the step is data-parallel as ``train/trainer.py``'s is (its
module docstring gives the argument): the quantizer searches the global
rows, the gradient list is averaged in one all-reduce, the metrics are
global. The draws are the global batch's: the AR-input keep mask (B,
length) and the dropout masks (B, length, C) are drawn for the global B from
``dropout_rng``, in the single-device step's order, and each rank keeps its
block; fed ``ar_keep`` and ``dropout_masks`` are global too.

``WaveNetTrainer`` is the epoch loop with the JAX trainer's contract:
auto-resume from the newest checkpoint, ``checkpoint_every`` (the last epoch
always saves), ``{name}_history.json`` and ``prune_checkpoints``.
Checkpoints are in the JAX format, so each package resumes from the other's.
A fresh run starts from ``convert.numpy_wavenet_vqvae_params(config,
num_speakers, seed)``: ``wavenet_vqvae_init``'s tree and init distributions
drawn from numpy, with the reference's averaging init of the LC upsample
(``jax.random``'s stream cannot be reproduced, PARITY #3).
"""
import dataclasses
import json
import os
import time
from typing import Optional

import torch
import torch.nn.functional as F

from vqvae_speech_tpu_torch.convert import (
    export_jax_opt_state,
    export_jax_params,
    load_jax_opt_state,
    load_wavenet_vqvae_params,
    numpy_wavenet_vqvae_params,
)
from vqvae_speech_tpu_torch.data.prefetch import prefetch_to_device
from vqvae_speech_tpu_torch.models.wavenet_vqvae import WaveNetVQVAE
from vqvae_speech_tpu_torch.ops.mu_law import mu_law_encode
from vqvae_speech_tpu_torch.ops.vq import reference_flatten
from vqvae_speech_tpu_torch.parallel.mesh import (
    all_gather_rows,
    check_mesh,
    global_mean,
    global_rows,
    shard_rows,
)
from vqvae_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_epoch,
    load_checkpoint,
    prune_checkpoints,
    save_checkpoint,
)
from vqvae_speech_tpu_torch.train.revival import apply_revival, revival_settings
from vqvae_speech_tpu_torch.train.trainer import (
    Amsgrad,
    AmsgradState,
    ConvolutionalTrainer,
    _gradients,
    compute_dtype_of,
    make_optimizer,
)
from vqvae_speech_tpu_torch.utils import resolve_device
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger


@dataclasses.dataclass
class WaveNetTrainState:
    """The model (parameters, EMA and revival buffers), the optimizer's
    moments over ``list(model.parameters())`` and the step's two
    generators (see the module docstring)."""
    model: WaveNetVQVAE
    opt_state: AmsgradState
    rng: torch.Generator
    dropout_rng: torch.Generator


def create_wavenet_train_state(model: WaveNetVQVAE, optimizer: Amsgrad, *,
                               device, seed: int = 1234
                               ) -> WaveNetTrainState:
    """A train state around ``model``, moved to ``device`` ("cuda", or "cpu"
    when the caller asks for it) and put into training mode."""
    device = resolve_device(device)
    model.to(device).train()
    dropout_rng = torch.Generator(device=device)
    dropout_rng.manual_seed(seed)
    return WaveNetTrainState(model, optimizer.init(model.parameters()),
                             torch.Generator().manual_seed(seed), dropout_rng)


def make_wavenet_train_step(config: dict, wavenet_cfg, optimizer: Amsgrad,
                            compute_dtype: Optional[torch.dtype] = None,
                            mesh=None):
    """Returns ``step(state, batch, *, ar_keep=None, jitter_masks=None,
    dropout_masks=None, revival_perm=None) -> (state, metrics)``.

    ``batch`` holds ``preprocessed_audio`` (B, length+1), ``input_features``
    (B, T, C) and ``speaker_id`` (B,) on the model's device. The step
    updates ``state`` in place and returns it; ``metrics`` has the JAX
    step's keys as 0-d f32 tensors left on the device. The keyword arguments
    stand in for the step's draws: ``ar_keep`` (B, length) bool, the AR
    input samples kept; ``jitter_masks`` (replace, direction);
    ``dropout_masks``, one (B, length, residual_channels) bool a layer;
    ``revival_perm``. ``wavenet_cfg`` keeps the JAX function's signature:
    the model carries its own configuration. With ``mesh`` (module
    docstring) ``batch`` is this rank's block and the fed draws are global."""
    check_mesh(mesh)
    quantize = config["quantize"]
    if compute_dtype is None:
        compute_dtype = compute_dtype_of(config)
    revival, rev_decay, rev_threshold = revival_settings(config)
    # anti-posterior-collapse lever of the JAX trainer: zero each
    # teacher-forcing input sample with probability ar_input_dropout
    ar_drop = float(config.get("ar_input_dropout") or 0.0)

    def step(state: WaveNetTrainState, batch, *, ar_keep=None,
             jitter_masks=None, dropout_masks=None, revival_perm=None):
        model = state.model
        params = list(model.parameters())
        device = params[0].device
        for name, value in batch.items():
            if value.device != device:
                raise ValueError(
                    f"batch[{name!r}] is on {value.device} but the model is "
                    f"on {device}; move the batch to the model's device")
        q = mu_law_encode(batch["preprocessed_audio"], quantize)
        # jax.nn.one_hot: a bin outside [0, quantize) is a row of zeros
        x_dec = (q[:, :-1, None]
                 == torch.arange(quantize, device=device)).float()
        if ar_drop:
            if ar_keep is None:
                shape = (global_rows(q.shape[0], mesh), q.shape[1] - 1)
                ar_keep = torch.rand(shape, generator=state.dropout_rng,
                                     device=state.dropout_rng.device
                                     ) < 1.0 - ar_drop
            if mesh is not None:
                ar_keep = shard_rows(ar_keep, mesh)
            x_dec = x_dec * ar_keep.to(device)[..., None].float()
        target = q[:, 1:].long()
        wavenet = model.decoder.wavenet
        if (mesh is not None and dropout_masks is None and model.training
                and wavenet.cfg.dropout > 0):
            dropout_masks = wavenet.dropout_masks(
                (global_rows(q.shape[0], mesh), q.shape[1] - 1,
                 wavenet.cfg.residual_channels), state.dropout_rng,
                state.dropout_rng.device)
        if mesh is not None and dropout_masks is not None:
            dropout_masks = [shard_rows(m, mesh) for m in dropout_masks]
        with model.vq.gathering(mesh):
            out = model(batch["input_features"], x_dec, batch["speaker_id"],
                        jitter_masks=jitter_masks, jitter_generator=state.rng,
                        dropout_masks=dropout_masks,
                        dropout_generator=state.dropout_rng,
                        decoder_compute_dtype=compute_dtype)
        logp = F.log_softmax(out.reconstructed_x, dim=-1)
        ce = -torch.mean(torch.take_along_dim(logp, target[..., None], -1))
        loss = ce + out.vq_loss
        grads = _gradients(loss, params, mesh)
        optimizer.update(params, grads, state.opt_state)
        metrics = {k: v.detach().float() for k, v in out.losses.items()}
        if mesh is not None:
            ce = global_mean(ce, mesh)
            loss = ce + out.vq_loss
        metrics["reconstruction_loss"] = ce.detach()
        metrics["loss"] = loss.detach()
        metrics["perplexity"] = out.perplexity.detach().float()
        if revival:
            K = config["num_embeddings"]
            counts = F.one_hot(out.encoding_indices.reshape(-1).long(),
                               K).sum(0).float()
            flat = reference_flatten(
                all_gather_rows(out.pre_vq_latents, mesh).float()
                .transpose(1, 2), config["embedding_dim"])
            metrics["revived_codes"] = apply_revival(
                model, counts, flat, rev_decay, rev_threshold,
                perm=revival_perm, generator=state.rng)
        return state, metrics

    return step


class WaveNetTrainer:
    """Epoch loop + checkpoints, with the JAX ``WaveNetTrainer``'s contract
    (module docstring). ``device`` ("cuda", or "cpu" when the caller asks
    for it) is where it trains; on a GPU it turns TF32 off for cuDNN and
    matmuls, so the f32 parts train in f32."""

    def __init__(self, config: dict, training_loader, experiments_path: str,
                 experiment_name: str, num_speakers: int, seed: int = 1234,
                 start_epoch: int = 0, *, device):
        self._config = config
        self._loader = training_loader
        self._experiments_path = experiments_path
        self._experiment_name = experiment_name
        self._start_epoch = start_epoch
        self._device = resolve_device(device)
        if self._device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        params, model_state, self._wavenet_cfg = numpy_wavenet_vqvae_params(
            config, num_speakers, seed)
        opt_state = None
        epoch, ckpt_path = latest_checkpoint_epoch(experiments_path,
                                                   experiment_name)
        if ckpt_path is not None:
            ConsoleLogger.status(
                f"Resuming WaveNet '{experiment_name}' from epoch {epoch}")
            ckpt = load_checkpoint(ckpt_path)
            params, model_state = ckpt["params"], ckpt["model_state"]
            opt_state = ckpt["opt_state"]
            self._start_epoch = ckpt["epoch"]
        model = load_wavenet_vqvae_params(
            WaveNetVQVAE(config, num_speakers), params, model_state)
        optimizer = make_optimizer(config["learning_rate"])
        self.state = create_wavenet_train_state(model, optimizer,
                                                device=self._device, seed=seed)
        if opt_state is not None:
            load_jax_opt_state(model, opt_state, self.state.opt_state)
        self._step = make_wavenet_train_step(config, self._wavenet_cfg,
                                             optimizer)

    def train(self) -> WaveNetTrainState:
        cfg = self._config
        # the per-epoch history beside the checkpoints: with
        # prune_checkpoints on, the merged loss curves lose their sources
        hist_path = os.path.join(self._experiments_path,
                                 f"{self._experiment_name}_history.json")
        history = []
        if self._start_epoch and os.path.isfile(hist_path):
            with open(hist_path) as f:
                history = [h for h in json.load(f)
                           if h["epoch"] <= self._start_epoch]
        # checkpoint_every=K (default 1): a vctk_wavenet checkpoint is ~1.8 GB;
        # the loss lists accumulate between saves and the last epoch saves
        ckpt_every = int(cfg.get("checkpoint_every", 1))
        pending_losses, pending_perp = [], []
        for epoch in range(self._start_epoch, cfg["num_epochs"]):
            t_epoch = time.time()
            device_metrics = []
            for batch in prefetch_to_device(iter(self._loader),
                                            device=self._device):
                self.state, metrics = self._step(self.state, batch)
                device_metrics.append(metrics)
            losses_list, perplexity_list = ConvolutionalTrainer._fetch(
                device_metrics)
            ConsoleLogger.status(
                "WaveNet epoch {}: loss {:.4f} perplexity {:.3f}".format(
                    epoch + 1, losses_list[-1]["loss"], perplexity_list[-1]))
            pending_losses.extend(losses_list)
            pending_perp.extend(perplexity_list)
            saved = ((epoch + 1) % ckpt_every == 0
                     or epoch == cfg["num_epochs"] - 1)
            if saved:
                self.save(epoch, pending_losses, pending_perp)
                pending_losses, pending_perp = [], []
            entry = {"epoch": epoch + 1,
                     "loss": round(losses_list[-1]["loss"], 4),
                     "perplexity": round(perplexity_list[-1], 3),
                     "wall_s": round(time.time() - t_epoch, 1)}
            if "revived_codes" in losses_list[-1]:
                entry["revived_codes"] = losses_list[-1]["revived_codes"]
            history.append(entry)
            with open(hist_path, "w") as f:
                json.dump(history, f)
                f.write("\n")
            if saved and cfg.get("prune_checkpoints"):
                # keep the first epoch's (first-step losses) and the last two
                prune_checkpoints(self._experiments_path,
                                  self._experiment_name)
        return self.state

    def save(self, epoch, losses_list=None, perplexity_list=None):
        model = self.state.model
        params, model_state = export_jax_params(model)
        return save_checkpoint(
            self._experiments_path, self._experiment_name, epoch, params,
            model_state, export_jax_opt_state(model, self.state.opt_state),
            train_res_recon_error=losses_list,
            train_res_perplexity=perplexity_list)
