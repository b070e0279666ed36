"""Experiments driver: JSON experiment file -> seeded runs with auto-resume.

Counterpart of ``vqvae_speech_tpu/train/experiment.py`` (reference
src/experiments/experiments.py:42-160 and src/experiments/experiment.py:36-122),
with the same contract:

* the experiments JSON holds {experiments_path, results_path,
  configuration_path, seed | [seeds], experiments: {name: overrides}},
* a seed list fans out one run per (name, seed) named ``{name}-seed{seed}``,
* per-experiment config = YAML base deep-copied + overrides of existing keys,
  frozen to ``{name}_configuration.yaml``,
* if the frozen config already exists it is the configuration the run uses,
  and the run AUTO-RESUMES from the latest ``{name}_{epoch}_checkpoint.pkl``
  (parameters, EMA state, optimizer state and start epoch from the
  checkpoint, reference pipeline_factory.py:80-126).

A fresh run starts from ``convert.numpy_params(config, seed)``: the tree and
the init distributions of the JAX package's ``conv_vqvae_init``, drawn from
numpy (``jax.random``'s stream cannot be reproduced, PARITY #3). The loader's
shuffle is numpy's, seeded alike, so both packages see the same batches.

``evaluate`` runs ``eval.Evaluator`` on the experiment's device, with the
cross-experiment evolution and stability plots in ``Experiments.evaluate``;
``figures=False`` writes the number files alone (the GPU machine has no
matplotlib).

``decoder_type: wavenet`` builds ``train.wavenet_trainer.WaveNetTrainer``
(``num_speakers`` defaulting to 128), which starts from
``convert.numpy_wavenet_vqvae_params`` and resumes from the newest
checkpoint itself, as the JAX package's does.

Not ported: data parallelism (``use_data_parallel``, ROADMAP item 14)
raises here.
"""
import json
import os

from vqvae_speech_tpu_torch.convert import numpy_params
from vqvae_speech_tpu_torch.data import (
    FeatureLoader,
    FeatureStore,
    load_normalizer,
)
from vqvae_speech_tpu_torch.train.checkpoint import (
    latest_checkpoint_epoch,
    load_checkpoint,
)
from vqvae_speech_tpu_torch.train.config import (
    freeze_configuration,
    frozen_configuration_path,
    load_configuration,
    merge_experiment_configuration,
)
from vqvae_speech_tpu_torch.train.trainer import ConvolutionalTrainer
from vqvae_speech_tpu_torch.train.wavenet_trainer import WaveNetTrainer
from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger

class Experiment:
    def __init__(self, name, experiments_path, results_path,
                 global_configuration, experiment_configuration, seed,
                 data_root=None, *, device):
        self.name = name
        self.experiments_path = experiments_path
        self.results_path = results_path
        self.seed = seed
        self.device = device
        self._experiment_configuration = experiment_configuration
        self._data_root = data_root

        os.makedirs(results_path, exist_ok=True)
        os.makedirs(experiments_path, exist_ok=True)

        frozen_path = frozen_configuration_path(experiments_path, name)
        self.resumed = os.path.isfile(frozen_path)
        if self.resumed:
            self.configuration = load_configuration(frozen_path)
        else:
            self.configuration = merge_experiment_configuration(
                global_configuration, experiment_configuration)
            freeze_configuration(self.configuration, experiments_path, name)

    # ---------------- pipeline build/load ----------------

    def _build_loader(self):
        cfg = self.configuration
        root = self._data_root or os.path.join(
            cfg.get("data_root", "."), cfg.get("features_path", "features"))
        store = FeatureStore(root)
        normalizer = None
        if cfg.get("normalize"):
            normalizer = load_normalizer(cfg["normalizer_path"])
        return FeatureLoader(store, "train", cfg["batch_size"],
                             normalizer=normalizer, seed=self.seed)

    def _refuse_unported(self):
        cfg = self.configuration
        if cfg.get("use_data_parallel"):
            raise NotImplementedError(
                "use_data_parallel: data-parallel training over a mesh is not "
                "ported (ROADMAP item 14); the port trains on one device")

    def build_trainer(self, training_loader=None, *, device=None):
        """The trainer of this run, fresh or resumed; ``device`` defaults to
        the experiment's."""
        self._refuse_unported()
        cfg = self.configuration
        device = self.device if device is None else device
        decoder_type = cfg.get("decoder_type", "deconvolutional")
        if decoder_type not in ("deconvolutional", "wavenet"):
            raise NotImplementedError(
                f"decoder_type {cfg['decoder_type']!r} has no trainer pipeline")
        if training_loader is None:
            training_loader = self._build_loader()
        if decoder_type == "wavenet":
            # an extension beyond the reference, whose PipelineFactory
            # raises for any non-deconvolutional decoder
            return WaveNetTrainer(
                cfg, training_loader, self.experiments_path, self.name,
                num_speakers=cfg.get("num_speakers", 128), seed=self.seed,
                device=device)

        params, model_state = numpy_params(cfg, self.seed)
        start_epoch = 0
        opt_state = None
        epoch, ckpt_path = latest_checkpoint_epoch(self.experiments_path,
                                                   self.name)
        if self.resumed and ckpt_path is not None:
            ConsoleLogger.status(
                f"Resuming '{self.name}' from checkpoint epoch {epoch}")
            ckpt = load_checkpoint(ckpt_path)
            params = ckpt["params"]
            model_state = ckpt["model_state"]
            opt_state = ckpt["opt_state"]
            start_epoch = ckpt["epoch"]

        return ConvolutionalTrainer(
            cfg, params, model_state, training_loader,
            self.experiments_path, self.name, seed=self.seed,
            start_epoch=start_epoch, opt_state=opt_state, device=device)

    def train(self, training_loader=None):
        ConsoleLogger.status(f"Running the experiment called '{self.name}'")
        trainer = self.build_trainer(training_loader)
        state = trainer.train()
        ConsoleLogger.success(f"Experiment '{self.name}' done")
        return state

    def evaluate(self, evaluation_options, data_root=None, *,
                 figures: bool = True):
        from vqvae_speech_tpu_torch.eval.evaluator import Evaluator

        ConsoleLogger.status(f"Evaluating the experiment called '{self.name}'")
        ev = Evaluator(self, data_root=data_root or self._data_root,
                       device=self.device, figures=figures)
        return ev.evaluate(evaluation_options)


class Experiments:
    def __init__(self, experiments):
        self.experiments = experiments

    def train(self):
        for experiment in self.experiments:
            experiment.train()

    def evaluate(self, evaluation_options, *, figures: bool = True):
        from vqvae_speech_tpu_torch.eval.evaluator import check_figures

        check_figures(evaluation_options, figures)
        results = {}
        for experiment in self.experiments:
            results[experiment.name] = experiment.evaluate(
                evaluation_options, figures=figures)
        # cross-experiment aggregations (reference experiments.py:69-116)
        if self.experiments:
            names = [e.name for e in self.experiments]
            result_path = self.experiments[0].results_path
            if evaluation_options.get("plot_clustering_metrics_evolution"):
                from vqvae_speech_tpu_torch.eval.alignment_stats import (
                    compute_clustering_metrics_evolution)

                results["clustering_metrics_evolution"] = \
                    compute_clustering_metrics_evolution(names, result_path)
            if evaluation_options.get(
                    "check_clustering_metrics_stability_over_seeds"):
                from vqvae_speech_tpu_torch.eval.alignment_stats import (
                    check_clustering_metrics_stability_over_seeds)

                results["clustering_metrics_stability"] = \
                    check_clustering_metrics_stability_over_seeds(
                        names, result_path)
        return results

    @staticmethod
    def load(experiments_path: str, data_root=None, *,
             device) -> "Experiments":
        with open(experiments_path, "r") as f:
            spec = json.load(f)
        configuration = load_configuration(spec["configuration_path"])
        seeds = spec["seed"] if isinstance(spec["seed"], list) else [spec["seed"]]
        fan_out = isinstance(spec["seed"], list)
        experiments = []
        for seed in seeds:
            for name, overrides in spec["experiments"].items():
                experiments.append(Experiment(
                    name=f"{name}-seed{seed}" if fan_out else name,
                    experiments_path=spec["experiments_path"],
                    results_path=spec["results_path"],
                    global_configuration=configuration,
                    experiment_configuration=overrides,
                    seed=seed,
                    data_root=data_root,
                    device=device,
                ))
        return Experiments(experiments)
