from vqvae_speech_tpu_torch.train.checkpoint import (
    find_checkpoints,
    latest_checkpoint_epoch,
    load_checkpoint,
    merge_checkpoint_losses,
    prune_checkpoints,
    save_checkpoint,
)
from vqvae_speech_tpu_torch.train.config import (
    freeze_configuration,
    frozen_configuration_path,
    load_configuration,
    merge_experiment_configuration,
    update_configuration_from_experiments,
)
from vqvae_speech_tpu_torch.train.experiment import Experiment, Experiments
from vqvae_speech_tpu_torch.train.revival import apply_revival, revival_settings
from vqvae_speech_tpu_torch.train.trainer import (
    Amsgrad,
    AmsgradState,
    ConvolutionalTrainer,
    TrainState,
    create_train_state,
    make_grad_stats_fn,
    make_optimizer,
    make_train_step,
)
from vqvae_speech_tpu_torch.train.wavenet_trainer import (
    WaveNetTrainer,
    WaveNetTrainState,
    create_wavenet_train_state,
    make_wavenet_train_step,
)

__all__ = ["find_checkpoints", "latest_checkpoint_epoch", "load_checkpoint",
           "merge_checkpoint_losses", "prune_checkpoints", "save_checkpoint",
           "freeze_configuration", "frozen_configuration_path",
           "load_configuration", "merge_experiment_configuration",
           "update_configuration_from_experiments", "Experiment",
           "Experiments", "apply_revival", "revival_settings", "Amsgrad",
           "AmsgradState", "ConvolutionalTrainer", "TrainState",
           "create_train_state", "make_grad_stats_fn", "make_optimizer",
           "make_train_step", "WaveNetTrainer", "WaveNetTrainState",
           "create_wavenet_train_state", "make_wavenet_train_step"]
