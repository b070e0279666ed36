from vqvae_speech_tpu_torch.train.checkpoint import (
    find_checkpoints,
    latest_checkpoint_epoch,
    load_checkpoint,
    merge_checkpoint_losses,
    prune_checkpoints,
    save_checkpoint,
)
from vqvae_speech_tpu_torch.train.revival import apply_revival, revival_settings
from vqvae_speech_tpu_torch.train.trainer import (
    Amsgrad,
    AmsgradState,
    TrainState,
    create_train_state,
    make_grad_stats_fn,
    make_optimizer,
    make_train_step,
)

__all__ = ["find_checkpoints", "latest_checkpoint_epoch", "load_checkpoint",
           "merge_checkpoint_losses", "prune_checkpoints", "save_checkpoint",
           "apply_revival", "revival_settings", "Amsgrad", "AmsgradState",
           "TrainState", "create_train_state", "make_grad_stats_fn",
           "make_optimizer", "make_train_step"]
