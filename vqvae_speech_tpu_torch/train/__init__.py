from vqvae_speech_tpu_torch.train.checkpoint import (
    find_checkpoints,
    latest_checkpoint_epoch,
    load_checkpoint,
)

__all__ = ["find_checkpoints", "latest_checkpoint_epoch", "load_checkpoint"]
