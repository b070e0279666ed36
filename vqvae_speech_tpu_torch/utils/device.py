"""Explicit device selection: no silent CPU fallback."""
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and no CUDA
    device is usable. There is no 'auto': callers say where to run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices")
    return dev
