from vqvae_speech_tpu_torch.models.flowavenet.model import (
    CouplingNetConfig,
    FlowavenetConfig,
    actnorm_forward,
    actnorm_initialize,
    coupling_net_apply,
    flowavenet_forward,
    flowavenet_reverse,
    flowavenet_upsample,
)

__all__ = ["CouplingNetConfig", "FlowavenetConfig", "actnorm_forward",
           "actnorm_initialize", "coupling_net_apply", "flowavenet_forward",
           "flowavenet_reverse", "flowavenet_upsample"]
