from vqvae_speech_tpu_torch.models.flowavenet.model import (
    CouplingNetConfig,
    FlowavenetConfig,
    coupling_net_apply,
    flowavenet_reverse,
    flowavenet_upsample,
)

__all__ = ["CouplingNetConfig", "FlowavenetConfig", "coupling_net_apply",
           "flowavenet_reverse", "flowavenet_upsample"]
