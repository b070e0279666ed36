from vqvae_speech_tpu_torch.parallel.mesh import (
    MeshConfiguration,
    initialize_multihost,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["MeshConfiguration", "initialize_multihost", "make_mesh",
           "replicate", "shard_batch"]
