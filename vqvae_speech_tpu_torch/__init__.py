"""VQ-VAE-Speech in PyTorch for NVIDIA Hopper GPUs.

A port of ``vqvae_speech_tpu`` (the JAX package, which stays the reference)
with the same module names:

- ``ops``    — speech DSP features, mu-law companding, the VQ codebook
               search and the WaveNet decode-step layer stack; CUDA tensors
               go to the hand-written kernels in ``csrc/``.
- ``nn``     — conv layers (weight norm resolved) and the tied residual stack.
- ``models`` — encoder, VQ (gradient and EMA variants), decoder, ConvVQVAE;
               the WaveNet (batch forward and AR decode), its decoder and
               WaveNetVQVAE.
- ``convert``— JAX param trees (numpy) -> the port's modules.
- ``train``  — the JAX-free checkpoint reader.
- ``serve``  — BucketedEncodeServer and BucketedSynthesisServer.

Activations inside are (B, C, T); public functions keep the JAX layout at
their edges: features go in as (B, T, C), quantized latents come out as
(B, T', D). This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
