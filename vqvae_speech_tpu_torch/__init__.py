"""VQ-VAE-Speech in PyTorch for NVIDIA Hopper GPUs.

A port of ``vqvae_speech_tpu`` (the JAX package, which stays the reference)
with the same module names:

- ``ops``    — speech DSP features, mel spectrograms, mu-law companding,
               the VQ codebook search, the WaveNet decode-step layer stack
               and the fused gated-resblock chains; CUDA tensors go to the
               hand-written kernels in ``csrc/``.
- ``nn``     — conv layers (weight norm resolved) and the tied residual stack.
- ``models`` — encoder, VQ (gradient and EMA variants), decoder, ConvVQVAE;
               the WaveNet (batch forward and AR decode), its decoder and
               WaveNetVQVAE; the one-pass vocoders ``clarinet`` (IAF
               student) and ``flowavenet`` (reverse pass), as plain
               functions over tensor trees.
- ``convert``— JAX param trees (numpy) -> the port's modules and trees.
- ``train``  — the JAX-free checkpoint reader.
- ``serve``  — BucketedEncodeServer, BucketedSynthesisServer and
               BucketedParallelSynthesisServer.

Activations inside the modules are (B, C, T) and the vocoders' functions
are channels-last throughout; public functions keep the JAX layout at
their edges: features go in as (B, T, C), quantized latents come out as
(B, T', D). This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
