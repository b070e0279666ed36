"""Runnable examples of the PyTorch port, counterparts of the repository's
``examples/``: ``python -m vqvae_speech_tpu_torch.examples.<name> --help``.

* ``vq_2d_clustering``: the EMA quantizer clustering 2-D Gaussian points;
* ``vq_2d_repulsion``: the same with codebook repulsion (``--improved``: an
  outward force, dead-code resets and a k-means init);
* ``vq_balanced_2d``: the balanced quantizer with dead-code revival;
* ``encode_wav``: one wav file to VQ codes with a trained checkpoint;
* ``serve_vocoder``: mel spectrograms to waves through the one-pass vocoder
  server.

Each runs on the card unless ``--device cpu`` is given; the demos' figures
need matplotlib (``main()`` raises before any work without it), their
training functions do not.
"""
import importlib.util

import numpy as np
import torch


def require_matplotlib() -> None:
    """Raise before any work when the figures cannot be drawn."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("the demo draws its figure with matplotlib, which "
                          "is not installed; its training function needs "
                          "none")


def seeded_generator(seed: int) -> torch.Generator:
    """A CPU generator from ``seed`` (mixed by ``np.random.SeedSequence``:
    the CPU generator keeps 32 bits of its seed)."""
    mixed = int(np.random.SeedSequence(seed).generate_state(1)[0])
    return torch.Generator().manual_seed(mixed)
