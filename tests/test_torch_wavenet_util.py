"""PyTorch port: the WaveNet input-type predicates and hparams factory
(models/wavenet/util.py) against the JAX package's: configs equal field by
field, and the factory's numpy tree with JAX's structure and shapes,
loadable into the port's WaveNet."""
import dataclasses

import jax
import numpy as np
import pytest

from vqvae_speech_tpu.models.wavenet import util as jax_util
from vqvae_speech_tpu_torch.convert import load_wavenet_params
from vqvae_speech_tpu_torch.models.wavenet import WaveNet, util

HPARAMS = [
    {},                                                      # every default
    {"input_type": "raw"},                                   # scalar, 30
    {"input_type": "mulaw"},
    {"input_type": "mulaw-quantize", "out_channels": 64, "layers": 6,
     "stacks": 3, "residual_channels": 16, "gate_channels": 32,
     "skip_out_channels": 24, "kernel_size": 2, "dropout": 0.1,
     "cin_channels": 8, "gin_channels": 4, "n_speakers": 5,
     "upsample_conditional_features": True, "upsample_scales": [4, 4],
     "freq_axis_kernel_size": 5, "use_speaker_embedding": True,
     "legacy": False},
    {"input_type": "raw", "layers": 4, "stacks": 2, "residual_channels": 8,
     "gate_channels": 8, "skip_out_channels": 8, "cin_channels": 4,
     "upsample_conditional_features": True, "upsample_scales": (2, 2)},
]


@pytest.mark.parametrize("name", ["mulaw-quantize", "mulaw", "raw",
                                  "other"])
def test_predicates_match_jax(name):
    for fn in ("is_mulaw_quantize", "is_mulaw", "is_raw", "is_scalar_input"):
        assert getattr(util, fn)(name) == getattr(jax_util, fn)(name)


@pytest.mark.parametrize("hparams", HPARAMS)
def test_config_equals_jax_field_by_field(hparams):
    _, jcfg = jax_util.build_wavenet_from_hparams(jax.random.PRNGKey(0),
                                                  hparams)
    tree, cfg = util.build_wavenet_from_hparams(hparams, seed=0)
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(cfg)
    assert list(got) == list(want)
    for field, value in want.items():
        assert got[field] == value, field
    assert cfg.out_channels == (30 if cfg.scalar_input else
                                hparams.get("out_channels", 256))


@pytest.mark.parametrize("hparams", HPARAMS[3:])
def test_factory_tree_loads_and_matches_jax_shapes(hparams):
    jparams, _ = jax_util.build_wavenet_from_hparams(jax.random.PRNGKey(0),
                                                     hparams)
    tree, cfg = util.build_wavenet_from_hparams(hparams, seed=1)
    want = jax.tree_util.tree_map(np.shape, jparams)
    assert jax.tree_util.tree_map(np.shape, tree) == want
    module = load_wavenet_params(WaveNet(cfg), tree)
    assert module.first_conv.v.shape[1] == (1 if cfg.scalar_input
                                            else cfg.out_channels)
    again, _ = util.build_wavenet_from_hparams(hparams, seed=1)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(again)))
