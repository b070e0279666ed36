"""The WaveNet-VQ-VAE golden values that chip_smoke.py holds the GPU port to.

tests/data/torch_port_wavenet_golden.npz holds, at the vctk_wavenet width
with numpy_wavenet_vqvae_params(seed=0), the JAX package's codes (on the
CPU) for chip_smoke's synthesis requests, each encoded at batch 1, and its
eval teacher-forced logits (``wavenet_vqvae_apply``) for request 0 with the
mu-law bins of its first 256 samples as the decoder input. These tests
recompute both with JAX so the file cannot drift from the reference, check
that the port on the CPU gives the same values, and keep chip_smoke's
written-out config equal to configurations/vctk_wavenet.yaml.

Regenerate the file with ``python tests/test_torch_wavenet_golden.py``.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402
from vqvae_speech_tpu.models.encoder import convolutional_encoder_apply  # noqa: E402
from vqvae_speech_tpu.models.vq import vector_quantizer_apply  # noqa: E402
from vqvae_speech_tpu.models.wavenet_decoder import (  # noqa: E402
    wavenet_config_from,
)
from vqvae_speech_tpu.models.wavenet_vqvae import wavenet_vqvae_apply  # noqa: E402
from vqvae_speech_tpu.nn import conv1d  # noqa: E402
from vqvae_speech_tpu.ops import speech_features  # noqa: E402
from vqvae_speech_tpu.ops.mu_law import mu_law_encode  # noqa: E402
from vqvae_speech_tpu_torch.convert import (  # noqa: E402
    load_wavenet_vqvae_params,
    numpy_wavenet_vqvae_params,
)
from vqvae_speech_tpu_torch.models import WaveNetVQVAE  # noqa: E402

CONFIG = chip_smoke.WAVENET_CONFIG
N_SPK = CONFIG["num_speakers"]


@pytest.fixture(scope="module")
def setup():
    params, state, _ = numpy_wavenet_vqvae_params(CONFIG, N_SPK,
                                                  seed=chip_smoke.SEED)
    waves, speakers = chip_smoke.synthesis_requests()
    return params, state, waves, speakers


def jax_golden(params, state, waves, speakers):
    """{"codes_NN": (T_lat,) int32, "teacher_forced_bins": (256,) int32,
    "teacher_forced_logits": (256, 256) f32}, computed with JAX."""
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax.tree_util.tree_map(jnp.asarray, state)
    cfg = CONFIG

    def feats(w):
        return speech_features(cfg["input_features_type"], jnp.asarray(w[None]),
                               cfg["sampling_rate"], cfg["input_features_filters"],
                               cfg["augment_input_features"]).astype(jnp.float32)

    @jax.jit
    def codes(f):
        # scripts/wavenet_vqvae_e2e_tpu.py:codes_to_lc, batch 1
        z = convolutional_encoder_apply(params["encoder"], f,
                                        cfg["num_residual_layers"])
        z = conv1d(params["pre_vq_conv"], z, padding=0)
        return vector_quantizer_apply(
            params["vq"], state["vq"], z, commitment_cost=cfg["commitment_cost"],
            decay=cfg["decay"], training=False).indices

    out = {f"codes_{i:02d}": np.asarray(codes(feats(w))).reshape(-1)
           .astype(np.int32) for i, w in enumerate(waves)}
    n = chip_smoke.TEACHER_FORCED_SAMPLES
    bins = mu_law_encode(jnp.asarray(waves[0][:n]), cfg["quantize"])
    x_dec = jax.nn.one_hot(bins, cfg["quantize"])[None]
    logits = wavenet_vqvae_apply(
        params, state, wavenet_config_from(cfg, N_SPK), feats(waves[0]), x_dec,
        jnp.asarray([speakers[0]]), cfg, training=False,
        use_pallas=False).reconstructed_x
    out["teacher_forced_bins"] = np.asarray(bins, np.int32)
    out["teacher_forced_logits"] = np.asarray(logits[0], np.float32)
    return out


def test_golden_file_matches_jax(setup):
    golden = np.load(chip_smoke.WAVENET_GOLDEN)
    want = jax_golden(*setup)
    assert sorted(golden.files) == sorted(want)
    for name, value in want.items():
        if name == "teacher_forced_logits":
            # XLA's CPU reductions may vary across hosts in the last bits
            np.testing.assert_allclose(golden[name], value, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(golden[name], value)


def test_port_on_cpu_matches_golden(setup):
    """The port on the CPU (plain VQ path): codes equal to JAX's; teacher-
    forced logits within 1e-4 (20 f32 conv layers of 768 channels in another
    summation order); the requests fill both buckets as the smoke expects."""
    params, state, waves, speakers = setup
    golden = np.load(chip_smoke.WAVENET_GOLDEN)
    model = load_wavenet_vqvae_params(WaveNetVQVAE(CONFIG, N_SPK), params,
                                      state).eval()
    frames = []
    for i, w in enumerate(waves):
        lc, codes = model.local_conditioning(chip_smoke.wavenet_features(w, "cpu"))
        np.testing.assert_array_equal(codes[0].numpy(), golden[f"codes_{i:02d}"])
        assert lc.shape == (1, codes.shape[1] - 1, CONFIG["local_condition_dim"])
        frames.append(lc.shape[1])
    small, large = chip_smoke.SYNTH_BUCKETS
    assert max(frames) == large
    assert sorted(f <= small for f in frames) == [False] * 6 + [True] * 4
    x_dec = torch.nn.functional.one_hot(
        torch.from_numpy(golden["teacher_forced_bins"]).long(),
        CONFIG["quantize"]).float()[None]
    with torch.no_grad():
        logits = model(chip_smoke.wavenet_features(waves[0], "cpu"), x_dec,
                       torch.tensor([speakers[0]])).reconstructed_x
    np.testing.assert_allclose(logits[0].numpy(),
                               golden["teacher_forced_logits"], rtol=0,
                               atol=1e-4)


def test_smoke_config_is_vctk_wavenet():
    with open(os.path.join(REPO_ROOT, "configurations", "vctk_wavenet.yaml")) as f:
        config = yaml.safe_load(f)
    for key, value in CONFIG.items():
        assert config[key] == value, key


if __name__ == "__main__":
    params, state, _ = numpy_wavenet_vqvae_params(CONFIG, N_SPK,
                                                  seed=chip_smoke.SEED)
    np.savez_compressed(chip_smoke.WAVENET_GOLDEN, **jax_golden(
        params, state, *chip_smoke.synthesis_requests()))
    print(f"wrote {chip_smoke.WAVENET_GOLDEN}")
