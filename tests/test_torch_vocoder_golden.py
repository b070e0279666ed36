"""The one-pass vocoders' golden waves that chip_smoke.py holds the GPU port
to.

tests/data/torch_port_vocoder_golden.npz holds, at the paper widths with the
numpy trees of chip_smoke.vocoder_models(), the JAX package's waves (on the
CPU) for one short request a kind: 8 mel frames and 2048 unit-normal noise
samples from a numpy seed, scaled by the servers' temperature 0.8. These
tests recompute both waves with JAX so the file cannot drift from the
reference, and check that the port on the CPU gives the same waves, plain
and fused.

Regenerate the file with ``python tests/test_torch_vocoder_golden.py``.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402
from vqvae_speech_tpu.models import clarinet as jax_clarinet  # noqa: E402
from vqvae_speech_tpu.models.flowavenet import model as jax_flow  # noqa: E402
from vqvae_speech_tpu_torch.serve import (  # noqa: E402
    BucketedParallelSynthesisServer,
)

KINDS = ("iaf_student", "flowavenet")


@pytest.fixture(scope="module")
def models():
    return chip_smoke.vocoder_models()


def jax_wave(kind, params, cfg, kw):
    """The JAX package's (2048,) wave for the golden request."""
    mel, z = chip_smoke.vocoder_golden_inputs()
    z = jnp.asarray(z[None] * np.float32(chip_smoke.VOCODER_TEMP))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    if kind == "flowavenet":
        jcfg = jax_flow.FlowavenetConfig(**dataclasses.asdict(cfg))
        wave = jax_flow.flowavenet_reverse(params, jcfg, z,
                                           jnp.asarray(mel[None]))
    else:
        tcfg = jax_clarinet.GaussianWaveNetConfig(
            **dataclasses.asdict(kw["teacher_cfg"]))
        c_up = jax_clarinet.gaussian_wavenet_upsample(
            jax.tree_util.tree_map(jnp.asarray, kw["teacher_params"]),
            jnp.asarray(mel[None]), tcfg)
        wave = jax_clarinet.wavenet_student_generate(
            params, jax_clarinet.StudentConfig(**dataclasses.asdict(cfg)), z,
            c_up)
    return np.asarray(wave[0, :, 0], np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_golden_file_matches_jax(models, kind):
    """XLA's CPU reductions may vary across hosts in the last bits: 1e-5."""
    golden = np.load(chip_smoke.VOCODER_GOLDEN)
    assert sorted(golden.files) == sorted(KINDS)
    want = jax_wave(kind, *models[kind])
    assert want.shape == (chip_smoke.GOLDEN_FRAMES * chip_smoke.VOCODER_HOP,)
    np.testing.assert_allclose(golden[kind], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fused", [False, True])
def test_port_on_cpu_matches_golden(models, kind, fused):
    """The port's server on the CPU, plain and through the fused chains'
    plain versions, on the golden request: within 1e-4 of JAX's wave (42
    or ~150 f32 conv layers of up to 256 channels in another summation
    order). The waves are finite and not constant."""
    params, cfg, kw = models[kind]
    golden = np.load(chip_smoke.VOCODER_GOLDEN)[kind]
    mel, z = chip_smoke.vocoder_golden_inputs()
    server = BucketedParallelSynthesisServer(
        kind, params, cfg, frame_buckets=chip_smoke.VOCODER_BUCKETS,
        max_batch=1, temp=chip_smoke.VOCODER_TEMP, use_fused_chain=fused,
        device="cpu", **kw)
    (got,) = server.synthesize([mel], noises=[z])
    assert got.bucket == chip_smoke.GOLDEN_FRAMES
    assert got.wave.shape == golden.shape and np.isfinite(got.wave).all()
    assert got.wave.std() > 0.1
    np.testing.assert_allclose(got.wave, golden, rtol=0, atol=1e-4)


def test_smoke_requests_fill_the_buckets():
    """chip_smoke's eight VCTK requests: mel frames of the expected shapes,
    in [0, 1], two or more in each of the buckets 20, 40 and 80."""
    mels = chip_smoke.vocoder_requests("cpu")
    assert [m.shape for m in mels] == [(n, 80)
                                       for n in chip_smoke.VOCODER_FRAMES]
    for m in mels:
        assert m.dtype == np.float32 and 0.0 <= m.min() and m.max() <= 1.0
        assert m.std() > 0.05
    buckets = [min(b for b in chip_smoke.VOCODER_BUCKETS if n <= b)
               for n in chip_smoke.VOCODER_FRAMES]
    assert sorted(set(buckets)) == [20, 40, 80]
    assert min(buckets.count(b) for b in (20, 40, 80)) >= 2


if __name__ == "__main__":
    made = chip_smoke.vocoder_models()
    np.savez_compressed(chip_smoke.VOCODER_GOLDEN,
                        **{kind: jax_wave(kind, *made[kind])
                           for kind in KINDS})
    print(f"wrote {chip_smoke.VOCODER_GOLDEN}")
