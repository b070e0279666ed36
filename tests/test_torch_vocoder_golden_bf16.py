"""The one-pass vocoders' bf16 golden waves that chip_smoke.py holds the
GPU port's bf16 servers to.

tests/data/torch_port_vocoder_golden_bf16.npz holds, at the paper widths
with the numpy trees of chip_smoke.vocoder_models(), the JAX package's bf16
server's waves (on the CPU: BucketedParallelSynthesisServer with
compute_dtype=bf16, plain, its one jitted program for the request's bucket)
for the golden request of tests/test_torch_vocoder_golden.py: 8 mel frames
and 2048 unit-normal noise samples from a numpy seed, scaled by the
servers' temperature 0.8. These tests recompute both waves with JAX so the
file cannot drift from the reference, and check that the port's bf16
server on the CPU gives the same waves, plain and fused, within
chip_smoke.VOCODER_BF16_GOLDEN_TOL: about twice the JAX package's own
spread on this request between its jitted server and its eager ops (the
port rounds after every op as JAX's eager ops do; measured: student max
0.031 / 0.047 plain / fused, mean 0.0042 / 0.0040; flow max 0.125 / 0.156,
mean 0.0080 / 0.0085).

Regenerate the file with ``python tests/test_torch_vocoder_golden_bf16.py``.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402
from vqvae_speech_tpu.models import clarinet as jax_clarinet  # noqa: E402
from vqvae_speech_tpu.models.flowavenet import model as jax_flow  # noqa: E402
from vqvae_speech_tpu.serve import (  # noqa: E402
    BucketedParallelSynthesisServer as JaxServer,
)
from vqvae_speech_tpu_torch.serve import (  # noqa: E402
    BucketedParallelSynthesisServer,
)

KINDS = ("iaf_student", "flowavenet")


@pytest.fixture(scope="module")
def models():
    return chip_smoke.vocoder_models()


def jax_wave(kind, params, cfg, kw):
    """The JAX bf16 server's (2048,) wave for the golden request: the
    server's own jitted program for bucket 8, on the golden noise (the JAX
    server draws its own noise; the program takes any)."""
    mel, z = chip_smoke.vocoder_golden_inputs()
    as_jax = jax.tree_util.tree_map(jnp.asarray, params)
    if kind == "flowavenet":
        server = JaxServer(kind, as_jax,
                           jax_flow.FlowavenetConfig(**dataclasses.asdict(cfg)),
                           frame_buckets=(chip_smoke.GOLDEN_FRAMES,),
                           max_batch=1, compute_dtype=jnp.bfloat16)
    else:
        server = JaxServer(
            kind, as_jax, jax_clarinet.StudentConfig(**dataclasses.asdict(cfg)),
            teacher_params=jax.tree_util.tree_map(jnp.asarray,
                                                  kw["teacher_params"]),
            teacher_cfg=jax_clarinet.GaussianWaveNetConfig(
                **dataclasses.asdict(kw["teacher_cfg"])),
            frame_buckets=(chip_smoke.GOLDEN_FRAMES,), max_batch=1,
            compute_dtype=jnp.bfloat16)
    program = server._build(chip_smoke.GOLDEN_FRAMES)
    wave = program(server._params, server._teacher_params,
                   z[None] * np.float32(chip_smoke.VOCODER_TEMP), mel[None])
    return np.asarray(wave[0, :, 0], np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_golden_file_matches_jax(models, kind):
    """Recomputed on this host: XLA's CPU sums may vary across hosts in the
    last f32 bits, which can move a bf16 rounding: at least 99% of the
    samples equal, the rest within one bf16 ulp of the peak."""
    golden = np.load(chip_smoke.VOCODER_BF16_GOLDEN)
    assert sorted(golden.files) == sorted(KINDS)
    want = jax_wave(kind, *models[kind])
    assert want.shape == (chip_smoke.GOLDEN_FRAMES * chip_smoke.VOCODER_HOP,)
    assert (golden[kind] != want).mean() <= 0.01
    peak = np.abs(want).max()
    assert np.abs(golden[kind] - want).max() <= 2.0 ** -7 * peak


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fused", [False, True])
def test_bf16_port_on_cpu_matches_golden(models, kind, fused):
    """The port's bf16 server on the CPU, plain and through the fused
    chains' plain bf16 versions (every flow block fused, where JAX's fused
    server fuses only those of conditioning at most 1024 wide): within
    VOCODER_BF16_GOLDEN_TOL of JAX's bf16 wave, finite, not constant, and
    off the f32 golden wave by a bf16-sized difference."""
    params, cfg, kw = models[kind]
    golden = np.load(chip_smoke.VOCODER_BF16_GOLDEN)[kind]
    mel, z = chip_smoke.vocoder_golden_inputs()
    server = BucketedParallelSynthesisServer(
        kind, params, cfg, frame_buckets=chip_smoke.VOCODER_BUCKETS,
        max_batch=1, temp=chip_smoke.VOCODER_TEMP, use_fused_chain=fused,
        compute_dtype=torch.bfloat16, device="cpu", **kw)
    (got,) = server.synthesize([mel], noises=[z])
    assert got.bucket == chip_smoke.GOLDEN_FRAMES
    assert got.wave.dtype == np.float32 and got.wave.shape == golden.shape
    assert np.isfinite(got.wave).all() and got.wave.std() > 0.1
    most, mean = chip_smoke.VOCODER_BF16_GOLDEN_TOL[kind]
    err = np.abs(got.wave - golden)
    assert err.max() <= most and err.mean() <= mean, (err.max(), err.mean())
    f32 = np.load(chip_smoke.VOCODER_GOLDEN)[kind]
    assert np.abs(got.wave - f32).max() > 1e-3


if __name__ == "__main__":
    made = chip_smoke.vocoder_models()
    np.savez_compressed(chip_smoke.VOCODER_BF16_GOLDEN,
                        **{kind: jax_wave(kind, *made[kind])
                           for kind in KINDS})
    print(f"wrote {chip_smoke.VOCODER_BF16_GOLDEN}")
