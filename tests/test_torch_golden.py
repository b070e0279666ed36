"""The flagship golden codes that chip_smoke.py holds the GPU port to.

tests/data/torch_port_flagship_codes.npz holds the JAX package's codes, on
the CPU, for chip_smoke's requests through its BucketedEncodeServer at the
flagship vq44-mfcc39 width with numpy_params(seed=0). These tests recompute
them with JAX so the file cannot drift from the reference, check that the
port on the CPU serves the same codes, and keep chip_smoke's written-out
config equal to the YAML + JSON it stands for.
"""
import json
import os

import numpy as np
import pytest
import yaml

import chip_smoke
from vqvae_speech_tpu.serve import BucketedEncodeServer as JaxServer
from vqvae_speech_tpu_torch.convert import numpy_params
from vqvae_speech_tpu_torch.serve import BucketedEncodeServer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flagship():
    params, state = numpy_params(chip_smoke.FLAGSHIP_CONFIG, seed=chip_smoke.SEED)
    return params, state, chip_smoke.smoke_requests()


def jax_flagship_codes(params, state, requests):
    """The JAX server's codes (XLA path on the CPU), one array per request.
    Codes do not depend on max_batch (batch-1 semantics per item), so a
    small batch keeps the CPU run light."""
    server = JaxServer(params, state, chip_smoke.FLAGSHIP_CONFIG,
                       max_batch=4, use_pallas=False)
    return [r.codes for r in server.encode(requests)]


def test_golden_file_matches_jax(flagship):
    params, state, requests = flagship
    golden = np.load(chip_smoke.GOLDEN)
    codes = jax_flagship_codes(params, state, requests)
    assert sorted(golden.files) == [f"codes_{i:02d}" for i in range(len(codes))]
    for i, c in enumerate(codes):
        np.testing.assert_array_equal(golden[f"codes_{i:02d}"], c)


def test_port_on_cpu_serves_the_golden_codes(flagship):
    """The port's server on the CPU (plain VQ path) gives the golden codes
    exactly at flagship width."""
    params, state, requests = flagship
    golden = np.load(chip_smoke.GOLDEN)
    server = BucketedEncodeServer(params, state, chip_smoke.FLAGSHIP_CONFIG,
                                  max_batch=4, device="cpu")
    results = server.encode(requests)
    assert sorted({r.bucket for r in results}) == [7680, 15360, 30720]
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r.codes, golden[f"codes_{i:02d}"])


def test_smoke_config_is_the_flagship_baseline():
    with open(os.path.join(REPO_ROOT, "configurations", "vctk_features.yaml")) as f:
        config = yaml.safe_load(f)
    with open(os.path.join(REPO_ROOT, "configurations",
                           "experiments_vq44-mfcc39.json")) as f:
        config.update(json.load(f)["experiments"]["baseline"])
    for key, value in chip_smoke.FLAGSHIP_CONFIG.items():
        assert config[key] == value, key
