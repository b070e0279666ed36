"""PyTorch port: BucketedEncodeServer against the JAX server, the JAX-free
checkpoint reader, and the port's independence from JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import optax

from vqvae_speech_tpu.models import conv_vqvae_init
from vqvae_speech_tpu.serve import BucketedEncodeServer as JaxServer
from vqvae_speech_tpu.train.checkpoint import save_checkpoint
from vqvae_speech_tpu_torch.serve import BucketedEncodeServer
from vqvae_speech_tpu_torch.train import (
    find_checkpoints,
    latest_checkpoint_epoch,
    load_checkpoint,
)

CFG = dict(
    input_features_type="mfcc",
    input_features_filters=13,
    augment_input_features=True,
    output_features_filters=13,
    augment_output_features=True,
    sampling_rate=16000,
    num_hiddens=32,
    num_residual_layers=2,
    residual_channels=32,
    embedding_dim=16,
    num_embeddings=8,
    commitment_cost=0.25,
    decay=0.0,
    use_kaiming_normal=False,
    use_jitter=False,
    jitter_probability=0.12,
    use_speaker_conditioning=False,
)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    params, state = conv_vqvae_init(jax.random.PRNGKey(0), CFG)
    return params, state, jax.tree_util.tree_map(np.asarray, (params, state))


def _waves(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        assert g.codes.dtype == np.int32
        assert (g.n_frames, g.bucket) == (w.n_frames, w.bucket)


def test_codes_match_jax_server(model):
    """Two buckets, mixed lengths, more requests than max_batch: codes are
    identical to the JAX server's, request by request."""
    params, state, (np_params, np_state) = model
    kw = dict(wave_buckets=(4000, 8000), max_batch=3)
    jax_srv = JaxServer(params, state, CFG, use_pallas=False, **kw)
    port = BucketedEncodeServer(np_params, np_state, CFG, device="cpu", **kw)
    waves = _waves([4000, 3000, 8000, 5000, 4000, 7999, 100, 3999])
    _assert_same_results(port.encode(waves), jax_srv.encode(waves))
    # 5 waves fit 4000 and 3 fit 8000; at max_batch 3 that is 2 + 1 launches
    assert port.stats == {"served_buckets": [4000, 8000], "launches": 3,
                          "max_batch": 3}


def test_codes_independent_of_batch_composition(model):
    _, _, (np_params, np_state) = model
    port = BucketedEncodeServer(np_params, np_state, CFG, device="cpu",
                                wave_buckets=(4000,), max_batch=8)
    target = _waves([4000], seed=1)[0]
    alone = port.encode([target])[0].codes
    crowd = port.encode(_waves([3000, 2000], seed=2) + [target]
                        + _waves([4000], seed=3))
    np.testing.assert_array_equal(crowd[2].codes, alone)


def test_normalizer_and_oversize(model):
    params, state, (np_params, np_state) = model
    rng = np.random.default_rng(5)
    norm = {"train_mean": rng.standard_normal(39).astype(np.float32),
            "train_std": (1 + rng.random(39)).astype(np.float32)}
    kw = dict(wave_buckets=(4000,), max_batch=2, normalizer=norm)
    waves = _waves([4000, 2500], seed=5)
    _assert_same_results(
        BucketedEncodeServer(np_params, np_state, CFG, device="cpu", **kw)
        .encode(waves),
        JaxServer(params, state, CFG, use_pallas=False, **kw).encode(waves))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        BucketedEncodeServer(np_params, np_state, CFG, device="cpu",
                             wave_buckets=(4000,)).encode(_waves([4001]))


def test_jax_checkpoint_loads_without_jax(model, tmp_path):
    """A checkpoint from the JAX package's save_checkpoint, with a real
    optax amsgrad opt_state, read by the port's loader, serves the same
    codes."""
    params, state, (np_params, np_state) = model
    opt_state = optax.amsgrad(2e-4).init(params)
    save_checkpoint(str(tmp_path), "vq44", 0, params, state, opt_state,
                    train_res_recon_error=[1.5], train_res_perplexity=[3.0])
    save_checkpoint(str(tmp_path), "vq44", 2, params, state, opt_state)
    assert [e for e, _ in find_checkpoints(str(tmp_path), "vq44")] == [1, 3]
    epoch, path = latest_checkpoint_epoch(str(tmp_path), "vq44")
    assert epoch == 3
    ckpt = load_checkpoint(find_checkpoints(str(tmp_path), "vq44")[0][1])
    assert ckpt["epoch"] == 1 and ckpt["train_res_recon_error"] == [1.5]
    # optax's NamedTuples come back as plain tuples holding numpy arrays
    leaves = _leaves(ckpt["opt_state"])
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)
    waves = _waves([4000, 3000])
    kw = dict(wave_buckets=(4000,), max_batch=2, device="cpu")
    _assert_same_results(
        BucketedEncodeServer(ckpt["params"], ckpt["model_state"], CFG, **kw)
        .encode(waves),
        BucketedEncodeServer(np_params, np_state, CFG, **kw).encode(waves))


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke's request loading, import
    with jax, optax, yaml and the JAX package blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'optax', 'yaml', 'vqvae_speech_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import vqvae_speech_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'vqvae_speech_tpu_torch.serve' in mods, mods\n"
        "import chip_smoke\n"
        "assert len(chip_smoke.smoke_requests()) == 12\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15
