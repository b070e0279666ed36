"""PyTorch port: the data-parallel train steps in a gloo world of 2 CPU
ranks, against the port's own single-device step on the global batch (which
the other test files hold to JAX's; JAX's data-parallel step equals its
single-device step by ``tests/test_parallel.py``'s own test).

One world (``tests/torch_parallel_jobs.py:data_parallel``) runs: the
flagship-test-width step with the gradient quantizer and with the EMA
quantizer and revival, both jittered; the WaveNet-VQ-VAE step with dropout
and AR-input dropout; the teacher, student and flow steps at the vocoder
CLI's ``--tiny`` presets; and one epoch of an Experiment with
``use_data_parallel``. This process runs the same steps with ``mesh=None``
on the global batches meanwhile. The checks: codes equal at every step,
losses within 1e-5 relative, EMA buffers within 1e-6, parameters by the
distribution of their differences (an Adam step amplifies f32 noise near a
zero gradient, ROADMAP.md), and the state bit-equal across the ranks.
"""
import json
import os

import numpy as np
import pytest
import torch

from tests.test_ljspeech_vocoder import _mini_ljspeech
from tests.test_training import TINY_CFG, _setup
from tests.torch_parallel_jobs import (
    run_conv_steps,
    run_experiment,
    run_vocoder_cli,
    run_vocoder_steps,
    run_wavenet_steps,
)
from tests.torch_world import World

WORLD = 2
CONV = {"gradient_jitter": dict(TINY_CFG, use_jitter=True),
        "ema_jitter_revival": dict(TINY_CFG, use_jitter=True, decay=0.99,
                                   codebook_revival=True,
                                   revival_threshold=0.05)}
WAVENET = dict(TINY_CFG, decoder_type="wavenet", length=512, quantize=16,
               input_features_dim=3, output_features_dim=3, num_hiddens=8,
               embedding_dim=8, num_embeddings=5, residual_channels=8,
               n_loop=1, n_layers=2, filter_size=2, gate_channels=8,
               skip_out_channels=8, global_condition_dim=4,
               local_condition_dim=8, num_speakers=2, ar_input_dropout=0.2,
               use_jitter=True)
VOCODERS = ("teacher", "student", "flow")


def _batches():
    rng = np.random.default_rng(0)
    conv = [{k: rng.standard_normal((4, 47, 39)).astype(np.float32)
             for k in ("input_features", "output_features")}
            for _ in range(3)]
    wavenet = [{"preprocessed_audio": np.tanh(rng.standard_normal(
                    (4, 513))).astype(np.float32),
                "input_features": rng.standard_normal(
                    (4, 4, 39)).astype(np.float32),
                "speaker_id": np.asarray([0, 1, 1, 0], np.int32)}
               for _ in range(2)]
    vocoder = [{"x": (0.3 * rng.standard_normal((4, 1024, 1))
                      ).astype(np.float32),
                "c": rng.standard_normal((4, 4, 80)).astype(np.float32)}
               for _ in range(2)]
    return conv, wavenet, vocoder


def _experiment_specs(tmp_path):
    """One store and configuration (with both statistics hooks on); a spec
    for the world and one for the single-device run, each with its own
    experiments directory."""
    root, spec_path, store_root = _setup(
        tmp_path, cfg_overrides={"use_data_parallel": True,
                                 "record_codebook_stats": True,
                                 "record_gradient_stats": True},
        experiments={"tiny": {"num_epochs": 1}})
    with open(spec_path) as f:
        spec = json.load(f)
    spec["experiments_path"] = os.path.join(root, "experiments_single")
    single = os.path.join(root, "single.json")
    with open(single, "w") as f:
        json.dump(spec, f)
    return spec_path, single, store_root


def _ljspeech(tmp_path):
    """The JAX tests' synthetic LJSpeech tree (8 one-second tones),
    preprocessed by the port's CLI."""
    from vqvae_speech_tpu_torch.vocoder_main import main

    _mini_ljspeech(str(tmp_path), n=8)
    data = str(tmp_path / "lj")
    assert main(["preprocess", "--in_dir", str(tmp_path),
                 "--out_dir", data]) == 0
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    conv, wavenet, vocoder = _batches()
    spec, single_spec, store = _experiment_specs(
        tmp_path_factory.mktemp("experiment"))
    lj = tmp_path_factory.mktemp("vocoder_cli")
    data = _ljspeech(lj)
    inputs = {"conv": CONV, "conv_batches": conv, "wavenet": WAVENET,
              "wavenet_batches": wavenet, "vocoder_batches": vocoder,
              "experiment": (spec, store),
              "vocoder_cli": (data, str(lj / "dp"))}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with World("tests.torch_parallel_jobs:data_parallel", WORLD, inputs,
                   tmp_path_factory.mktemp("world2")) as ranks:
            single = {name: run_conv_steps(cfg, conv, None)
                      for name, cfg in CONV.items()}
            single["wavenet"] = run_wavenet_steps(WAVENET, wavenet, None)
            for kind in VOCODERS:
                single[kind] = run_vocoder_steps(kind, vocoder, None)
            single["experiment"] = run_experiment(single_spec, store)
            single["vocoder_cli"] = run_vocoder_cli(data, str(lj / "single"))
            single["vocoder_dirs"] = (str(lj / "dp"), str(lj / "single"))
            return single, ranks.join(deadline=90.0)
    finally:
        torch.set_num_threads(threads)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _adam_noise(got, want, lr, steps):
    """The parameters' differences: a median and a quantile near f32
    noise; an element whose gradient is f32 noise about an exact zero can
    take another Adam step in each run, about lr at most a step."""
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    assert np.median(diff) <= 1e-6
    assert np.quantile(diff, 0.9) <= 1e-5
    assert diff.max() <= lr * steps


def _same_state(a, b):
    for x, y in zip(a["params"] + a["moments"], b["params"] + b["moments"]):
        np.testing.assert_array_equal(x, y)
    for k in a["buffers"]:
        np.testing.assert_array_equal(a["buffers"][k], b["buffers"][k])


@pytest.mark.parametrize("name", list(CONV) + ["wavenet"])
def test_codes_equal_the_global_search_at_every_step(runs, name):
    single, ranks = runs
    for out in ranks:
        assert len(out[name]["codes"]) == len(single[name]["codes"])
        for got, want in zip(out[name]["codes"], single[name]["codes"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CONV) + ["wavenet"])
def test_losses_equal_the_global_batch(runs, name):
    single, ranks = runs
    for out in ranks:
        for got, want in zip(out[name]["metrics"], single[name]["metrics"]):
            assert set(got) == set(want)
            for key in want:
                _close(got[key], want[key], 1e-5)


@pytest.mark.parametrize("name", list(CONV) + ["wavenet"])
def test_parameters_follow_the_global_step(runs, name):
    single, ranks = runs
    lr = (WAVENET if name == "wavenet" else CONV[name])["learning_rate"]
    for out in ranks:
        _adam_noise(out[name]["state"]["params"],
                    single[name]["state"]["params"], lr,
                    len(single[name]["metrics"]))


def test_ema_buffers_equal_the_global_statistics(runs):
    single, ranks = runs
    want = single["ema_jitter_revival"]["state"]["buffers"]
    assert {"vq.codebook", "vq.ema_w", "vq.ema_cluster_size",
            "revival_usage"} <= set(want)
    for out in ranks:
        got = out["ema_jitter_revival"]["state"]["buffers"]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-6)


def test_the_state_is_bit_equal_across_ranks(runs):
    _, (a, b) = runs
    assert (a["data_rank"], b["data_rank"]) == (0, 1)
    for name in list(CONV) + ["wavenet"]:
        _same_state(a[name]["state"], b[name]["state"])
    for kind in VOCODERS:
        for x, y in zip(a[kind]["params"] + a[kind]["ema"],
                        b[kind]["params"] + b[kind]["ema"]):
            np.testing.assert_array_equal(x, y)


def test_a_per_rank_flatten_would_search_other_rows(runs):
    """The trap: each rank flattening its own half of the batch in (C, T, B)
    order makes other rows, and at this size other codes, than the global
    flatten that the data-parallel step searches."""
    from vqvae_speech_tpu_torch import convert
    from vqvae_speech_tpu_torch.models import ConvVQVAE

    single, ranks = runs
    cfg = CONV["gradient_jitter"]
    model = convert.load_jax_params(ConvVQVAE.from_config(cfg),
                                    *convert.numpy_params(cfg, 0))
    x = torch.from_numpy(_batches()[0][0]["input_features"])
    with torch.no_grad():
        z = model.latents(x)
        whole = model.vq(z).indices[:, 0].numpy()
        halves = np.concatenate([model.vq(z[:2]).indices[:, 0].numpy(),
                                 model.vq(z[2:]).indices[:, 0].numpy()])
    np.testing.assert_array_equal(whole, single["gradient_jitter"]["codes"][0])
    assert (whole != halves).mean() > 0.1
    for out in ranks:
        np.testing.assert_array_equal(out["gradient_jitter"]["codes"][0],
                                      whole)


@pytest.mark.parametrize("kind", VOCODERS)
def test_vocoder_steps_equal_the_global_step(runs, kind):
    """Every step's loss and loss terms within 1e-5 relative; the flow's
    loss -(log_p + logdet) is a difference of two terms that cancel to a
    tenth of their size, so after the first step (where the parameters
    still agree bit for bit) it is held through its terms."""
    single, ranks = runs
    for out in ranks:
        losses = out[kind]["losses"]
        _close(losses if kind != "flow" else losses[:1],
               single[kind]["losses"][:len(losses) if kind != "flow" else 1],
               1e-5)
        for got, want in zip(out[kind]["terms"], single[kind]["terms"]):
            assert set(got) == set(want)
            for key in want:
                _close(got[key], want[key], 1e-5)
        steps = len(single[kind]["losses"])
        _adam_noise(out[kind]["params"], single[kind]["params"], 1e-3, steps)
        _adam_noise(out[kind]["ema"], single[kind]["ema"], 1e-3, steps)


def test_experiment_trains_data_parallel_and_rank_0_writes(runs):
    """One epoch of 4 steps at a global batch of 4; the statistics hooks
    record the global batch's codes and gradients, rank 0 writes them."""
    import pickle

    single, (a, b) = runs
    assert a["experiment"]["data_parallel"] and b["experiment"]["data_parallel"]
    assert not single["experiment"]["data_parallel"]
    assert a["experiment"]["saves"] == [0] and b["experiment"]["saves"] == []
    got, want = a["experiment"]["losses"], single["experiment"]["losses"]
    assert len(got) == len(want) == 16 // 4
    for g, w in zip(got, want):
        for key in w:
            _close(g[key], w[key], 1e-5)
    dirs = [a["experiment"]["path"], single["experiment"]["path"]]
    stats = [sorted(f for f in os.listdir(d) if f.endswith("-stats.pickle"))
             for d in dirs]
    assert stats[0] == stats[1] and len(stats[0]) == 2 * 4
    for name in stats[0]:
        dp, one = (pickle.load(open(os.path.join(d, name), "rb"))
                   for d in dirs)
        if name.endswith("codebook-stats.pickle"):
            assert dp["batch_size"] == one["batch_size"] == 4
            np.testing.assert_array_equal(dp["speaker_ids"],
                                          one["speaker_ids"])
            assert dp["encoding_indices"].shape == \
                one["encoding_indices"].shape
        else:
            assert dp["model"]["layers"] == one["model"]["layers"]
            np.testing.assert_allclose(dp["model"]["avg_grads"],
                                       one["model"]["avg_grads"], rtol=1e-3)


def test_vocoder_cli_trains_data_parallel_and_rank_0_writes(runs):
    from vqvae_speech_tpu_torch.train.vocoder import (
        load_vocoder_checkpoint,
        tree_leaves,
    )

    single, (a, b) = runs
    assert a["vocoder_cli"]["code"] == b["vocoder_cli"]["code"] == 0
    assert a["vocoder_cli"]["saves"] == single["vocoder_cli"]["saves"]
    assert a["vocoder_cli"]["saves"] and b["vocoder_cli"]["saves"] == []
    dp, one = (load_vocoder_checkpoint(os.path.join(d, "teacher_0.pkl"))
               for d in single["vocoder_dirs"])
    assert dp["step"] == one["step"] == 8 // 2
    _close(dp["train_losses"], one["train_losses"], 1e-5)
    _adam_noise(tree_leaves(dp["params"]), tree_leaves(one["params"]), 1e-3,
                dp["step"])
