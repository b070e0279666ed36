"""PyTorch port: the experiments driver's contract, on the CPU.

Torch twins of ``tests/test_training.py``'s driver tests on the same tiny
configuration and synthetic store: seed fan-out names, a fresh run that
trains and checkpoints every epoch (the loss falls on the easy synthetic
set), auto-resume where the frozen config wins, the EMA state in the
checkpoint, the ``profile_steps`` timing line, and the options the port does
not run raising by name. The numbers themselves are held against JAX in
``tests/test_torch_training_loop.py``.
"""
import json
import os

import numpy as np
import pytest
import yaml

from test_training import TINY_CFG, _setup
from vqvae_speech_tpu.train import Experiments as JaxExperiments
from vqvae_speech_tpu_torch.convert import numpy_params
from vqvae_speech_tpu_torch.train import (
    ConvolutionalTrainer,
    Experiments,
    find_checkpoints,
    load_checkpoint,
    load_configuration,
    merge_checkpoint_losses,
)


def _set_frozen(exp_dir, name, **values):
    frozen = os.path.join(exp_dir, f"{name}_configuration.yaml")
    with open(frozen) as f:
        cfg = yaml.load(f, yaml.FullLoader)
    cfg.update(values)
    with open(frozen, "w") as f:
        yaml.dump(cfg, f)
    return frozen


def test_seed_fanout_naming_equals_jax(tmp_path):
    root, spec_path, store_root = _setup(tmp_path)
    with open(spec_path) as f:
        spec = json.load(f)
    spec["seed"] = [1, 2]
    spec["experiments"]["other"] = {"num_epochs": 1}
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    got = Experiments.load(spec_path, data_root=store_root, device="cpu")
    want = JaxExperiments.load(spec_path, data_root=store_root)
    names = [e.name for e in got.experiments]
    assert names == [e.name for e in want.experiments]
    assert sorted(names) == ["other-seed1", "other-seed2", "tiny-seed1",
                             "tiny-seed2"]
    assert [e.seed for e in got.experiments] == [1, 1, 2, 2]
    # JAX read the frozen configs the port wrote: the same merge
    for exp, jexp in zip(got.experiments, want.experiments):
        assert not exp.resumed and jexp.resumed
        assert exp.configuration == jexp.configuration


def test_fresh_run_trains_checkpoints_and_resumes(tmp_path, capsys):
    root, spec_path, store_root = _setup(tmp_path)
    exps = Experiments.load(spec_path, data_root=store_root, device="cpu")
    assert not exps.experiments[0].resumed
    exps.train()
    exp_dir = os.path.join(root, "experiments")
    assert [e for e, _ in find_checkpoints(exp_dir, "tiny")] == [1, 2]
    losses, perplexities = merge_checkpoint_losses(exp_dir, "tiny")
    assert len(losses) == len(perplexities) == 2 * 4   # 2 epochs x 16/4
    assert all(np.isfinite(entry["loss"]) for entry in losses)
    assert losses[-1]["loss"] < losses[0]["loss"]
    first = load_checkpoint(find_checkpoints(exp_dir, "tiny")[0][1])
    assert first["epoch"] == 1 and first["experiment_name"] == "tiny"
    out = capsys.readouterr().out
    assert "Epoch 2: loss" in out and "start epoch: 0" in out

    # the frozen config wins: num_epochs 3 there, the spec still says 2
    frozen = _set_frozen(exp_dir, "tiny", num_epochs=3)
    exps = Experiments.load(spec_path, data_root=store_root, device="cpu")
    assert exps.experiments[0].resumed
    assert exps.experiments[0].configuration == load_configuration(frozen)
    trainer = exps.experiments[0].build_trainer()
    assert trainer.state.opt_state.count == 8
    exps.train()
    assert [e for e, _ in find_checkpoints(exp_dir, "tiny")] == [1, 2, 3]
    assert "start epoch: 2" in capsys.readouterr().out
    last = load_checkpoint(find_checkpoints(exp_dir, "tiny")[-1][1])
    assert int(last["opt_state"][0][0]) == 12


def test_ema_state_and_step_times(tmp_path, capsys):
    root, spec_path, store_root = _setup(
        tmp_path, cfg_overrides={"decay": 0.99},
        experiments={"ema": {"num_epochs": 1}})
    base = os.path.join(root, "base.yaml")
    with open(base) as f:
        cfg = yaml.load(f, yaml.FullLoader)
    cfg["profile_steps"] = True      # not a key of the repository's base
    with open(base, "w") as f:
        yaml.dump(cfg, f)
    Experiments.load(spec_path, data_root=store_root, device="cpu").train()
    ckpt = load_checkpoint(find_checkpoints(os.path.join(root, "experiments"),
                                            "ema")[-1][1])
    vq = ckpt["model_state"]["vq"]
    assert set(vq) == {"codebook", "ema_cluster_size", "ema_w"}
    assert np.any(vq["ema_cluster_size"] != 0)
    assert ckpt["params"]["vq"] == {}
    assert "steps/sec" in capsys.readouterr().out


# decoder_type wavenet (ROADMAP item 10) and compute_dtype bfloat16 (item
# 11) were refused here until they were ported: their cases now train; the
# ids are kept
@pytest.mark.parametrize("override, match", [
    pytest.param({"decoder_type": "wavenet", "n_loop": 2, "n_layers": 4,
                  "filter_size": 2, "gate_channels": 8,
                  "skip_out_channels": 8, "global_condition_dim": 6,
                  "local_condition_dim": 16, "num_speakers": 4}, None,
                 id="override0-ROADMAP item 10"),
    pytest.param({"decoder_type": "transformer"}, "no trainer pipeline",
                 id="override1-no trainer pipeline"),
    pytest.param({"compute_dtype": "bfloat16"}, None, id="override2-11.4"),
    # ported (ROADMAP item 14): without a process group the world has one
    # rank and the experiment trains on the one device, as the JAX package
    # does when its data axis has size 1
    pytest.param({"use_data_parallel": True}, None,
                 id="override3-item 14"),
])
def test_unported_options_raise(tmp_path, override, match):
    root, spec_path, store_root = _setup(tmp_path, cfg_overrides=override)
    exp = Experiments.load(spec_path, data_root=store_root,
                           device="cpu").experiments[0]
    if match is None:
        exp.train()
        assert [e for e, _ in find_checkpoints(
            os.path.join(root, "experiments"), "tiny")] == [1, 2]
        return
    with pytest.raises(NotImplementedError, match=match):
        exp.train()
    assert find_checkpoints(os.path.join(root, "experiments"), "tiny") == []


def test_evaluation_raises_and_the_device_is_named(tmp_path):
    """Evaluation runs on the experiment's device; what only draws a
    figure raises under figures=False, before any work."""
    root, spec_path, store_root = _setup(tmp_path)
    exps = Experiments.load(spec_path, data_root=store_root, device="cpu")
    results = os.path.join(root, "results")
    with pytest.raises(ValueError, match="plot_gradient_stats"):
        exps.evaluate({"compute_alignments": True,
                       "plot_gradient_stats": True}, figures=False)
    with pytest.raises(ValueError, match="plot_comparaison_plot"):
        exps.experiments[0].evaluate({"plot_comparaison_plot": True},
                                     figures=False)
    assert not os.listdir(results)
    out = exps.evaluate({"compute_alignments": True}, figures=False)
    assert set(out) == {"tiny"}
    assert os.path.isfile(out["tiny"]["alignments"]["empirical"])
    with pytest.raises(TypeError, match="device"):
        Experiments.load(spec_path, data_root=store_root)


def test_trainer_refuses_a_mesh_and_names_its_device(tmp_path):
    """A mesh that is not a (data, model) DeviceMesh is refused (a real one
    trains: tests/test_torch_parallel_train.py), as is a trainer without a
    device."""
    params, state = numpy_params(TINY_CFG, seed=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ConvolutionalTrainer(TINY_CFG, params, state, [], str(tmp_path), "x",
                             mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="device"):
        ConvolutionalTrainer(TINY_CFG, params, state, [], str(tmp_path), "x")
