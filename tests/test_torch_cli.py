"""PyTorch port: the CLI (``python -m vqvae_speech_tpu_torch.main``).

Torch twins of ``tests/test_cli.py``: the parser has the JAX CLI's flags
plus ``--device`` (default "cuda": the entry point runs on the card unless
asked for the CPU), ``--summary`` prints what the JAX CLI prints line for
line, the default mode trains with ``--device cpu`` on a synthetic store,
the export and stats modes write their files from a VCTK tree, and
``--evaluate`` / ``--plot_experiments_losses`` run, and refuse what only
draws a figure under ``--no_figures`` (the port's second flag beside
``--device``).
"""
import argparse
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_training import TINY_CFG, _setup
from vqvae_speech_tpu import main as jmain
from vqvae_speech_tpu_torch import main as tmain
from vqvae_speech_tpu_torch.train import Experiments, find_checkpoints

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO_ROOT, "quality_parity", "raw", "VCTK-Corpus")


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type,
                     a.help, type(a))
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_is_the_jax_parser_plus_device():
    got, want = _actions(tmain.build_parser()), _actions(jmain.build_parser())
    device = got.pop("device")
    no_figures = got.pop("no_figures")
    assert got == want
    assert device[0] == ("--device",) and device[1] == "cuda"
    assert no_figures[0] == ("--no_figures",) and no_figures[1] is False
    args = tmain.build_parser().parse_args(["--device", "cpu",
                                            "--alignment_subset", "train"])
    assert args.device == "cpu" and args.alignment_subset == "train"


@pytest.mark.parametrize("overrides", [
    {}, {"use_kaiming_normal": True}, {"decay": 0.99},
    {"use_speaker_conditioning": True, "num_speakers": 6},
], ids=["baseline", "weight_norm", "ema", "speaker"])
def test_summary_prints_what_jax_prints(tmp_path, capsys, overrides):
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.dump(dict(TINY_CFG, **overrides), f)
    assert jmain.main(["--summary", cfg_path]) == 0
    want = capsys.readouterr().out
    assert tmain.main(["--summary", cfg_path]) == 0
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert "pre_vq_conv" in got and "tensors" in got


def test_summary_runs_as_a_script_from_another_directory(tmp_path):
    """main.py puts the repository root on sys.path, as the JAX CLI does."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "vqvae_speech_tpu_torch",
                                      "main.py"),
         "--summary", os.path.join(REPO_ROOT, "configurations",
                                   "vctk_features.yaml")],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert "25 tensors, 16,378,023 parameters" in out.stdout


def test_default_mode_trains_on_the_cpu(tmp_path):
    root, spec_path, store_root = _setup(tmp_path)
    with open(spec_path) as f:
        base_cfg_path = json.load(f)["configuration_path"]
    with open(base_cfg_path) as f:
        cfg = yaml.load(f, yaml.FullLoader)
    cfg["data_root"] = root          # features live at <root>/features
    with open(base_cfg_path, "w") as f:
        yaml.dump(cfg, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain.main(["--experiments_configuration_path", spec_path])
    assert tmain.main(["--experiments_configuration_path", spec_path,
                       "--device", "cpu"]) == 0
    exp_dir = os.path.join(root, "experiments")
    assert [e for e, _ in find_checkpoints(exp_dir, "tiny")] == [1, 2]


def test_export_and_stats_modes_write_their_files(tmp_path, monkeypatch):
    """From a working directory holding configurations/ and data/vctk/raw
    (p300 and p301, five utterances each), as the JAX CLI runs."""
    os.makedirs(tmp_path / "configurations")
    for name in ("vctk_features.yaml", "experiments_vq44-mfcc39.json"):
        os.symlink(os.path.join(REPO_ROOT, "configurations", name),
                   tmp_path / "configurations" / name)
    for sub in ("wav48", "txt", "phonemes"):
        for speaker in ("p300", "p301"):
            d = tmp_path / "data" / "vctk" / "raw" / "VCTK-Corpus" / sub / speaker
            d.mkdir(parents=True)
            for name in sorted(os.listdir(os.path.join(CORPUS, sub,
                                                       speaker)))[:5]:
                os.symlink(os.path.join(CORPUS, sub, speaker, name), d / name)
    monkeypatch.chdir(tmp_path)
    assert tmain.main(["--export_to_features", "--device", "cpu"]) == 0
    features = tmp_path / "data" / "vctk" / "features"
    n = {split: np.load(features / f"{split}.speaker_ids.npy").shape[0]
         for split in ("train", "val")}
    assert n == {"train": 8, "val": 2}
    assert np.load(features / "train.input_features.npy").shape == (8, 47, 39)
    assert np.load(features / "val.preprocessed_audio.npy").shape == (2, 7681)
    assert tmain.main(["--compute_dataset_stats", "--device", "cpu"]) == 0
    with open(tmp_path / "data" / "vctk" / "vctk-mfcc-stats.pickle", "rb") as f:
        stats = pickle.load(f)
    assert stats["train_mean"].shape == stats["train_std"].shape == (39,)


@pytest.mark.parametrize("flag", ["--evaluate", "--plot_experiments_losses"])
def test_evaluation_modes_raise_naming_item_9(tmp_path, monkeypatch, flag):
    """ROADMAP item 9 is ported: under --no_figures a mode or option that
    only draws a figure raises naming the flag; otherwise the mode runs on
    the CPU (an evaluation with no checkpoint takes a fresh init)."""
    root, spec_path, _ = _setup(tmp_path)
    monkeypatch.chdir(root)       # the config's data_root is "."
    args = [flag, "--experiments_configuration_path", spec_path,
            "--device", "cpu"]
    figure_only = ["--plot_distances_histogram"] if flag == "--evaluate" \
        else []
    with pytest.raises(ValueError, match="--no_figures"):
        tmain.main(args + figure_only + ["--no_figures"])
    results = os.path.join(root, "results")
    if flag == "--evaluate":
        assert tmain.main(args + ["--compute_alignments", "--no_figures"]) == 0
        with open(os.path.join(
                results, "tiny_vctk_val_empirical_alignments.pickle"),
                "rb") as f:
            emp = pickle.load(f)
        assert [len(s) for _, s in emp["all_alignments"]] == [24] * 4
        assert not [f for f in os.listdir(results) if f.endswith(".png")]
    else:
        Experiments.load(spec_path, data_root=os.path.join(root, "features"),
                         device="cpu").train()
        assert tmain.main(args + ["--experiments_path",
                                  os.path.join(root, "experiments")]) == 0
        assert os.path.isfile(os.path.join(
            results, "tiny_losses-and-perplexities.png"))
