"""PyTorch port: the vocoder CLI (``python -m
vqvae_speech_tpu_torch.vocoder_main``) end to end on the CPU at its --tiny
presets: preprocess the JAX tests' synthetic LJSpeech layout, train the
teacher (and resume it, and at --bf16), the student (both KL directions)
and the flow for an epoch, then synthesize from each. The files are the JAX
package's CLI's: ``{name}_{epoch}.pkl``, ``{name}_best.pkl``,
``{name}_train.npy``, ``{name}.npy``, the flow's
``generate_{name}_{epoch}.wav`` on a new best (vocoder_main.py:374-387) and
16-bit 22050 Hz waves of 256 samples a mel frame.
"""
import os

import numpy as np
import pytest
from scipy.io import wavfile

from tests.test_ljspeech_vocoder import _mini_ljspeech
from tests.test_torch_vocoder_train import one_torch_thread  # noqa: F401
from vqvae_speech_tpu_torch.train.vocoder import load_vocoder_checkpoint
from vqvae_speech_tpu_torch.vocoder_main import main


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """20 utterances: the 5% test split holds one, a batch of 1."""
    root = str(tmp_path_factory.mktemp("cli"))
    _mini_ljspeech(root, n=20)
    data = os.path.join(root, "lj")
    assert main(["preprocess", "--in_dir", root, "--out_dir", data]) == 0
    ckpt = os.path.join(root, "ckpt")
    common = ["--data_root", data, "--checkpoint_dir", ckpt,
              "--batch_size", "1", "--tiny", "--device", "cpu"]
    assert main(["train-teacher", "--epochs", "1"] + common) == 0
    assert main(["train-teacher", "--epochs", "2", "--resume",
                 os.path.join(ckpt, "teacher_0.pkl")] + common) == 0
    teacher = os.path.join(ckpt, "teacher_best.pkl")
    for kl in ("qp", "pq"):
        assert main(["train-student", "--epochs", "1", "--KL_type", kl,
                     "--model_name", f"student_{kl}",
                     "--teacher_checkpoint", teacher] + common) == 0
    assert main(["train-flow", "--epochs", "1"] + common) == 0
    assert main(["train-teacher", "--epochs", "1", "--bf16",
                 "--model_name", "teacher_bf16"] + common) == 0
    mel = np.load(os.path.join(data, "ljspeech-mel-00001.npy"))
    np.save(os.path.join(root, "mel.npy"), mel[:4])   # 4 frames
    return root, data, ckpt


def test_preprocess_writes_the_store(trained):
    _, data, _ = trained
    files = sorted(os.listdir(data))
    assert files[-1] == "train.txt" and len(files) == 41
    with open(os.path.join(data, "train.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("ljspeech-audio-00001.npy|ljspeech-mel-00001"
                               ".npy|")


def test_training_writes_the_jax_files(trained):
    _, _, ckpt = trained
    files = set(os.listdir(ckpt))
    for name, epochs in (("teacher", 2), ("student_qp", 1),
                         ("student_pq", 1), ("flow", 1),
                         ("teacher_bf16", 1)):
        assert {f"{name}_train.npy", f"{name}.npy", f"{name}_best.pkl"} \
            <= files
        for epoch in range(epochs):
            assert f"{name}_{epoch}.pkl" in files
        losses = np.load(os.path.join(ckpt, f"{name}_train.npy"))
        assert losses.shape == (epochs,) and np.isfinite(losses).all()
    assert "generate_flow_0.wav" in files
    rate, wave = wavfile.read(os.path.join(ckpt, "generate_flow_0.wav"))
    assert rate == 22050 and wave.dtype == np.int16
    assert len(wave) % 256 == 0 and len(wave) > 0
    resumed = load_vocoder_checkpoint(os.path.join(ckpt, "teacher_1.pkl"))
    assert resumed["epoch"] == 1 and resumed["step"] == 2 * 19
    assert int(resumed["opt_state"][1][0]) == 2 * 19
    assert len(resumed["train_losses"]) == 2


@pytest.mark.parametrize("kind", ["teacher", "student", "flow"])
def test_synthesize(trained, kind):
    root, _, ckpt = trained
    name = "student_qp" if kind == "student" else kind
    out = os.path.join(root, f"{kind}.wav")
    args = [f"synthesize-{kind}", "--checkpoint",
            os.path.join(ckpt, f"{name}_best.pkl"),
            "--mel_path", os.path.join(root, "mel.npy"), "--out_wav", out,
            "--tiny", "--device", "cpu"]
    if kind == "student":
        args += ["--teacher_checkpoint",
                 os.path.join(ckpt, "teacher_best.pkl")]
    assert main(args) == 0
    rate, wave = wavfile.read(out)
    assert rate == 22050 and wave.dtype == np.int16 and wave.shape == (1024,)
    assert wave.std() > 0
    again = out.replace(".wav", "_again.wav")
    assert main([a if a != out else again for a in args]) == 0
    np.testing.assert_array_equal(wavfile.read(again)[1], wave)


def test_data_parallel_raises(trained, tmp_path):
    """``--data_parallel`` is ported: outside ``torchrun`` the world has one
    rank and the flag trains on the one device, as the JAX CLI does on one
    device (tests/test_torch_parallel_train.py holds the data-parallel
    steps over two ranks)."""
    _, data, _ = trained
    out = str(tmp_path / "dp")
    assert main(["train-teacher", "--data_root", data, "--checkpoint_dir",
                 out, "--tiny", "--device", "cpu", "--data_parallel",
                 "--epochs", "1"]) == 0
    assert os.path.isfile(os.path.join(out, "teacher_0.pkl"))
