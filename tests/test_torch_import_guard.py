"""PyTorch port: every module imports, and the CLI trains, with ``jax``,
``optax``, ``yaml`` and the JAX package unimportable (the GPU machine has no
JAX and no PyYAML). Run in a subprocess, where those names are set to None
in ``sys.modules`` before anything is imported."""
import os
import subprocess
import sys
import textwrap

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu"):
        sys.modules[name] = None
    sys.path.insert(0, {root!r})
""")


def _run(body, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", GUARD.format(root=REPO_ROOT)
         + textwrap.dedent(body)],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_every_module_imports_without_jax_or_yaml(tmp_path):
    out = _run("""
        import importlib, pkgutil
        import vqvae_speech_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            vqvae_speech_tpu_torch.__path__, "vqvae_speech_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "vqvae_speech_tpu_torch.main" in names
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu")
                     and sys.modules[m] is not None)
        print(len(names), "modules", bad)
    """, tmp_path)
    count, _, bad = out.split(maxsplit=2)
    assert int(count) > 40 and bad.strip() == "[]"


def test_the_cli_trains_without_jax_or_yaml(tmp_path):
    """A synthetic store, its stats, a base config written by the port's
    writer and two epochs of the default mode, then a resume to epoch 3."""
    _run("""
        import json, os
        from vqvae_speech_tpu_torch.data import FeatureStore, compute_dataset_stats
        from vqvae_speech_tpu_torch.data.synthetic import build_synthetic_store
        from vqvae_speech_tpu_torch.main import main
        from vqvae_speech_tpu_torch.train import find_checkpoints
        from vqvae_speech_tpu_torch.train.config import (
            freeze_configuration, load_configuration)

        build_synthetic_store("store/features", 8, 2, device="cpu")
        compute_dataset_stats(FeatureStore("store/features"), "stats.pickle")
        cfg = load_configuration({base!r})
        cfg.update(num_hiddens=16, residual_channels=16, embedding_dim=8,
                   data_root="store", normalizer_path="stats.pickle")
        freeze_configuration(cfg, ".", "base")
        spec = dict(experiments_path="runs", results_path="results",
                    configuration_path="base_configuration.yaml", seed=3,
                    experiments=dict(jitter12=dict(
                        num_epochs=2, batch_size=2, num_embeddings=44,
                        normalize=True, use_jitter=True,
                        jitter_probability=0.12)))
        with open("spec.json", "w") as f:
            json.dump(spec, f)
        args = ["--experiments_configuration_path", "spec.json",
                "--device", "cpu"]
        assert main(args) == 0
        frozen = load_configuration("runs/jitter12_configuration.yaml")
        freeze_configuration(dict(frozen, num_epochs=3), "runs", "jitter12")
        assert main(args) == 0
        assert [e for e, _ in find_checkpoints("runs", "jitter12")] == [1, 2, 3]
    """.replace("{base!r}", repr(os.path.join(REPO_ROOT, "configurations",
                                             "vctk_features.yaml")))
         , tmp_path)
