"""PyTorch port: every module imports, the CLI trains, and it evaluates
with ``--no_figures``, with ``jax``, ``optax``, ``yaml``, ``sklearn``,
``matplotlib``, ``umap`` and the JAX package unimportable (the GPU machine
has no JAX, no PyYAML, no scikit-learn, no matplotlib and no UMAP). Run in a
subprocess, where those names are set to None in ``sys.modules`` before
anything is imported."""
import os
import subprocess
import sys
import textwrap

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu",
                 "sklearn", "matplotlib", "umap"):
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
                     ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu",
                      "sklearn", "matplotlib", "umap")
                     and sys.modules[m] is not None)
        assert "vqvae_speech_tpu_torch.eval.evaluator" in names
        for name in ("native", "data.noise_injector",
                     "data.spectrogram_dataset", "models.vq_adaptive",
                     "models.vq_balanced", "models.vq_repulsion",
                     "utils.errors", "utils.workspace", "utils.profiling",
                     "examples.vq_2d_clustering", "examples.vq_2d_repulsion",
                     "examples.vq_balanced_2d", "examples.encode_wav",
                     "examples.serve_vocoder", "parallel", "parallel.mesh",
                     "parallel.sharded_vq", "parallel.tp_decode",
                     "parallel.sp_vocoder", "train.dcp_checkpoint"):
            assert "vqvae_speech_tpu_torch." + name in names, name
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


def test_the_cli_evaluates_without_sklearn_or_matplotlib(tmp_path):
    """The port's synthetic phoneme corpus (TextGrids included), its export
    and stats, one epoch of the default mode, then ``--evaluate`` with every
    option that writes numbers and ``--no_figures``: the files are written
    and no figure. With figures on, the same call raises ImportError naming
    matplotlib and --no_figures before any work."""
    _run("""
        import json, os
        import numpy as np
        from vqvae_speech_tpu_torch.data import FeatureStore, compute_dataset_stats
        from vqvae_speech_tpu_torch.data.export import export_to_features
        from vqvae_speech_tpu_torch.data.synthetic_phonemes import (
            build_phoneme_corpus)
        from vqvae_speech_tpu_torch.data.vctk import VCTK
        from vqvae_speech_tpu_torch.main import main
        from vqvae_speech_tpu_torch.train.config import (
            freeze_configuration, load_configuration)

        build_phoneme_corpus("corpus", num_speakers=2, utts_per_speaker=5)
        cfg = load_configuration({base!r})
        cfg.update(num_hiddens=16, residual_channels=16, embedding_dim=8,
                   data_root="corpus", normalizer_path="stats.pickle")
        export_to_features(VCTK("corpus", ratio=0.8, shuffle_seed=0),
                           "corpus/features", cfg, device="cpu")
        compute_dataset_stats(FeatureStore("corpus/features"), "stats.pickle")
        freeze_configuration(cfg, ".", "base")
        spec = dict(experiments_path="runs", results_path="results",
                    configuration_path="base_configuration.yaml", seed=3,
                    experiments=dict(jitter12=dict(
                        num_epochs=1, batch_size=2, num_embeddings=44,
                        normalize=True, use_jitter=True,
                        jitter_probability=0.12)))
        with open("spec.json", "w") as f:
            json.dump(spec, f)
        args = ["--experiments_configuration_path", "spec.json",
                "--device", "cpu"]
        assert main(args) == 0
        evaluate = args + [
            "--evaluate", "--compute_alignments", "--per_frame_alignments",
            "--compute_clustering_metrics", "--compute_many_to_one_mapping",
            "--compute_groundtruth_average_phonemes_number"]
        try:
            main(evaluate)
            raise AssertionError("figures on without matplotlib ran")
        except ImportError as e:
            assert "matplotlib" in str(e) and "--no_figures" in str(e), e
        assert not os.path.exists("results/jitter12_tokens_mapping.pickle")
        assert main(evaluate + ["--no_figures"]) == 0
        files = sorted(os.listdir("results"))
        for name in ("vctk_val_groundtruth_alignments.pickle",
                     "jitter12_vctk_val_empirical_alignments.pickle",
                     "jitter12_vctk_val_empirical_alignments_per_frame.pickle",
                     "jitter12_tokens_mapping.pickle",
                     "jitter12_phonemes_mapping.pickle",
                     "jitter12_adjusted_rand_score.npy",
                     "jitter12_per_frame_normalized_mutual_info_score.npy",
                     "vctk_val_groundtruth_bigrams_wo_diag_20ms.npy",
                     "jitter12_vctk_val_empirical_bigrams_wo_diag_10ms.npy"):
            assert name in files, (name, files)
        assert not [f for f in files if f.endswith(".png")]
        ari = float(np.load("results/jitter12_adjusted_rand_score.npy"))
        assert -1 <= ari <= 1
    """.replace("{base!r}", repr(os.path.join(REPO_ROOT, "configurations",
                                             "vctk_features.yaml")))
         , tmp_path)


def test_continuous_synthesis_serves_without_jax(tmp_path):
    """The AR serving slice's new modules (models/wavenet/chunked.py,
    mixture.py, util.py, serve.ContinuousSynthesisServer) import and serve
    with JAX unimportable: a factory-built model drains greedy f32, int8
    and bf16 pools and a sampled mixture pool."""
    out = _run("""
        import numpy as np
        import torch
        from vqvae_speech_tpu_torch.models.wavenet import (
            build_wavenet_from_hparams, discretized_mix_logistic_loss)
        from vqvae_speech_tpu_torch.models.wavenet.chunked import (
            decode_chunk, init_decode_slots)
        from vqvae_speech_tpu_torch.serve import ContinuousSynthesisServer

        hp = dict(out_channels=32, layers=4, stacks=2, residual_channels=8,
                  gate_channels=8, skip_out_channels=8, kernel_size=2,
                  cin_channels=4, upsample_conditional_features=True,
                  upsample_scales=[2, 2])
        rng = np.random.default_rng(0)
        conds = [rng.standard_normal((n, 4)).astype(np.float32)
                 for n in (5, 3, 6)]
        for kw in ({}, {"weight_quant": "int8"},
                   {"compute_dtype": torch.bfloat16}):
            tree, cfg = build_wavenet_from_hparams(hp, seed=0)
            server = ContinuousSynthesisServer(
                tree, cfg, slots=2, chunk_size=7, max_frames=6,
                device="cpu", **kw)
            waves = [r.wave for r in server.run(conds)]
            assert [len(w) for w in waves] == [20, 12, 24]
        del hp["out_channels"]          # the mixture's default, 10 x 3
        tree, cfg = build_wavenet_from_hparams(dict(hp, input_type="raw"),
                                               seed=1)
        server = ContinuousSynthesisServer(tree, cfg, slots=2, chunk_size=7,
                                           max_frames=6, sample=True,
                                           device="cpu")
        waves = [r.wave for r in server.run(conds, seed=3)]
        assert all(np.abs(w).max() <= 1.0 for w in waves)
        loss = discretized_mix_logistic_loss(torch.zeros(1, 4, 30),
                                             torch.zeros(1, 4, 1))
        assert torch.isfinite(loss)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu")
                     and sys.modules[m] is not None)
        print("served", bad)
    """, tmp_path)
    assert out.split() == ["served", "[]"]


def test_wavenet_training_bf16_and_pth_import_without_jax_or_yaml(tmp_path):
    """The training slice's modules (train/wavenet_trainer.py,
    train/convert_reference.py, nn/cast.py) with JAX and PyYAML
    unimportable: the CLI trains configurations/vctk_wavenet.yaml (cut to
    the tiny width of tests/test_wavenet_trainer.py) one epoch and resumes
    to two; one flagship step runs at compute_dtype bfloat16; a reference
    .pth converts and encodes."""
    out = _run("""
        import json
        import numpy as np
        import torch
        from vqvae_speech_tpu_torch.convert import (
            export_jax_params, load_jax_params, numpy_params)
        from vqvae_speech_tpu_torch.data.synthetic import build_synthetic_store
        from vqvae_speech_tpu_torch.main import main
        from vqvae_speech_tpu_torch.models import ConvVQVAE
        from vqvae_speech_tpu_torch.train import (
            create_train_state, find_checkpoints, load_checkpoint,
            make_optimizer, make_train_step)
        from vqvae_speech_tpu_torch.train.config import (
            freeze_configuration, load_configuration)
        from vqvae_speech_tpu_torch.train.convert_reference import (
            convert_reference_checkpoint)

        build_synthetic_store("store/features", 4, 2, length=1920,
                              device="cpu")
        cfg = load_configuration({wavenet!r})
        assert cfg["decoder_type"] == "wavenet"
        cfg.update(data_root="store", length=1920, input_features_dim=11,
                   quantize=32, num_hiddens=16, embedding_dim=8,
                   num_embeddings=7, residual_channels=8, n_layers=4,
                   filter_size=2, gate_channels=8, skip_out_channels=8,
                   global_condition_dim=6, local_condition_dim=16,
                   num_speakers=4, batch_size=2)
        freeze_configuration(cfg, ".", "base")
        spec = dict(experiments_path="runs", results_path="results",
                    configuration_path="base_configuration.yaml", seed=3,
                    experiments=dict(wn=dict(num_epochs=1)))
        with open("spec.json", "w") as f:
            json.dump(spec, f)
        args = ["--experiments_configuration_path", "spec.json",
                "--device", "cpu"]
        assert main(args) == 0
        frozen = load_configuration("runs/wn_configuration.yaml")
        freeze_configuration(dict(frozen, num_epochs=2), "runs", "wn")
        assert main(args) == 0
        assert [e for e, _ in find_checkpoints("runs", "wn")] == [1, 2]
        ckpt = load_checkpoint("runs/wn_2_checkpoint.pkl")
        assert len(ckpt["params"]["decoder"]["wavenet"]["conv_layers"]) == 4

        flagship = load_configuration({features!r})
        flagship.update(num_hiddens=16, residual_channels=16,
                        embedding_dim=8, compute_dtype="bfloat16")
        params, state = numpy_params(flagship, 0)
        model = load_jax_params(ConvVQVAE.from_config(flagship), params,
                                state)
        optimizer = make_optimizer(flagship["learning_rate"])
        tstate = create_train_state(model, optimizer, device="cpu")
        x = torch.randn(2, 47, 39)
        _, metrics = make_train_step(flagship, optimizer)(
            tstate, {{"input_features": x, "output_features": x}})
        assert all(v.dtype == torch.float32 and torch.isfinite(v)
                   for v in metrics.values())
        assert next(model.parameters()).dtype == torch.float32

        # the model's own weights under the reference's state_dict names
        sd = {{}}
        jparams, _ = export_jax_params(model)

        def put(prefix, conv):
            w = conv["w"].transpose(2, 1, 0)
            sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(w))
            if "b" in conv:
                sd[prefix + ".bias"] = torch.from_numpy(conv["b"])
        for i in range(1, 6):
            put(f"_encoder._conv_{{i}}", jparams["encoder"][f"conv_{{i}}"])
        for side in ("encoder", "decoder"):
            block = jparams[side]["residual_stack"]["block"]
            put(f"_{{side}}._residual_stack._layers.0._block.1", block["conv1"])
            put(f"_{{side}}._residual_stack._layers.0._block.3", block["conv2"])
        put("_pre_vq_conv", jparams["pre_vq_conv"])
        put("_decoder._conv_1", jparams["decoder"]["conv_1"])
        for i in range(1, 4):
            put(f"_decoder._conv_trans_{{i}}",
                jparams["decoder"][f"conv_trans_{{i}}"])
        sd["_vq._embedding.weight"] = torch.from_numpy(
            jparams["vq"]["codebook"])
        torch.save({{"model": sd, "epoch": 1}}, "ref.pth")
        params, state, meta = convert_reference_checkpoint(
            "ref.pth", dict(flagship, decay=0.0))
        imported = load_jax_params(ConvVQVAE.from_config(flagship), params,
                                   state).eval()
        model.eval()
        with torch.no_grad():
            assert torch.equal(imported.encode(x).indices,
                               model.encode(x).indices)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu")
                     and sys.modules[m] is not None)
        print("trained", meta["epoch"], bad)
    """.replace("{wavenet!r}", repr(os.path.join(
        REPO_ROOT, "configurations", "vctk_wavenet.yaml"))).replace(
        "{features!r}", repr(os.path.join(
            REPO_ROOT, "configurations", "vctk_features.yaml")))
        .replace("{{", "{").replace("}}", "}"), tmp_path)
    assert out.split()[-3:] == ["trained", "1", "[]"]


def test_the_vocoder_cli_trains_and_synthesizes_without_jax(tmp_path):
    """The vocoder slice (train/vocoder.py, data/ljspeech.py,
    models/clarinet/loss.py, vocoder_main.py) with JAX, optax and PyYAML
    unimportable: preprocess an LJSpeech-layout tree, one epoch of each
    trainer at --tiny, a resume, then synthesis from each checkpoint."""
    out = _run("""
        import os
        import numpy as np
        import torch
        from scipy.io import wavfile
        from vqvae_speech_tpu_torch.vocoder_main import main

        torch.set_num_threads(1)     # the --tiny widths: as fast, and the
                                     # test processes share the cores
        os.makedirs("lj/wavs")
        rng = np.random.default_rng(0)
        with open("lj/metadata.csv", "w") as f:
            for i in range(4):
                t = np.arange(22050) / 22050.0
                sig = 0.5 * np.sin(2 * np.pi * (200 + 50 * i) * t)
                sig += 0.01 * rng.standard_normal(len(t))
                wavfile.write(f"lj/wavs/LJ001-{i:04d}.wav", 22050,
                              (sig * 32767).astype(np.int16))
                f.write(f"LJ001-{i:04d}|text|text {i}\\n")
        assert main(["preprocess", "--in_dir", "lj", "--out_dir", "data"]) == 0
        common = ["--data_root", "data", "--checkpoint_dir", "ck",
                  "--batch_size", "2", "--tiny", "--device", "cpu"]
        assert main(["train-teacher", "--epochs", "1"] + common) == 0
        assert main(["train-teacher", "--epochs", "2",
                     "--resume", "ck/teacher_0.pkl"] + common) == 0
        assert main(["train-student", "--epochs", "1",
                     "--teacher_checkpoint", "ck/teacher_best.pkl"]
                    + common) == 0
        assert main(["train-flow", "--epochs", "1"] + common) == 0
        np.save("mel.npy", np.load("data/ljspeech-mel-00001.npy")[:2])
        for kind in ("teacher", "student", "flow"):
            args = [f"synthesize-{kind}", "--checkpoint",
                    f"ck/{kind}_best.pkl", "--mel_path", "mel.npy",
                    "--out_wav", f"{kind}.wav", "--tiny", "--device", "cpu"]
            if kind == "student":
                args += ["--teacher_checkpoint", "ck/teacher_best.pkl"]
            assert main(args) == 0
            assert wavfile.read(f"{kind}.wav")[1].shape == (512,)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu")
                     and sys.modules[m] is not None)
        print("vocoders", sorted(os.listdir("ck"))[:3], bad)
    """, tmp_path)
    last = out.splitlines()[-1].split()
    assert last[0] == "vocoders" and last[-1] == "[]"


def test_the_demos_and_host_modules_run_without_jax_or_sklearn(tmp_path):
    """What differs without JAX, scikit-learn and matplotlib: the improved
    repulsion demo takes its random-rows init (kmeans_init's branch without
    scikit-learn) and resets codes, a demo's main() refuses before any work,
    the C++ ingest builds and loads, and a trace and a file logger write.
    The quantizers' and augmentation's values are held against JAX in
    test_torch_demo_quantizers.py, test_torch_demos.py and
    test_torch_noise_injector.py."""
    out = _run("""
        import os
        import numpy as np
        import torch
        from vqvae_speech_tpu_torch import native
        from vqvae_speech_tpu_torch.examples import vq_balanced_2d
        from vqvae_speech_tpu_torch.examples.vq_2d_clustering import (
            generate_2d_clusters)
        from vqvae_speech_tpu_torch.examples.vq_2d_repulsion import (
            kmeans_init, train_repulsion_vq)
        from vqvae_speech_tpu_torch.utils.logger import create_file_logger
        from vqvae_speech_tpu_torch.utils.profiling import annotate, trace

        torch.set_num_threads(1)
        data, labels = generate_2d_clusters(n_points=200, n_clusters=5)
        rows = kmeans_init(data, 8)
        assert all(any((r == d).all() for d in data) for r in rows)
        _, a, _, resets = train_repulsion_vq(
            data, n_epochs=6, improved=True, reset_interval=3,
            reset_threshold=0.5, device="cpu")
        assert a.shape == (200,) and resets > 0
        try:
            vq_balanced_2d.main(["--device", "cpu", "--output", "x.png"])
            raise AssertionError("a figure without matplotlib")
        except ImportError as e:
            assert "matplotlib" in str(e)

        assert native.available()
        with trace("tr") as t:
            with annotate("x"):
                torch.ones(4).sum()
        assert os.path.isfile(t.path)
        create_file_logger("guard", "log").info("x")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "optax", "yaml", "vqvae_speech_tpu",
                      "sklearn", "matplotlib")
                     and sys.modules[m] is not None)
        print("demos", resets, bad)
    """, tmp_path)
    last = out.splitlines()[-1].split()
    assert last[0] == "demos" and last[-1] == "[]"
