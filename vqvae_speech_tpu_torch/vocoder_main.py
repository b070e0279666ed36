"""Vocoder CLI: LJSpeech preprocessing, teacher/student/flow training and
synthesis, on one device.

Counterpart of ``vqvae_speech_tpu/vocoder_main.py`` (the reference's five
standalone CLIs: src/clarinet/train.py, train_student.py, synthesize.py,
synthesize_student.py and the src/flow_wavenet twins), with the same
subcommands, flags and file names, plus ``--device`` (default ``cuda``;
``--device cpu`` when the caller asks for the CPU):

    python -m vqvae_speech_tpu_torch.vocoder_main preprocess --in_dir LJ --out_dir data
    python -m vqvae_speech_tpu_torch.vocoder_main train-teacher --data_root data
    python -m vqvae_speech_tpu_torch.vocoder_main synthesize-teacher \\
        --checkpoint vocoder_checkpoints/teacher_best.pkl --mel_path m.npy --out_wav t.wav

Fresh runs start from numpy-seeded trees with the JAX inits' distributions
(``convert.numpy_*``; JAX's PRNG cannot be reproduced). Synthesis draws its
noise from a generator seeded with ``--seed`` on the device. The teacher
synthesizes autoregressively, one decode-step kernel launch a sample on the
card (``gaussian_wavenet_generate``); the student and the flow run at batch
1 through the fused resblock chains (``use_fused``: the chain kernels on the
card, their plain twins on the CPU), as the fused servers do.
``--data_parallel`` trains data-parallel over one process a GPU under
``torchrun`` (read from the environment; each rank on ``cuda:LOCAL_RANK``,
every rank's loader yielding the same global batches, rank 0 alone writing),
and on the one device without it, as the JAX CLI does on one device:

    torchrun --nproc_per_node 4 -m vqvae_speech_tpu_torch.vocoder_main \
        train-teacher --data_root data --data_parallel
"""
import argparse
import os
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

HOP = 256


def build_parser():
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="command", required=True)

    pp = sub.add_parser("preprocess", help="LJSpeech -> audio/mel npy store")
    pp.add_argument("--in_dir", required=True)
    pp.add_argument("--out_dir", required=True)
    pp.add_argument("--limit", type=int, default=None)

    for name in ("train-teacher", "train-student", "train-flow"):
        tp = sub.add_parser(name)
        tp.add_argument("--data_root", required=True)
        tp.add_argument("--checkpoint_dir", default="vocoder_checkpoints")
        tp.add_argument("--model_name", default=name.replace("train-", ""))
        tp.add_argument("--batch_size", type=int, default=8)
        tp.add_argument("--epochs", type=int, default=1000)
        tp.add_argument("--learning_rate", type=float, default=1e-3)
        tp.add_argument("--seed", type=int, default=0)
        tp.add_argument("--resume", default=None,
                        help="checkpoint .pkl to resume from (restores "
                             "state, loss histories, best loss)")
        tp.add_argument("--bf16", action="store_true",
                        help="mixed precision: bf16 forward/backward, "
                             "f32 masters and losses")
        tp.add_argument("--data_parallel", action="store_true",
                        help="shard each batch over the ranks torchrun "
                             "starts (one a GPU)")
        tp.add_argument("--tiny", action="store_true",
                        help="tiny model preset (tests/smoke)")
        tp.add_argument("--device", default="cuda",
                        help="where to train: cuda, or cpu when asked")
        if name == "train-student":
            tp.add_argument("--teacher_checkpoint", required=True)
            tp.add_argument("--KL_type", default="qp", choices=["qp", "pq"])

    for name in ("synthesize-teacher", "synthesize-student",
                 "synthesize-flow"):
        sp = sub.add_parser(name)
        sp.add_argument("--checkpoint", required=True)
        sp.add_argument("--mel_path", required=True)
        sp.add_argument("--out_wav", required=True)
        sp.add_argument("--temp", type=float, default=0.8)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--tiny", action="store_true",
                        help="tiny model preset (tests/smoke)")
        sp.add_argument("--device", default="cuda",
                        help="where to synthesize: cuda, or cpu when asked")
        if name == "synthesize-student":
            sp.add_argument("--teacher_checkpoint", required=True)
    return p


def _write_wav(path, audio, sr=22050):
    from scipy.io import wavfile

    wavfile.write(path, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))


def teacher_cfg_for(args):
    from vqvae_speech_tpu_torch.models.clarinet import GaussianWaveNetConfig

    if getattr(args, "tiny", False):
        return GaussianWaveNetConfig(
            num_blocks=1, num_layers=2, front_channels=4,
            residual_channels=8, gate_channels=8, skip_channels=8,
            kernel_size=2, cin_channels=80, upsample_scales=(16, 16))
    return GaussianWaveNetConfig()


def student_cfg_for(args):
    from vqvae_speech_tpu_torch.models.clarinet import StudentConfig

    if getattr(args, "tiny", False):
        return StudentConfig(num_blocks_student=(1, 1), num_layers=2,
                             front_channels=4, residual_channels=8,
                             gate_channels=8, skip_channels=8,
                             kernel_size=3, cin_channels=80)
    return StudentConfig()


def flow_cfg_for(args):
    from vqvae_speech_tpu_torch.models.flowavenet import FlowavenetConfig

    if getattr(args, "tiny", False):
        return FlowavenetConfig(in_channel=1, cin_channel=80, n_block=2,
                                n_flow=1, n_layer=1, filter_size=8,
                                block_per_split=8, upsample_scales=(16, 16))
    return FlowavenetConfig()


def _noise(shape, temp, seed, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return temp * torch.randn(shape, generator=gen, device=device)


def _train(args, device):
    import torch
    import torch.distributed as dist

    from vqvae_speech_tpu_torch import convert
    from vqvae_speech_tpu_torch.data.ljspeech import (
        LJSpeechDataset,
        LJSpeechLoader,
    )
    from vqvae_speech_tpu_torch.parallel.mesh import make_mesh
    from vqvae_speech_tpu_torch.train import vocoder

    mesh = None
    if (args.data_parallel and dist.is_initialized()
            and dist.get_world_size() > 1):
        mesh = make_mesh(device=device)
    ds = LJSpeechDataset(args.data_root, train=True)
    loader = LJSpeechLoader(ds, args.batch_size, seed=args.seed)
    # the reference gates 'best' on the TEST loss (clarinet train.py:273-283)
    test_ds = LJSpeechDataset(args.data_root, train=False)
    eval_loader = (LJSpeechLoader(test_ds, args.batch_size, seed=args.seed)
                   if len(test_ds) >= args.batch_size else None)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    on_best, eval_on_ema = None, True

    if args.command == "train-teacher":
        cfg = teacher_cfg_for(args)
        params = convert.numpy_gaussian_wavenet_params(cfg, args.seed)
        opt = vocoder.make_vocoder_optimizer(args.learning_rate,
                                             clip_norm=10.0)
        step = vocoder.make_teacher_train_step(cfg, opt, mesh=mesh,
                                               compute_dtype=compute_dtype)
        eval_loss = vocoder.make_teacher_eval_loss(cfg)
    elif args.command == "train-student":
        t_params = vocoder.load_vocoder_checkpoint(
            args.teacher_checkpoint)["ema_params"]
        teacher_cfg, cfg = teacher_cfg_for(args), student_cfg_for(args)
        params = convert.numpy_student_init(cfg, args.seed)
        opt = vocoder.make_vocoder_optimizer(args.learning_rate,
                                             clip_norm=10.0)
        step = vocoder.make_student_train_step(
            teacher_cfg, cfg, t_params, opt, kl_type=args.KL_type,
            mesh=mesh, compute_dtype=compute_dtype, device=device)
        eval_loss = vocoder.make_student_eval_loss(
            teacher_cfg, cfg, t_params, kl_type=args.KL_type, device=device)
    else:
        from vqvae_speech_tpu_torch.models.flowavenet import (
            actnorm_initialize,
            flowavenet_reverse,
        )

        cfg = flow_cfg_for(args)
        # the data-dependent init on the first GLOBAL batch (every rank's
        # loader yields it); the trainer broadcasts rank 0's result
        first = next(iter(loader))
        params = actnorm_initialize(
            convert.tensor_tree(convert.numpy_flowavenet_init(cfg, args.seed),
                                device), cfg,
            torch.from_numpy(first["x"]).to(device),
            torch.from_numpy(first["c"]).to(device))
        opt = vocoder.make_vocoder_optimizer(args.learning_rate,
                                             clip_norm=1.0,
                                             halve_every=200_000)
        step = vocoder.make_flow_train_step(cfg, opt, mesh=mesh,
                                            compute_dtype=compute_dtype)
        eval_loss, eval_on_ema = vocoder.make_flow_eval_loss(cfg), False

        def on_best(state, epoch):
            # reference flow train.py:290-295: write a sample whenever a new
            # best checkpoint is saved; batch 1 through the fused chains
            if eval_loader is None:
                return
            mel = torch.from_numpy(next(iter(eval_loader))["c"][:1]).to(
                device)
            flow = convert.load_flowavenet_params(
                convert.numpy_tree(state.params), cfg, device,
                prepare_chains=True)
            z = _noise((1, mel.shape[1] * HOP, 1), 0.8, epoch, device)
            wave = flowavenet_reverse(flow, cfg, z, mel, use_fused=True)
            _write_wav(os.path.join(
                args.checkpoint_dir,
                f"generate_{args.model_name}_{epoch}.wav"),
                wave[0, :, 0].cpu().numpy())

    state = vocoder.create_vocoder_state(params, opt, device=device,
                                         seed=args.seed)
    trainer = vocoder.VocoderTrainer(
        step, state, loader, args.checkpoint_dir, args.model_name,
        eval_loader=eval_loader, eval_loss_fn=eval_loss,
        eval_on_ema=eval_on_ema, on_best=on_best, mesh=mesh)
    start = (vocoder.restore_vocoder_trainer(trainer, args.resume)
             if args.resume else 0)
    for epoch in range(start, args.epochs):
        trainer.train_epoch(epoch)
    return 0


def _synthesize(args, device):
    import torch

    from vqvae_speech_tpu_torch import convert
    from vqvae_speech_tpu_torch.train.vocoder import load_vocoder_checkpoint

    mel = torch.from_numpy(np.load(args.mel_path)[None].astype(np.float32)
                           ).to(device)                     # (1, T, 80)
    T = mel.shape[1] * HOP
    ckpt = load_vocoder_checkpoint(args.checkpoint)

    if args.command == "synthesize-teacher":
        from vqvae_speech_tpu_torch.models.clarinet import (
            gaussian_wavenet_generate,
        )

        cfg = teacher_cfg_for(args)
        params = convert.load_gaussian_wavenet_params(ckpt["ema_params"],
                                                      cfg, device)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        audio = gaussian_wavenet_generate(params, cfg, T, mel, generator=gen)
        _write_wav(args.out_wav, audio[0].cpu().numpy())
        return 0

    if args.command == "synthesize-student":
        from vqvae_speech_tpu_torch.models.clarinet import (
            wavenet_student_generate,
        )
        from vqvae_speech_tpu_torch.models.clarinet.modules import (
            upsample_apply,
        )

        teacher_cfg, cfg = teacher_cfg_for(args), student_cfg_for(args)
        # the student runs on the teacher's upsampled conditioning
        upsample = convert.load_upsample_params(
            load_vocoder_checkpoint(args.teacher_checkpoint)["ema_params"]
            ["upsample_conv"], device)
        with torch.no_grad():
            c_up = upsample_apply(upsample, mel, teacher_cfg.upsample_scales)
            params = convert.load_student_params(
                ckpt["ema_params"], cfg, device, prepare_chains=True)
            z = _noise((1, c_up.shape[1], 1), args.temp, args.seed, device)
            audio = wavenet_student_generate(params, cfg, z, c_up,
                                             use_fused=True)
        _write_wav(args.out_wav, audio[0, :, 0].cpu().numpy())
        return 0

    from vqvae_speech_tpu_torch.models.flowavenet import flowavenet_reverse

    cfg = flow_cfg_for(args)
    with torch.no_grad():
        params = convert.load_flowavenet_params(ckpt["params"], cfg, device,
                                                prepare_chains=True)
        z = _noise((1, T, 1), args.temp, args.seed, device)
        audio = flowavenet_reverse(params, cfg, z, mel, use_fused=True)
    _write_wav(args.out_wav, audio[0, :, 0].cpu().numpy())
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "preprocess":
        from vqvae_speech_tpu_torch.data.ljspeech import preprocess

        preprocess(args.in_dir, args.out_dir, args.limit)
        return 0

    import torch

    from vqvae_speech_tpu_torch.parallel.mesh import (
        initialize_from_environment,
        is_writer,
        shutdown,
    )
    from vqvae_speech_tpu_torch.utils import resolve_device
    from vqvae_speech_tpu_torch.utils.logger import ConsoleLogger

    device = resolve_device(args.device)
    if device.type == "cuda":
        # the models are f32 (or bf16 with --bf16): PyTorch's default would
        # let cuDNN run f32 convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if not args.command.startswith("train-"):
        return _synthesize(args, device)
    device = initialize_from_environment(device=device)
    ConsoleLogger.enabled = is_writer()
    try:
        return _train(args, device)
    finally:
        shutdown()


if __name__ == "__main__":
    sys.exit(main())
