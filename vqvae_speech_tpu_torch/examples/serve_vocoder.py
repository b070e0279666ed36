"""Serve mel -> waveform synthesis with a trained vocoder checkpoint.

Counterpart of the repository's ``examples/serve_vocoder.py``: the one-pass
serving tier (serve.BucketedParallelSynthesisServer) buckets mixed-length mel
inputs into static shapes, batches them, and synthesizes each batch in a
single feed-forward pass.

    # FloWaveNet
    python -m vqvae_speech_tpu_torch.examples.serve_vocoder --kind flowavenet \
        --checkpoint vocoder_checkpoints/flow_best.pkl \
        --mels a.npy b.npy c.npy --out_dir synth/ [--bf16] [--tiny]

    # ClariNet IAF student (needs the teacher for mel upsampling)
    python -m vqvae_speech_tpu_torch.examples.serve_vocoder \
        --kind iaf_student \
        --checkpoint vocoder_checkpoints/student_best.pkl \
        --teacher_checkpoint vocoder_checkpoints/teacher_best.pkl \
        --mels a.npy b.npy --out_dir synth/ [--device cuda]

Checkpoints of either package's vocoder trainer load. As in the JAX example
the server runs at max_batch 8 without the fused chain.
"""
import argparse
import os

import numpy as np
import torch


def build_server(args):
    from vqvae_speech_tpu_torch.serve import BucketedParallelSynthesisServer
    from vqvae_speech_tpu_torch.train.vocoder import load_vocoder_checkpoint

    compute_dtype = torch.bfloat16 if args.bf16 else None
    ckpt = load_vocoder_checkpoint(args.checkpoint)

    if args.kind == "flowavenet":
        from vqvae_speech_tpu_torch.models.flowavenet import FlowavenetConfig
        cfg = (FlowavenetConfig(in_channel=1, cin_channel=80, n_block=2,
                                n_flow=1, n_layer=1, filter_size=8,
                                block_per_split=8, upsample_scales=(16, 16))
               if args.tiny else FlowavenetConfig())
        return BucketedParallelSynthesisServer(
            "flowavenet", ckpt["params"], cfg,
            frame_buckets=tuple(args.buckets), max_batch=args.max_batch,
            temp=args.temp, compute_dtype=compute_dtype, device=args.device)

    from vqvae_speech_tpu_torch.models.clarinet import (
        GaussianWaveNetConfig,
        StudentConfig,
    )
    t_ckpt = load_vocoder_checkpoint(args.teacher_checkpoint)
    if args.tiny:
        t_cfg = GaussianWaveNetConfig(
            num_blocks=1, num_layers=2, front_channels=4,
            residual_channels=8, gate_channels=8, skip_channels=8,
            kernel_size=2, cin_channels=80, upsample_scales=(16, 16))
        s_cfg = StudentConfig(num_blocks_student=(1, 1), num_layers=2,
                              front_channels=4, residual_channels=8,
                              gate_channels=8, skip_channels=8,
                              kernel_size=3, cin_channels=80)
    else:
        t_cfg, s_cfg = GaussianWaveNetConfig(), StudentConfig()
    return BucketedParallelSynthesisServer(
        "iaf_student", ckpt["ema_params"], s_cfg,
        teacher_params=t_ckpt["ema_params"], teacher_cfg=t_cfg,
        frame_buckets=tuple(args.buckets), max_batch=args.max_batch,
        temp=args.temp, compute_dtype=compute_dtype, device=args.device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=["flowavenet", "iaf_student"],
                    required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--teacher_checkpoint")
    ap.add_argument("--mels", nargs="+", required=True,
                    help=".npy files of (frames, 80) mels")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--buckets", nargs="+", type=int, default=[32, 64, 128])
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny test-scale model configs")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from scipy.io import wavfile

    server = build_server(args)
    conds = [np.load(p).astype(np.float32) for p in args.mels]
    results = server.synthesize(conds, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for p, r in zip(args.mels, results):
        out = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(p))[0] + ".wav")
        wavfile.write(out, 22050,
                      (np.clip(r.wave, -1, 1) * 32767).astype(np.int16))
        print(f"{out}: {len(r.wave)} samples (bucket {r.bucket})")
    print("launches:", server.stats["launches"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
