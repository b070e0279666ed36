"""Encode a wav file to VQ code indices with a trained checkpoint.

Counterpart of the repository's ``examples/encode_wav.py``:

    python -m vqvae_speech_tpu_torch.examples.encode_wav --wav path.wav \
        --experiments_path experiments --experiment_name baseline \
        [--normalizer_path data/vctk/vctk-mfcc-stats.pickle] \
        [--out codes.npy] [--device cuda]

Prints the code sequence (one latent code per 20 ms) and optionally saves
it. The checkpoint may come from either package's trainer. On the card the
codebook search is the hand-written kernel.
"""
import argparse

import numpy as np
import torch

from vqvae_speech_tpu_torch.data.audio import (
    load_and_preprocess,
    pad_or_random_crop,
)
from vqvae_speech_tpu_torch.ops.dsp import speech_features
from vqvae_speech_tpu_torch.utils.device import resolve_device


def encode_wav(wav_path, configuration, model, normalizer=None):
    """wav file -> (codes (T_lat,), features (T, C)) through ``model``, a
    ConvVQVAE in eval mode on the device it is to run on."""
    cfg = configuration
    device = next(model.parameters()).device
    audio, _ = load_and_preprocess(wav_path, cfg["sampling_rate"],
                                   cfg["top_db"])
    audio, _ = pad_or_random_crop(audio, cfg["length"] + 1,
                                  np.random.default_rng(0))
    with torch.no_grad():
        feats = speech_features(
            cfg["input_features_type"],
            torch.from_numpy(audio[None]).to(device), cfg["sampling_rate"],
            cfg["input_features_filters"], True).cpu().numpy()
        if normalizer is not None:
            feats = ((feats - normalizer["train_mean"])
                     / normalizer["train_std"]).astype(np.float32)
        out = model.encode(torch.from_numpy(feats).to(device))
    codes = out.indices.reshape(1, -1)[0].cpu().numpy()
    return codes, feats[0]


def load_model(configuration, checkpoint, device):
    """The checkpoint's ConvVQVAE on ``device``, in eval mode."""
    from vqvae_speech_tpu_torch.convert import load_jax_params
    from vqvae_speech_tpu_torch.models import ConvVQVAE

    model = load_jax_params(ConvVQVAE.from_config(configuration),
                            checkpoint["params"], checkpoint["model_state"])
    return model.to(resolve_device(device)).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--wav", required=True)
    p.add_argument("--experiments_path", default="experiments")
    p.add_argument("--experiment_name", default="baseline")
    p.add_argument("--normalizer_path", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from vqvae_speech_tpu_torch.data import load_normalizer
    from vqvae_speech_tpu_torch.train.checkpoint import (
        latest_checkpoint_epoch,
        load_checkpoint,
    )
    from vqvae_speech_tpu_torch.train.config import (
        frozen_configuration_path,
        load_configuration,
    )

    cfg = load_configuration(frozen_configuration_path(
        args.experiments_path, args.experiment_name))
    epoch, ckpt_path = latest_checkpoint_epoch(args.experiments_path,
                                               args.experiment_name)
    if ckpt_path is None:
        raise SystemExit(f"no checkpoint for '{args.experiment_name}' "
                         f"under '{args.experiments_path}'")
    model = load_model(cfg, load_checkpoint(ckpt_path), args.device)
    normalizer = None
    norm_path = args.normalizer_path or (
        cfg["normalizer_path"] if cfg.get("normalize") else None)
    if norm_path:
        normalizer = load_normalizer(norm_path)

    codes, _ = encode_wav(args.wav, cfg, model, normalizer)
    print(f"epoch {epoch} checkpoint; {len(codes)} codes "
          f"(one per {2 * 10} ms):")
    print(" ".join(str(int(c)) for c in codes))
    if args.out:
        np.save(args.out, codes)
        print(f"saved -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
