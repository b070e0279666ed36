"""Input-type predicates and the hparams-dict model factory.

Counterpart of ``vqvae_speech_tpu/models/wavenet/util.py`` (reference
src/wavenet_vocoder/util.py:31-51 and the reference's model factory). JAX's
PRNG cannot be reproduced here, so the factory takes a numpy seed and
returns the numpy tree of ``convert.numpy_wavenet_params``, which
``convert.load_wavenet_params`` loads into a ``WaveNet``.
"""
from vqvae_speech_tpu_torch.models.wavenet.model import WaveNetConfig


def is_mulaw_quantize(input_type: str) -> bool:
    return input_type == "mulaw-quantize"


def is_mulaw(input_type: str) -> bool:
    return input_type == "mulaw"


def is_raw(input_type: str) -> bool:
    return input_type == "raw"


def is_scalar_input(input_type: str) -> bool:
    return is_raw(input_type) or is_mulaw(input_type)


def wavenet_config_from_hparams(hparams: dict) -> WaveNetConfig:
    """The factory's WaveNetConfig: scalar_input derives from ``input_type``;
    the categorical mode has 256 output bins, the scalar one 10 mixtures x 3
    channels."""
    input_type = hparams.get("input_type", "mulaw-quantize")
    scalar_input = is_scalar_input(input_type)
    return WaveNetConfig(
        out_channels=hparams.get("out_channels",
                                 256 if not scalar_input else 10 * 3),
        layers=hparams.get("layers", 20),
        stacks=hparams.get("stacks", 2),
        residual_channels=hparams.get("residual_channels", 512),
        gate_channels=hparams.get("gate_channels", 512),
        skip_out_channels=hparams.get("skip_out_channels", 512),
        kernel_size=hparams.get("kernel_size", 3),
        dropout=hparams.get("dropout", 1 - 0.95),
        cin_channels=hparams.get("cin_channels", -1),
        gin_channels=hparams.get("gin_channels", -1),
        n_speakers=hparams.get("n_speakers"),
        upsample_conditional_features=hparams.get(
            "upsample_conditional_features", False),
        upsample_scales=tuple(hparams.get("upsample_scales") or ()) or None,
        freq_axis_kernel_size=hparams.get("freq_axis_kernel_size", 3),
        scalar_input=scalar_input,
        use_speaker_embedding=hparams.get("use_speaker_embedding", True),
        legacy=hparams.get("legacy", True),
    )


def build_wavenet_from_hparams(hparams: dict, *, seed: int):
    """hparams dict -> (numpy params, WaveNetConfig), the params made with
    ``np.random.default_rng(seed)`` in ``wavenet_init``'s structure."""
    from vqvae_speech_tpu_torch.convert import numpy_wavenet_params

    cfg = wavenet_config_from_hparams(hparams)
    return numpy_wavenet_params(cfg, seed), cfg
