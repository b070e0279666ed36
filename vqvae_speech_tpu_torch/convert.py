"""Carry JAX param trees (as numpy arrays) into the port's modules.

JAX stores conv kernels as (K, Cin, Cout) and transposed-conv kernels as
(K, Cout, Cin); PyTorch wants (Cout, Cin, K) and (Cin, Cout, K). Both are
``transpose(2, 1, 0)``. A weight-norm pair ``{v, g}`` keeps its form (``v``
transposed the same way, ``g`` as is): the module resolves it on forward.
The codebook comes from ``params["vq"]`` (gradient variant) or, with the EMA
statistics, from ``state["vq"]`` (EMA variant).

``numpy_params``, ``numpy_wavenet_params`` and
``numpy_wavenet_vqvae_params`` build random trees with the structure, shapes
and init distributions of ``conv_vqvae_init``, ``wavenet_init`` and
``wavenet_vqvae_init``, from numpy alone, for machines with no JAX.
"""
import math

import numpy as np
import torch

from vqvae_speech_tpu_torch.models.conv_vqvae import ConvVQVAE, feature_channels
from vqvae_speech_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.models.wavenet_decoder import wavenet_config_from
from vqvae_speech_tpu_torch.models.wavenet_vqvae import WaveNetVQVAE


def _copy(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: JAX {src.shape} vs torch "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def _load_conv(module, p: dict) -> None:
    """Conv1d and ConvTranspose1d alike: kernels are transpose(2, 1, 0)."""
    if module.use_weight_norm != ("v" in p):
        raise ValueError("weight-norm mismatch between config and params")
    if "v" in p:
        _copy(module.v, np.asarray(p["v"]).transpose(2, 1, 0))
        _copy(module.g, p["g"])
    else:
        _copy(module.weight, np.asarray(p["w"]).transpose(2, 1, 0))
    if (module.bias is None) != ("b" not in p):
        raise ValueError("bias mismatch between module and params")
    if "b" in p:
        _copy(module.bias, p["b"])


def _load_stack(stack, p: dict) -> None:
    _load_conv(stack.block.conv1, p["block"]["conv1"])
    _load_conv(stack.block.conv2, p["block"]["conv2"])


def _load_encoder(encoder, enc: dict) -> None:
    for name in ("conv_1", "conv_2", "conv_3", "conv_4", "conv_5"):
        _load_conv(getattr(encoder, name), enc[name])
    _load_stack(encoder.residual_stack, enc["residual_stack"])


def _load_vq(vq, params: dict, state: dict) -> None:
    if vq.ema:
        vq_state = state["vq"]
        _copy(vq.codebook, vq_state["codebook"])
        _copy(vq.ema_cluster_size, vq_state["ema_cluster_size"])
        _copy(vq.ema_w, vq_state["ema_w"])
    else:
        _copy(vq.codebook, params["vq"]["codebook"])


def load_jax_params(model: ConvVQVAE, params: dict, state: dict) -> ConvVQVAE:
    """Copy a ``conv_vqvae_init``-shaped (params, state) tree into ``model``
    in place and return it."""
    _load_encoder(model.encoder, params["encoder"])
    _load_conv(model.pre_vq_conv, params["pre_vq_conv"])
    dec = params["decoder"]
    if "speaker_embedding" in dec:
        raise NotImplementedError("speaker conditioning is not ported yet")
    for name in ("conv_1", "conv_trans_1", "conv_trans_2", "conv_trans_3"):
        _load_conv(getattr(model.decoder, name), dec[name])
    _load_stack(model.decoder.residual_stack, dec["residual_stack"])
    _load_vq(model.vq, params, state)
    return model


def load_wavenet_params(module: WaveNet, tree: dict) -> WaveNet:
    """Copy a ``wavenet_init``-shaped tree into ``module`` in place and
    return it. Upsample kernels go from JAX's (kh, s, 1, 1) to the
    ConvTranspose2d layout (1, 1, kh, s)."""
    _load_conv(module.first_conv, tree["first_conv"])
    if len(tree["conv_layers"]) != len(module.conv_layers):
        raise ValueError("layer count mismatch between config and params")
    for layer, p in zip(module.conv_layers, tree["conv_layers"]):
        for name in ("conv", "conv1x1c", "conv1x1g", "conv1x1_skip",
                     "conv1x1_out"):
            conv = getattr(layer, name)
            if (conv is None) != (name not in p):
                raise ValueError(f"{name} mismatch between config and params")
            if conv is not None:
                _load_conv(conv, p[name])
    _load_conv(module.last_conv_1, tree["last_conv_1"])
    _load_conv(module.last_conv_2, tree["last_conv_2"])
    if (module.embed_speakers is None) != ("embed_speakers" not in tree):
        raise ValueError("speaker-embedding mismatch between config and params")
    if module.embed_speakers is not None:
        _copy(module.embed_speakers, tree["embed_speakers"]["table"])
    if (module.upsample_conv is None) != ("upsample_conv" not in tree):
        raise ValueError("upsample mismatch between config and params")
    for stage, p in zip(module.upsample_conv or (),
                        tree.get("upsample_conv", ())):
        _copy(stage.v, np.asarray(p["v"]).transpose(2, 3, 0, 1))
        _copy(stage.g, p["g"])
        _copy(stage.b, p["b"])
    return module


def load_wavenet_vqvae_params(model: WaveNetVQVAE, params: dict,
                              state: dict) -> WaveNetVQVAE:
    """Copy a ``wavenet_vqvae_init``-shaped (params, state) tree into
    ``model`` in place and return it."""
    _load_encoder(model.encoder, params["encoder"])
    _load_conv(model.pre_vq_conv, params["pre_vq_conv"])
    _load_vq(model.vq, params, state)
    _load_conv(model.decoder.conv_1, params["decoder"]["conv_1"])
    load_wavenet_params(model.decoder.wavenet, params["decoder"]["wavenet"])
    return model


# -------------------- random trees without JAX --------------------


def _uniform(rng, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _conv(rng, in_ch, out_ch, k, bias=True, wn=False):
    """nn/conv.py:conv1d_init: kernel (K, Cin, Cout)."""
    shape = (k, in_ch, out_ch)
    if wn:
        v = (rng.standard_normal(shape) * math.sqrt(2.0 / (in_ch * k))
             ).astype(np.float32)
        p = {"v": v, "g": np.sqrt(np.square(v).sum((0, 1))).astype(np.float32)}
    else:
        p = {"w": _uniform(rng, shape, in_ch * k)}
    if bias:
        p["b"] = _uniform(rng, (out_ch,), in_ch * k)
    return p


def _conv_t(rng, in_ch, out_ch, k, wn=False):
    """nn/conv.py:conv_transpose1d_init: kernel (K, Cout, Cin)."""
    shape = (k, out_ch, in_ch)
    if wn:
        v = (rng.standard_normal(shape) * math.sqrt(2.0 / (in_ch * k))
             ).astype(np.float32)
        p = {"v": v, "g": np.sqrt(np.square(v).sum((0, 1))).astype(np.float32)}
    else:
        p = {"w": _uniform(rng, shape, out_ch * k)}
    p["b"] = _uniform(rng, (out_ch,), out_ch * k)
    return p


def _stack(rng, in_ch, hid, res_hid, wn):
    return {"block": {"conv1": _conv(rng, in_ch, res_hid, 3, False, wn),
                      "conv2": _conv(rng, res_hid, hid, 1, False, wn)}}


def _vq_tree(rng, config: dict):
    """vector_quantizer_init's (params["vq"], state["vq"])."""
    K, D = config["num_embeddings"], config["embedding_dim"]
    if config["decay"] > 0.0:
        return {}, {
            "codebook": rng.standard_normal((K, D)).astype(np.float32),
            "ema_cluster_size": np.zeros((K,), np.float32),
            "ema_w": rng.standard_normal((K, D)).astype(np.float32),
        }
    return {"codebook": rng.uniform(-1.0 / K, 1.0 / K, (K, D))
            .astype(np.float32)}, {}


def numpy_params(config: dict, seed: int):
    """Random (params, state) with exactly ``conv_vqvae_init``'s tree
    structure and shapes, made with ``np.random.default_rng(seed)``."""
    if config["use_speaker_conditioning"]:
        raise NotImplementedError("speaker conditioning is not ported yet")
    rng = np.random.default_rng(seed)
    wn = config["use_kaiming_normal"]
    hid = config["num_hiddens"]
    K, D = config["num_embeddings"], config["embedding_dim"]
    fin = feature_channels(config, "input")
    params = {
        "encoder": {
            "conv_1": _conv(rng, fin, hid, 3, wn=wn),
            "conv_2": _conv(rng, hid, hid, 3, wn=wn),
            "conv_3": _conv(rng, hid, hid, 4, wn=wn),
            "conv_4": _conv(rng, hid, hid, 3, wn=wn),
            "conv_5": _conv(rng, hid, hid, 3, wn=wn),
            "residual_stack": _stack(rng, hid, hid, hid, wn),
        },
        "pre_vq_conv": _conv(rng, hid, D, 3),
        "vq": {},
        "decoder": {
            "conv_1": _conv(rng, D, hid, 3, wn=wn),
            "residual_stack": _stack(rng, hid, hid,
                                     config["residual_channels"], wn),
            "conv_trans_1": _conv_t(rng, hid, hid, 3, wn),
            "conv_trans_2": _conv_t(rng, hid, hid, 3, wn),
            "conv_trans_3": _conv_t(rng, hid, feature_channels(config, "output"),
                                    2, wn),
        },
    }
    params["vq"], vq_state = _vq_tree(rng, config)
    state = {"vq": vq_state}
    if config.get("codebook_revival", False):
        state["revival"] = {"usage": np.full((K,), 1.0 / K, np.float32)}
    return params, state


def _wn_conv(rng, in_ch, out_ch, k, dropout=0.0, std_mul=1.0):
    """models/wavenet/model.py:_conv_init: v ~ N(0, std) with
    std = sqrt(std_mul * (1 - dropout) / (k * in_ch)), g = ||v|| over
    (K, Cin), zero bias."""
    std = math.sqrt(std_mul * (1.0 - dropout) / (k * in_ch))
    v = (std * rng.standard_normal((k, in_ch, out_ch))).astype(np.float32)
    return {"v": v, "g": np.sqrt(np.square(v).sum((0, 1))).astype(np.float32),
            "b": np.zeros((out_ch,), np.float32)}


def numpy_wavenet_params(cfg: WaveNetConfig, seed: int) -> dict:
    """A random tree with exactly ``wavenet_init``'s structure, shapes and
    init distributions, made with ``np.random.default_rng(seed)``."""
    return _wavenet_tree(np.random.default_rng(seed), cfg)


def _wavenet_tree(rng, cfg: WaveNetConfig) -> dict:
    gate_out = cfg.gate_channels // 2
    in_ch = 1 if cfg.scalar_input else cfg.out_channels
    layers = []
    for _ in range(cfg.layers):
        p = {"conv": _wn_conv(rng, cfg.residual_channels, cfg.gate_channels,
                              cfg.kernel_size, dropout=cfg.dropout),
             "conv1x1_out": _wn_conv(rng, gate_out, cfg.residual_channels, 1),
             "conv1x1_skip": _wn_conv(rng, gate_out, cfg.skip_out_channels, 1)}
        if cfg.cin_channels > 0:
            p["conv1x1c"] = _wn_conv(rng, cfg.cin_channels, cfg.gate_channels, 1)
        if cfg.gin_channels > 0:
            p["conv1x1g"] = _wn_conv(rng, cfg.gin_channels, cfg.gate_channels, 1)
        layers.append(p)
    tree = {
        "first_conv": _wn_conv(rng, in_ch, cfg.residual_channels, 1),
        "conv_layers": layers,
        "last_conv_1": _wn_conv(rng, cfg.skip_out_channels,
                                cfg.skip_out_channels, 1),
        "last_conv_2": _wn_conv(rng, cfg.skip_out_channels, cfg.out_channels, 1),
    }
    if cfg.gin_channels > 0 and cfg.use_speaker_embedding:
        tree["embed_speakers"] = {"table": (0.1 * rng.standard_normal(
            (cfg.n_speakers, cfg.gin_channels))).astype(np.float32)}
    if cfg.upsample_conditional_features:
        kh = cfg.freq_axis_kernel_size
        tree["upsample_conv"] = []
        for s in cfg.upsample_scales:
            # the reference's averaging fill (PARITY #36, model.py:124-144)
            v = np.full((kh, s, 1, 1), 1.0 / kh, np.float32)
            tree["upsample_conv"].append({
                "v": v, "g": np.sqrt(np.square(v).sum()).reshape(1),
                "b": np.zeros((1,), np.float32)})
    return tree


def numpy_wavenet_vqvae_params(config: dict, num_speakers: int, seed: int):
    """Random (params, state, wavenet_cfg) with exactly
    ``wavenet_vqvae_init``'s tree structure and shapes, made with
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    wn = config["use_kaiming_normal"]
    hid = config["num_hiddens"]
    res_hid = config["residual_channels"]
    fin = feature_channels(config, "input")
    cfg = wavenet_config_from(config, num_speakers)
    vq_params, vq_state = _vq_tree(rng, config)
    params = {
        "encoder": {
            "conv_1": _conv(rng, fin, hid, 3, wn=wn),
            "conv_2": _conv(rng, hid, hid, 3, wn=wn),
            "conv_3": _conv(rng, hid, hid, 4, wn=wn),
            "conv_4": _conv(rng, hid, hid, 3, wn=wn),
            "conv_5": _conv(rng, hid, hid, 3, wn=wn),
            "residual_stack": _stack(rng, hid, hid, res_hid, wn),
        },
        "pre_vq_conv": _conv(rng, hid, config["embedding_dim"], 1),
        "vq": vq_params,
        "decoder": {
            "conv_1": _conv(rng, config["embedding_dim"],
                            config["local_condition_dim"], 2, wn=wn),
            "wavenet": _wavenet_tree(rng, cfg),
        },
    }
    state = {"vq": vq_state}
    if config.get("codebook_revival", False):
        K = config["num_embeddings"]
        state["revival"] = {"usage": np.full((K,), 1.0 / K, np.float32)}
    return params, state, cfg
