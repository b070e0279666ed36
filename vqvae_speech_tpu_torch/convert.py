"""Carry JAX ConvVQVAE param trees (as numpy arrays) into the port's modules.

JAX stores conv kernels as (K, Cin, Cout) and transposed-conv kernels as
(K, Cout, Cin); PyTorch wants (Cout, Cin, K) and (Cin, Cout, K). Both are
``transpose(2, 1, 0)``. A weight-norm pair ``{v, g}`` keeps its form (``v``
transposed the same way, ``g`` as is): the module resolves it on forward.
The codebook comes from ``params["vq"]`` (gradient variant) or, with the EMA
statistics, from ``state["vq"]`` (EMA variant).

``numpy_params`` builds a random tree with the structure, shapes and init
distributions of ``conv_vqvae_init``, from numpy alone, for machines with
no JAX.
"""
import math

import numpy as np
import torch

from vqvae_speech_tpu_torch.models.conv_vqvae import ConvVQVAE, feature_channels


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


def load_jax_params(model: ConvVQVAE, params: dict, state: dict) -> ConvVQVAE:
    """Copy a ``conv_vqvae_init``-shaped (params, state) tree into ``model``
    in place and return it."""
    enc = params["encoder"]
    for name in ("conv_1", "conv_2", "conv_3", "conv_4", "conv_5"):
        _load_conv(getattr(model.encoder, name), enc[name])
    _load_stack(model.encoder.residual_stack, enc["residual_stack"])
    _load_conv(model.pre_vq_conv, params["pre_vq_conv"])
    dec = params["decoder"]
    if "speaker_embedding" in dec:
        raise NotImplementedError("speaker conditioning is not ported yet")
    for name in ("conv_1", "conv_trans_1", "conv_trans_2", "conv_trans_3"):
        _load_conv(getattr(model.decoder, name), dec[name])
    _load_stack(model.decoder.residual_stack, dec["residual_stack"])
    if model.vq.ema:
        vq_state = state["vq"]
        _copy(model.vq.codebook, vq_state["codebook"])
        _copy(model.vq.ema_cluster_size, vq_state["ema_cluster_size"])
        _copy(model.vq.ema_w, vq_state["ema_w"])
    else:
        _copy(model.vq.codebook, params["vq"]["codebook"])
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
    if config["decay"] > 0.0:
        vq_state = {
            "codebook": rng.standard_normal((K, D)).astype(np.float32),
            "ema_cluster_size": np.zeros((K,), np.float32),
            "ema_w": rng.standard_normal((K, D)).astype(np.float32),
        }
    else:
        params["vq"] = {"codebook": rng.uniform(-1.0 / K, 1.0 / K, (K, D))
                        .astype(np.float32)}
        vq_state = {}
    state = {"vq": vq_state}
    if config.get("codebook_revival", False):
        state["revival"] = {"usage": np.full((K,), 1.0 / K, np.float32)}
    return params, state
