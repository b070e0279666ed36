"""Convert the reference's PyTorch checkpoints to the JAX param trees.

Counterpart of ``vqvae_speech_tpu/train/convert_reference.py``. The
reference saves ``{name}_{epoch}_checkpoint.pth`` holding a
ConvolutionalVQVAE ``model`` state_dict (reference
convolutional_trainer.py:76-86). This maps that state_dict onto the JAX
package's ``(params, state)`` tree of numpy arrays, which
``convert.load_jax_params`` then loads into the port's ``ConvVQVAE`` (and
which the JAX package reads as it is):

  torch layout -> JAX tree
  Conv1d weight (Cout, Cin, K)          -> (K, Cin, Cout)
  ConvTranspose1d weight (Cin, Cout, K) -> (K, Cout, Cin)
  weight_norm pairs weight_g/weight_v   -> {'g', 'v'} (same re-layout)
  nn.Embedding weight                   -> codebook rows (unchanged)

State-dict key map (reference module tree, convolutional_vq_vae.py:39-99):
  _encoder._conv_{1..5}           -> encoder.conv_{1..5}
  _encoder._residual_stack._layers.0._block.{1,3}
                                  -> encoder.residual_stack.block.conv{1,2}
     (ALL stack layers share one instance: layer 0 carries the weights)
  _pre_vq_conv                    -> pre_vq_conv
  _vq._embedding.weight           -> vq.codebook (params) or state codebook
  _vq._ema_w / _vq._ema_cluster_size -> EMA state
  _decoder._conv_1, _decoder._residual_stack..., _decoder._conv_trans_{1..3}
                                  -> decoder.*
"""
import numpy as np
import torch


def _conv_from_torch(sd: dict, prefix: str) -> dict:
    """The JAX conv dict ``{w | v, g, [b]}`` of the state_dict entries at
    ``prefix``; both conv layouts are ``transpose(2, 1, 0)`` of torch's."""
    def to_jax(w):
        return np.asarray(w).transpose(2, 1, 0).astype(np.float32)

    out = {}
    if f"{prefix}.weight_v" in sd:
        out["v"] = to_jax(sd[f"{prefix}.weight_v"])
        out["g"] = np.asarray(sd[f"{prefix}.weight_g"]).reshape(-1).astype(
            np.float32)
    elif f"{prefix}.weight" in sd:
        out["w"] = to_jax(sd[f"{prefix}.weight"])
    else:
        raise KeyError(f"no conv weight at {prefix}")
    if sd.get(f"{prefix}.bias") is not None:
        out["b"] = np.asarray(sd[f"{prefix}.bias"]).astype(np.float32)
    return out


def _residual_stack(sd: dict, prefix: str) -> dict:
    # the reference Residual block is Sequential(ReLU, conv1, ReLU, conv2)
    # (residual.py:62-67): keys ._layers.0._block.1 and ._block.3
    return {"block": {
        "conv1": _conv_from_torch(sd, f"{prefix}._layers.0._block.1"),
        "conv2": _conv_from_torch(sd, f"{prefix}._layers.0._block.3"),
    }}


def convert_state_dict(sd: dict, ema: bool):
    """A reference state_dict (tensor- or numpy-valued) -> ``(params,
    state)`` in the JAX package's tree and layouts, numpy f32."""
    sd = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
          for k, v in sd.items()}
    params = {
        "encoder": {
            **{f"conv_{i}": _conv_from_torch(sd, f"_encoder._conv_{i}")
               for i in range(1, 6)},
            "residual_stack": _residual_stack(sd, "_encoder._residual_stack"),
        },
        "pre_vq_conv": _conv_from_torch(sd, "_pre_vq_conv"),
        "vq": {},
        "decoder": {
            "conv_1": _conv_from_torch(sd, "_decoder._conv_1"),
            "residual_stack": _residual_stack(sd, "_decoder._residual_stack"),
            **{f"conv_trans_{i}": _conv_from_torch(
                sd, f"_decoder._conv_trans_{i}") for i in range(1, 4)},
        },
    }
    codebook = sd["_vq._embedding.weight"].astype(np.float32)
    state = {"vq": {}}
    if ema:
        state["vq"] = {
            "codebook": codebook,
            "ema_cluster_size": sd["_vq._ema_cluster_size"].astype(np.float32),
            "ema_w": sd["_vq._ema_w"].astype(np.float32),
        }
    else:
        params["vq"]["codebook"] = codebook
    return params, state


def convert_reference_checkpoint(pth_path: str, configuration: dict):
    """Read a reference ``.pth`` (tensors only: ``weights_only=True``) and
    convert it. Returns ``(params, model_state, checkpoint_meta)``; the meta
    holds the checkpoint's ``experiment_name`` and ``epoch`` where present."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    params, state = convert_state_dict(sd, ema=configuration["decay"] > 0.0)
    meta = {k: ckpt[k] for k in ("experiment_name", "epoch") if k in ckpt}
    return params, state, meta
