"""PyTorch port: importing a reference ``.pth`` checkpoint.

The torch twin of tests/test_convert_reference.py: a torch model whose
state_dict has the reference's module paths is saved as a ``.pth``, read by
the port's ``train.convert_reference`` and loaded into the port's
``ConvVQVAE``. Its tree equals the JAX package's conversion of the same
state_dict leaf for leaf, and its codes equal both the JAX conversion's
codes (``conv_vqvae_encode``) and the reference model's own argmin, with the
gradient and with the EMA quantizer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_convert_reference import CFG, RefNamedModel
from vqvae_speech_tpu.models import conv_vqvae_encode
from vqvae_speech_tpu.train.convert_reference import (
    convert_state_dict as jax_convert_state_dict,
)
from vqvae_speech_tpu_torch.convert import export_jax_params, load_jax_params
from vqvae_speech_tpu_torch.models import ConvVQVAE
from vqvae_speech_tpu_torch.train.convert_reference import (
    convert_reference_checkpoint,
    convert_state_dict,
)


def reference_state_dict(seed: int, ema: bool) -> dict:
    torch.manual_seed(seed)
    sd = dict(RefNamedModel(CFG).state_dict())
    if ema:
        rng = np.random.default_rng(seed)
        sd["_vq._ema_cluster_size"] = torch.from_numpy(
            rng.uniform(0.5, 3.0, CFG["num_embeddings"]).astype(np.float32))
        sd["_vq._ema_w"] = torch.from_numpy(rng.standard_normal(
            (CFG["num_embeddings"], CFG["embedding_dim"])).astype(np.float32))
    return sd


@pytest.mark.parametrize("ema", [False, True])
def test_pth_import_equals_jax_conversion_and_its_codes(tmp_path, ema):
    cfg = dict(CFG, decay=0.99 if ema else 0.0)
    sd = reference_state_dict(3 + ema, ema)
    path = str(tmp_path / "jitter12_7_checkpoint.pth")
    torch.save({"model": sd, "experiment_name": "jitter12", "epoch": 7}, path)

    params, state, meta = convert_reference_checkpoint(path, cfg)
    assert meta == {"experiment_name": "jitter12", "epoch": 7}
    jparams, jstate = jax_convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, ema=ema)
    got = jax.tree_util.tree_flatten_with_path((params, state))[0]
    want = jax.tree_util.tree_flatten_with_path((jparams, jstate))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path_, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=str(path_))
    assert ("codebook" in params["vq"]) == (not ema)

    model = load_jax_params(ConvVQVAE.from_config(cfg), params, state).eval()
    x = np.random.default_rng(0).standard_normal((3, 47, 39)).astype(
        np.float32)
    with torch.no_grad():
        codes = model.encode(torch.from_numpy(x)).indices[:, 0].numpy()
    jout = conv_vqvae_encode(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(x), cfg,
        training=False, use_pallas=False)
    np.testing.assert_array_equal(codes, np.asarray(jout.indices)[:, 0])
    # the reference model's own search (its embedding: the EMA codebook is
    # the embedding weight in the reference too)
    with torch.no_grad():
        ref = RefNamedModel(CFG).eval()
        ref.load_state_dict({k: v for k, v in sd.items()
                             if not k.startswith("_vq._ema")})
        _, ref_idx = ref(torch.from_numpy(x), CFG)
    np.testing.assert_array_equal(codes, ref_idx.numpy())
    # and the port writes back the tree it was given
    back_params, back_state = export_jax_params(model)
    np.testing.assert_array_equal(back_state["vq"].get("codebook", 0),
                                  state["vq"].get("codebook", 0))
    np.testing.assert_array_equal(
        back_params["encoder"]["conv_3"]["w"],
        params["encoder"]["conv_3"]["w"])


def test_weight_norm_pairs_and_missing_weights():
    """weight_g/weight_v pairs become {g, v} in the JAX layout; a prefix
    with neither form raises."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((6, 4, 3)).astype(np.float32)
    sd = {"_pre_vq_conv.weight_v": v,
          "_pre_vq_conv.weight_g": np.ones((6, 1, 1), np.float32),
          "_pre_vq_conv.bias": np.zeros(6, np.float32)}
    from vqvae_speech_tpu_torch.train.convert_reference import _conv_from_torch
    got = _conv_from_torch(sd, "_pre_vq_conv")
    np.testing.assert_array_equal(got["v"], v.transpose(2, 1, 0))
    assert got["g"].shape == (6,) and got["b"].shape == (6,)
    with pytest.raises(KeyError, match="no conv weight"):
        _conv_from_torch(sd, "_encoder._conv_1")
