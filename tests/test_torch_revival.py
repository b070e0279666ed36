"""PyTorch port: ``reset_dead_codes`` and ``apply_revival`` against the JAX
package's, on the JAX side's own permutation (``jax.random.permutation``
cannot be reproduced, so the port takes ``perm=``).

Tolerances: re-seeded rows are copies (exact); the usage EMA within rtol 1e-6.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vqvae_speech_tpu.models.vq_repulsion import reset_dead_codes as jax_reset
from vqvae_speech_tpu.train.revival import (
    apply_revival as jax_apply_revival,
    revival_settings as jax_revival_settings,
)
from vqvae_speech_tpu_torch.convert import load_jax_params, numpy_params
from vqvae_speech_tpu_torch.models import ConvVQVAE
from vqvae_speech_tpu_torch.models.vq_repulsion import reset_dead_codes
from vqvae_speech_tpu_torch.train import apply_revival, revival_settings

CFG = dict(
    input_features_filters=13, augment_input_features=True,
    output_features_filters=13, augment_output_features=True,
    num_hiddens=32, num_residual_layers=2, residual_channels=32,
    embedding_dim=16, num_embeddings=12, commitment_cost=0.25, decay=0.0,
    use_kaiming_normal=False, use_jitter=False, jitter_probability=0.12,
    use_speaker_conditioning=False, codebook_revival=True,
)


@pytest.mark.parametrize("n_rows", [3, 40])
def test_reset_dead_codes_matches_jax(n_rows):
    """More dead codes than input rows (n_rows=3) wraps the rank modulo n."""
    rng = np.random.default_rng(n_rows)
    K, D = 9, 4
    cb, ema_w = (rng.standard_normal((K, D)).astype(np.float32)
                 for _ in range(2))
    cluster = rng.random(K).astype(np.float32)
    usage = np.array([.2, .001, .3, .002, .003, .4, .004, .005, .006],
                     np.float32)
    flat = rng.standard_normal((n_rows, D)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jax_reset(key, *(jnp.asarray(a) for a in
                            (cb, ema_w, cluster, usage, flat)), threshold=0.01)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, n_rows)))
    got = reset_dead_codes(*(torch.from_numpy(a) for a in
                             (cb, ema_w, cluster, usage, flat)),
                           threshold=0.01, perm=perm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.num_reset) == 6


def test_own_permutation_is_seeded_and_leaves_live_codes_alone():
    K, D = 6, 3
    cb = torch.arange(K * D, dtype=torch.float32).reshape(K, D)
    usage = torch.tensor([.5, .0, .5, .0, .5, .5])
    flat = torch.randn(50, D, generator=torch.Generator().manual_seed(0))
    runs = [reset_dead_codes(cb, cb, torch.ones(K), usage, flat,
                             generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0].codebook, runs[1].codebook)
    assert not torch.equal(runs[0].codebook, runs[2].codebook)
    live = usage >= 0.01
    assert torch.equal(runs[0].codebook[live], cb[live])
    for row in runs[0].codebook[~live]:
        assert (flat == row).all(1).any()      # a copy of an input row


def test_settings_match_jax():
    for cfg in (CFG, dict(CFG, codebook_revival=False),
                dict(CFG, revival_threshold=0.2, revival_usage_decay=0.9)):
        assert revival_settings(cfg) == jax_revival_settings(cfg)


@pytest.mark.parametrize("decay", [0.0, 0.99])
def test_apply_revival_matches_jax(decay):
    """One post-update pass for the gradient and the EMA variant: usage EMA,
    re-seeded codebook (and EMA statistics), the revived-codes metric."""
    cfg = dict(CFG, decay=decay)
    params, state = numpy_params(cfg, seed=0)
    model = load_jax_params(ConvVQVAE.from_config(cfg), params, state)
    rng = np.random.default_rng(1)
    K, D = cfg["num_embeddings"], cfg["embedding_dim"]
    counts = np.array([30, 0, 0, 10, 0, 8, 0, 0, 0, 0, 0, 0], np.float32)
    flat = rng.standard_normal((48, D)).astype(np.float32)
    enabled, rev_decay, _ = revival_settings(cfg)
    threshold = 0.083     # an unused code falls from 1/12 to 0.0825 in one pass
    key = jax.random.PRNGKey(9)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    want_p, want_s, want_m = jax_apply_revival(
        key, jparams, jstate,
        {"counts": jnp.asarray(counts), "flat": jnp.asarray(flat)}, {}, cfg,
        rev_decay, threshold)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 48)))
    revived = apply_revival(model, torch.from_numpy(counts),
                            torch.from_numpy(flat), rev_decay, threshold,
                            perm=perm)
    assert enabled and revived.item() == float(want_m["revived_codes"]) == 9
    np.testing.assert_allclose(model.revival_usage.numpy(),
                               np.asarray(want_s["revival"]["usage"]),
                               rtol=1e-6)
    if decay:
        for name in ("codebook", "ema_w", "ema_cluster_size"):
            np.testing.assert_array_equal(getattr(model.vq, name).numpy(),
                                          np.asarray(want_s["vq"][name]))
    else:
        np.testing.assert_array_equal(model.vq.codebook.detach().numpy(),
                                      np.asarray(want_p["vq"]["codebook"]))
        assert isinstance(model.vq.codebook, torch.nn.Parameter)
