"""The demo quantizers of the PyTorch port against the JAX package's:
``models/vq_balanced.py`` (apply, revival with JAX's draws fed, top-k ties),
``models/vq_adaptive.py`` (masked apply, prune, merge with two donors for one
winner, the one-active-code floor, stability) and ``models/vq_repulsion.py``
(``codebook_repulsion``, ``usage_ema_update``).

Inputs from numpy seeds; the JAX side runs with x64 off (the production
semantics: tests/conftest.py turns x64 on, which would make JAX's adaptive
state float64 after one step). Indices and active masks equal; floats within
rtol 1e-6 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vocoder_train import one_torch_thread  # noqa: F401
from vqvae_speech_tpu.models import vq_adaptive as jax_adaptive
from vqvae_speech_tpu.models import vq_balanced as jax_balanced
from vqvae_speech_tpu.models import vq_repulsion as jax_repulsion
from vqvae_speech_tpu_torch.models import vq_adaptive, vq_balanced, vq_repulsion

TOL = dict(rtol=1e-6, atol=1e-6)


def to_torch(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def to_jax(state):
    return {k: jnp.asarray(v.numpy()) for k, v in state.items()}


def assert_state(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def jax_revival_draws(key, K, D):
    """The draws balanced_vq_apply makes from ``revival_key``."""
    k_pick, k_noise = jax.random.split(key)
    slots = jax.random.randint(k_pick, (K,), 0, min(3, K // 2))
    noise = jax.random.normal(k_noise, (K, D), jnp.float32)
    return vq_balanced.RevivalDraws(torch.from_numpy(np.array(slots)),
                                    torch.from_numpy(np.array(noise)))


def _points(n, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, 2))
            ).astype(np.float32)


def _balanced_state(K, seed):
    rng = np.random.default_rng(seed)
    return {"codebook": rng.standard_normal((K, 2)).astype(np.float32),
            "ema_cluster_size": np.zeros(K, np.float32),
            "ema_w": np.zeros((K, 2), np.float32),
            "usage_count": np.zeros(K, np.float32)}


@pytest.mark.parametrize("revival", [False, True])
def test_balanced_apply_steps_match_jax(revival):
    """Four training steps and an eval step; the far-away code 0 comes near
    the data, by JAX's own draws with revival, by the EMA update of a code
    no row chose without."""
    K, points = 8, _points(500, 0)
    state = _balanced_state(K, 1)
    state["codebook"][0] = [100.0, 100.0]
    with jax.enable_x64(False):
        jstate = {k: jnp.asarray(v) for k, v in state.items()}
        pstate = to_torch(state)
        for i in range(4):
            key = jax.random.PRNGKey(i + 1) if revival else None
            want = jax_balanced.balanced_vq_apply(
                jstate, jnp.asarray(points), training=True, revival_key=key)
            got = vq_balanced.balanced_vq_apply(
                pstate, torch.from_numpy(points), training=True,
                revival_draws=jax_revival_draws(key, K, 2) if revival
                else None)
            np.testing.assert_array_equal(got.indices.numpy(),
                                          np.asarray(want.indices))
            np.testing.assert_array_equal(got.encodings.numpy(),
                                          np.asarray(want.encodings))
            for name in ("vq_loss", "quantized", "perplexity"):
                np.testing.assert_allclose(
                    getattr(got, name).detach().numpy(),
                    np.asarray(getattr(want, name)), err_msg=name, **TOL)
            assert_state(got.new_state, want.new_state)
            jstate, pstate = want.new_state, got.new_state
        want = jax_balanced.balanced_vq_apply(jstate, jnp.asarray(points),
                                              training=False)
    got = vq_balanced.balanced_vq_apply(pstate, torch.from_numpy(points),
                                        training=False)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    assert got.new_state is pstate
    assert np.linalg.norm(pstate["codebook"][0].numpy()) < 50.0


def test_balanced_revival_top_k_ties_lower_index_first():
    """Usage counts tied among the top codes: jax.lax.top_k takes the lower
    index first, and so must the donors. Every row takes code 5, so the
    usage is [0, 90, 90, 0, 90, 150]: the donors are codes 5, 1, 2 (not 4),
    and the dead codes 0 and 3 draw them over five keys."""
    K, points = 6, _points(120, 2)
    state = _balanced_state(K, 3)
    state["usage_count"] = np.array([0, 90, 90, 0, 90, 30], np.float32)
    state["codebook"] = (1000.0 + np.arange(2 * K, dtype=np.float32)
                         ).reshape(K, 2)
    state["codebook"][5] = [0.0, 0.0]
    slots = set()
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        with jax.enable_x64(False):
            want = jax_balanced.balanced_vq_apply(
                {k: jnp.asarray(v) for k, v in state.items()},
                jnp.asarray(points), training=True, revival_key=key)
            draws = jax_revival_draws(key, K, 2)
        got = vq_balanced.balanced_vq_apply(
            to_torch(state), torch.from_numpy(points), training=True,
            revival_draws=draws)
        assert_state(got.new_state, want.new_state)
        slots |= set(draws.slots[[0, 3]].tolist())
    assert slots == {0, 1, 2}   # the third donor, a tied one, was drawn
    _, donors = jax.lax.top_k(jnp.asarray([0, 90, 90, 0, 90, 150.0]), 3)
    assert list(np.asarray(donors)) == [5, 1, 2]


def test_balanced_revival_from_a_generator_is_seeded():
    K, points = 8, _points(500, 4)
    state = to_torch(_balanced_state(K, 5))
    state["codebook"][0] = torch.tensor([100.0, 100.0])
    outs = []
    for _ in range(2):
        s = state
        gen = torch.Generator().manual_seed(3)
        for _ in range(3):
            s = vq_balanced.balanced_vq_apply(
                s, torch.from_numpy(points), revival_generator=gen).new_state
        outs.append(s)
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)
    assert outs[0]["codebook"][0].norm() < 50.0


def test_balanced_init_shapes():
    s = vq_balanced.balanced_vq_init(
        8, 2, device="cpu", generator=torch.Generator().manual_seed(0))
    assert s["codebook"].shape == (8, 2)
    assert float(s["codebook"].abs().max()) <= 1.0 / 8
    for k in ("ema_cluster_size", "ema_w", "usage_count"):
        assert not s[k].any()


def _adaptive_state(K, n_active, seed):
    with jax.enable_x64(False):
        s = jax_adaptive.adaptive_vq_init(jax.random.PRNGKey(seed), K, 2,
                                          initial_num_embeddings=n_active)
        s["codebook"] = jnp.asarray(
            np.random.default_rng(seed).standard_normal((K, 2))
            .astype(np.float32))
        return {k: np.array(v) for k, v in s.items()}


def test_adaptive_apply_steps_match_jax():
    """Five training steps over a codebook of 16 with codes 0-5 and 9
    active (a gap in the active set), then an eval step."""
    K, points = 16, _points(400, 6, 2.0)
    state = _adaptive_state(K, 6, 0)
    state["active"][9] = True
    with jax.enable_x64(False):
        jstate = {k: jnp.asarray(v) for k, v in state.items()}
        pstate = to_torch(state)
        for _ in range(5):
            want = jax_adaptive.adaptive_vq_apply(jstate, jnp.asarray(points))
            got = vq_adaptive.adaptive_vq_apply(pstate,
                                                torch.from_numpy(points))
            np.testing.assert_array_equal(got.indices.numpy(),
                                          np.asarray(want.indices))
            for name in ("vq_loss", "quantized", "perplexity"):
                np.testing.assert_allclose(
                    getattr(got, name).detach().numpy(),
                    np.asarray(getattr(want, name)), err_msg=name, **TOL)
            assert_state(got.new_state, want.new_state)
            jstate, pstate = want.new_state, got.new_state
        want = jax_adaptive.adaptive_vq_apply(jstate, jnp.asarray(points),
                                              training=False)
    got = vq_adaptive.adaptive_vq_apply(pstate, torch.from_numpy(points),
                                        training=False)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    assert set(np.unique(got.indices.numpy())) <= {0, 1, 2, 3, 4, 5, 9}


def _prune_and_merge_both(state, **kw):
    with jax.enable_x64(False):
        want = jax_adaptive.adaptive_prune_and_merge(
            {k: jnp.asarray(v) for k, v in state.items()}, **kw)
    got = vq_adaptive.adaptive_prune_and_merge(to_torch(state), **kw)
    assert_state(got, want)
    return got


def test_prune_and_merge_matches_jax_random():
    """Random codebooks and usages, some codes inactive: prune, merge and
    the stability counter over three passes."""
    rng = np.random.default_rng(8)
    for trial in range(4):
        state = _adaptive_state(24, 20, trial)
        state["codebook"] = rng.uniform(-2, 2, (24, 2)).astype(np.float32)
        state["ema_usage"] = (rng.uniform(0, 1, 24)
                              * (rng.uniform(0, 1, 24) > 0.2)
                              ).astype(np.float32)
        for _ in range(3):
            got = _prune_and_merge_both(state, min_usage_threshold=0.02,
                                        merge_distance_threshold=0.6)
            state = {k: v.numpy() for k, v in got.items()}


def test_merge_two_donors_for_one_winner():
    """Codes 1 and 2 both merge into code 0: the JAX scatter keeps one donor
    a winner a pass (the higher index, 2, whatever the usages), the other
    is pruned without its position merged."""
    cb = np.array([[0, 0], [0.3, 0], [0, 0.3], [5, 5], [-5, 5]], np.float32)
    for usage in ([0.5, 0.1, 0.2, 0.1, 0.1], [0.5, 0.2, 0.1, 0.1, 0.1]):
        state = _adaptive_state(5, 5, 0)
        state["codebook"] = cb
        state["ema_usage"] = np.array(usage, np.float32)
        got = _prune_and_merge_both(state, min_usage_threshold=0.0,
                                    merge_distance_threshold=0.5)
        u = np.array(usage, np.float32)
        want0 = (u[0] * cb[0] + u[2] * cb[2]) / (u[0] + u[2])
        np.testing.assert_allclose(got["codebook"][0].numpy(), want0,
                                   rtol=1e-6)
        assert got["active"].tolist() == [True, False, False, True, True]


def test_never_below_one_active_code():
    """Every active code under the usage threshold: code 0 alone stays
    active, whether or not it was active before."""
    for active0 in (True, False):
        state = _adaptive_state(6, 6, 1)
        state["codebook"] = 10.0 * np.arange(12, dtype=np.float32
                                             ).reshape(6, 2)
        state["active"][0] = active0
        state["ema_usage"] = np.full(6, 1e-4, np.float32)
        got = _prune_and_merge_both(state, min_usage_threshold=0.5)
        assert got["active"].tolist() == [True] + [False] * 5
        assert vq_adaptive.active_codes_count(got) == 1


def test_stability_and_helpers():
    state = _adaptive_state(8, 3, 2)
    state["codebook"] = 10.0 * np.arange(16, dtype=np.float32).reshape(8, 2)
    state["ema_usage"] = np.array([1, 1, 1, 0, 0, 0, 0, 0], np.float32)
    s = to_torch(state)
    for passes in range(1, 4):
        s = vq_adaptive.adaptive_prune_and_merge(s)
        assert int(s["stable_steps"]) == passes
    assert vq_adaptive.is_stable(s, 3) and not vq_adaptive.is_stable(s, 4)
    for n, k in ((400, 30), (10, 30), (10000, 30), (50, 6)):
        assert (vq_adaptive.suggest_initial_codes(n, k)
                == jax_adaptive.suggest_initial_codes(n, k))
    init = vq_adaptive.adaptive_vq_init(
        30, 2, device="cpu", generator=torch.Generator().manual_seed(0))
    assert vq_adaptive.active_codes_count(init) == 20
    torch.testing.assert_close(init["codebook"], init["ema_w"])
    assert init["stable_steps"].dtype == torch.int32


@pytest.mark.parametrize("outward", [0.0, 0.025])
def test_codebook_repulsion_matches_jax(outward):
    """Twelve codes, some closer than min_distance, two coincident."""
    cb = np.random.default_rng(9).uniform(-2, 2, (12, 2)).astype(np.float32)
    cb[5] = cb[4]
    with jax.enable_x64(False):
        want = jax_repulsion.codebook_repulsion(
            jnp.asarray(cb), 0.05, 1.5, outward_strength=outward)
    got = vq_repulsion.codebook_repulsion(torch.from_numpy(cb), 0.05, 1.5,
                                          outward_strength=outward)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_usage_ema_update_matches_jax():
    rng = np.random.default_rng(10)
    usage = rng.uniform(0, 1, 8).astype(np.float32)
    counts = rng.integers(0, 50, 8).astype(np.float32)
    with jax.enable_x64(False):
        want = jax_repulsion.usage_ema_update(jnp.asarray(usage),
                                              jnp.asarray(counts), 0.99)
    got = vq_repulsion.usage_ema_update(torch.from_numpy(usage),
                                        torch.from_numpy(counts), 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
