"""PyTorch port: the chunked decode beneath the continuous server
(models/wavenet/chunked.py) against the JAX package's, function by function.

* ``slot_conditioning`` rows within rtol/atol 1e-5 of JAX's (the same f32
  upsampler and projections, sums in another order), at bf16 within
  2**-7 relative (one bf16 ulp and XLA's wider intermediates);
* chunks advanced through both packages' ``init_decode_slots`` /
  ``admit_slot`` / ``decode_chunk`` with admissions mid-flight: emitted bins
  EQUAL, on the prepared step (the kernel's plain chain here) and on the
  per-layer path;
* the scalar-input (mixture) chunk: greedy samples within 1e-6 of JAX's
  (unclipped first channel fed back; measured 4e-8), sampled ones within
  1e-5 on JAX's draws (JAX's u is f64 under the tests' x64, the port's f32);
* bf16: streams equal up to the first near-tie, a step whose top two
  logits lie within BF16_NEAR_TIE, and logits before it within
  BF16_LOGIT_TOL of JAX's standalone bf16 decode of the same request.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_continuous_serve import assert_stats_match, jax_draws
from vqvae_speech_tpu.models.wavenet import chunked as jax_chunked
from vqvae_speech_tpu.models.wavenet.incremental import (
    wavenet_incremental_generate as jax_generate,
)
from vqvae_speech_tpu.models.wavenet.model import WaveNetConfig as JaxConfig
from vqvae_speech_tpu.models.wavenet.model import wavenet_init
from vqvae_speech_tpu.serve import ContinuousSynthesisServer as JaxServer
from vqvae_speech_tpu_torch.convert import load_wavenet_params
from vqvae_speech_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.models.wavenet.chunked import (
    admit_slot,
    decode_chunk,
    init_decode_slots,
    noise_width,
    slot_conditioning,
)
from vqvae_speech_tpu_torch.serve import ContinuousSynthesisServer

GC_KW = dict(out_channels=24, layers=4, stacks=2, residual_channels=8,
             gate_channels=12, skip_out_channels=8, kernel_size=3,
             dropout=0.0, cin_channels=4, gin_channels=4, n_speakers=3,
             upsample_conditional_features=True, upsample_scales=(2, 2))
SCALAR_KW = dict(GC_KW, out_channels=30, scalar_input=True)
# bf16 logits: two bf16 ulps at |x| in [0.5, 1); a near-tie within one
BF16_LOGIT_TOL, BF16_NEAR_TIE = 2 ** -7, 2 ** -8


def model(kw, seed=0):
    jcfg = JaxConfig(**kw)
    params = wavenet_init(jax.random.PRNGKey(seed), jcfg)
    tcfg = WaveNetConfig(**kw)
    module = load_wavenet_params(WaveNet(tcfg),
                                 jax.tree_util.tree_map(np.asarray, params))
    return params, jcfg, module.eval(), tcfg


def conds(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 4)).astype(np.float32) for n in lengths]


def padded(c, frames):
    out = np.zeros((frames, c.shape[1]), np.float32)
    out[:c.shape[0]] = c
    return out


@pytest.mark.parametrize("speaker", [None, 2])
def test_slot_conditioning_rows_match_jax(speaker):
    params, jcfg, module, tcfg = model(GC_KW)
    c = padded(conds([5])[0], 8)
    want = np.asarray(jax_chunked.slot_conditioning(params, jcfg, c, speaker,
                                                    32))
    got = slot_conditioning(module, tcfg, torch.from_numpy(c), speaker, 32)
    assert tuple(got.shape) == want.shape == (32, 4, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_chunked.slot_conditioning(
        params, jcfg, c, speaker, 32, compute_dtype=jnp.bfloat16)
        .astype(jnp.float32))
    got = slot_conditioning(module, tcfg, torch.from_numpy(c), speaker, 32,
                            compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("fused", [True, False])
def test_decode_chunks_match_jax(fused):
    """Three slots, chunks of 5: requests admitted at clocks 0, 5 and 10
    into slots whose rings hold earlier streams' rows."""
    params, jcfg, module, tcfg = model(GC_KW, seed=1)
    slots, max_t, K = 3, 24, 5
    jprep, jstate = jax_chunked.init_decode_slots(params, jcfg, slots, max_t)
    prep, state = init_decode_slots(module, tcfg, slots, max_t,
                                    use_fused_stack=fused)
    plan = {0: [(0, 3, 0), (1, 6, 1)], 1: [(2, 2, 2)], 2: [(0, 4, 1)],
            3: [(1, 5, 0)]}
    requests = conds([3, 6, 2, 4, 5], seed=4)
    at = 0
    for chunk in range(5):
        for slot, frames, spk in plan.get(chunk, []):
            c = padded(requests[at][:frames], 6)
            at += 1
            jrows = jax_chunked.slot_conditioning(params, jcfg, c, spk, max_t)
            jstate = jax_chunked.admit_slot(jstate, slot, jrows,
                                            jax.random.PRNGKey(0))
            rows = slot_conditioning(module, tcfg, torch.from_numpy(c), spk,
                                     max_t)
            admit_slot(prep, state, slot, rows)
        jstate, jem = jax_chunked.decode_chunk(jprep, jstate, jcfg, K,
                                               sample=False)
        state, em = decode_chunk(prep, state, tcfg, K, sample=False)
        assert em.dtype == torch.int32 and tuple(em.shape) == (slots, K)
        np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    assert state["g"] == int(jstate["g"]) == 25
    np.testing.assert_array_equal(state["start"].numpy(),
                                  np.asarray(jstate["start"]))


def scalar_servers(sample, **kw):
    params, jcfg, module, tcfg = model(SCALAR_KW, seed=3)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (JaxServer(params, jcfg, sample=sample, **kw),
            ContinuousSynthesisServer(tree, tcfg, sample=sample,
                                      device="cpu", **kw), tcfg)


def test_scalar_input_greedy_chunks_match_jax():
    jax_server, server, _ = scalar_servers(False, slots=2, chunk_size=7,
                                           max_frames=6)
    requests = conds([6, 2, 5, 3], seed=5)
    speakers = [0, 2, 1, 0]
    want = jax_server.run(requests, speakers)
    got = server.run(requests, speakers)
    for g, w in zip(got, want):
        assert g.wave.dtype == np.float32 and g.wave.shape == w.wave.shape
        np.testing.assert_allclose(g.wave, w.wave, rtol=0, atol=1e-6)
    assert max(np.abs(g.wave).max() for g in got) > 0
    assert_stats_match(server, jax_server)


def test_scalar_input_sampled_chunks_follow_jax_draws():
    jax_server, server, tcfg = scalar_servers(True, slots=2, chunk_size=8,
                                              max_frames=6)
    requests = conds([6, 3, 4], seed=6)
    noises = [jax_draws(0, i, c.shape[0] * 4, noise_width(tcfg), scalar=True)
              for i, c in enumerate(requests)]
    want = jax_server.run(requests, [1, 0, 2])
    got = server.run(requests, [1, 0, 2], noises=noises)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.wave, w.wave, rtol=0, atol=1e-5)
        assert np.abs(g.wave).max() <= 1.0
    own = scalar_servers(True, slots=2, chunk_size=8, max_frames=6)[1].run(
        requests, [1, 0, 2])
    assert all(np.isfinite(r.wave).all() and np.abs(r.wave).max() <= 1.0
               for r in own)
    assert not np.allclose(own[0].wave, got[0].wave)


def first_flip(got, want, logits, near_tie):
    """The first step where two streams of one request differ (len(got)
    when none); there the top two of ``logits`` must lie within
    ``near_tie``."""
    diff = np.flatnonzero(got != want)
    if not len(diff):
        return len(got)
    top2 = np.sort(logits[diff[0]])[-2:]
    assert top2[1] - top2[0] <= near_tie, (diff[0], top2)
    return int(diff[0])


@pytest.mark.parametrize("weight_quant", [None, "int8"])
def test_bf16_chunks_follow_jax(weight_quant):
    """bf16 (and bf16 with int8 weights) through two slots, chunks of 9:
    each request's stream against JAX's bf16 chunk up to its first
    near-tie, its logits there against JAX's standalone bf16 decode."""
    params, jcfg, module, tcfg = model(GC_KW, seed=2)
    slots, max_t, K = 2, 32, 9
    jprep, jstate = jax_chunked.init_decode_slots(
        params, jcfg, slots, max_t, compute_dtype=jnp.bfloat16,
        weight_quant=weight_quant)
    prep, state = init_decode_slots(module, tcfg, slots, max_t,
                                    compute_dtype=torch.bfloat16,
                                    weight_quant=weight_quant)
    c = conds([8, 8], seed=7)
    for slot in range(slots):
        jrows = jax_chunked.slot_conditioning(params, jcfg, c[slot], slot,
                                              max_t, compute_dtype=jnp.bfloat16)
        jstate = jax_chunked.admit_slot(jstate, slot, jrows,
                                        jax.random.PRNGKey(0))
        rows = slot_conditioning(module, tcfg, torch.from_numpy(c[slot]),
                                 slot, max_t, compute_dtype=torch.bfloat16)
        admit_slot(prep, state, slot, rows)
    jem, em, outs = [], [], []
    for _ in range(max_t // K + 1):
        jstate, e = jax_chunked.decode_chunk(jprep, jstate, jcfg, K,
                                             sample=False)
        jem.append(np.asarray(e))
        state, e, o = decode_chunk(prep, state, tcfg, K, sample=False,
                                   return_logits=True)
        em.append(e.numpy())
        outs.append(o.numpy())
    jem, em = np.concatenate(jem, 1)[:, :max_t], np.concatenate(em, 1)[:, :max_t]
    outs = np.concatenate(outs, 1)[:, :max_t]
    for slot in range(slots):
        flip = first_flip(em[slot], jem[slot], outs[slot], BF16_NEAR_TIE)
        assert flip > 0
        want, _ = jax_generate(params, jcfg, jax.random.PRNGKey(0), max_t,
                               c=jnp.asarray(c[slot][None]),
                               g=jnp.asarray([slot]), sample=False,
                               compute_dtype=jnp.bfloat16,
                               weight_quant=weight_quant)
        want = np.asarray(want)[0]
        np.testing.assert_allclose(outs[slot, 0], want[0], rtol=0,
                                   atol=BF16_LOGIT_TOL)
        np.testing.assert_allclose(outs[slot, :flip], want[:flip], rtol=0,
                                   atol=2 * BF16_LOGIT_TOL)


def test_fused_chunk_is_f32_only():
    _, _, module, tcfg = model(GC_KW)
    for kw in (dict(weight_quant="int8"), dict(compute_dtype=torch.bfloat16),
               dict(weight_quant="int8_block")):
        with pytest.raises(ValueError, match="use_fused_stack"):
            init_decode_slots(module, tcfg, 2, 8, use_fused_stack=True, **kw)
    with pytest.raises(ValueError, match="weight_quant"):
        init_decode_slots(module, tcfg, 2, 8, weight_quant="int4")
