"""PyTorch port: ContinuousSynthesisServer against the JAX server of the same
name, on JAX's own test fixture (tests/test_continuous_serve.py: 32 bins, 4
layers, k=2, C=G=S=8, upsample x4), with the parameters copied across.

Every contract of the JAX tests, held against JAX's server run on the same
requests: greedy f32, int8 and int8_block waves EQUAL to JAX's (integer
bins), ``stats`` holding JAX's keys and values (and the port's raw slot
counts beside them), and sampled streams equal to JAX's when the port is
fed JAX's own draws (``noises=``, recomputed from its key chain
``fold_in(PRNGKey(seed), id)`` split once a step). Against a standalone
batch-1 greedy decode (the port's own, and JAX's) the streams are also
compared; on this fixture they agree in every sample, and the test counts
the bins that differ at a near-tie should that change (none allowed
silently: each must be a near-tie of the standalone logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models.wavenet.incremental import (
    wavenet_incremental_generate as jax_generate,
)
from vqvae_speech_tpu.models.wavenet.model import WaveNetConfig as JaxConfig
from vqvae_speech_tpu.models.wavenet.model import wavenet_init
from vqvae_speech_tpu.serve import ContinuousSynthesisServer as JaxServer
from vqvae_speech_tpu_torch.convert import load_wavenet_params
from vqvae_speech_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetConfig,
    wavenet_incremental_generate,
)
from vqvae_speech_tpu_torch.serve import ContinuousSynthesisServer

FIXTURE_KW = dict(out_channels=32, layers=4, stacks=2, residual_channels=8,
                  gate_channels=8, skip_out_channels=8, kernel_size=2,
                  cin_channels=4, gin_channels=-1,
                  upsample_conditional_features=True, upsample_scales=(2, 2))
# a near-tie: the standalone decode's top two logits within this
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def vocoder():
    jcfg = JaxConfig(**FIXTURE_KW)
    params = wavenet_init(jax.random.PRNGKey(0), jcfg)
    return (params, jcfg, jax.tree_util.tree_map(np.asarray, params),
            WaveNetConfig(**FIXTURE_KW))


def conds(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 4)).astype(np.float32) for n in lengths]


def servers(vocoder, **kw):
    params, jcfg, tree, tcfg = vocoder
    return (JaxServer(params, jcfg, **kw),
            ContinuousSynthesisServer(tree, tcfg, device="cpu", **kw))


def standalone(vocoder, c):
    """The port's standalone batch-1 greedy decode of one request (the
    bucketed server's f32 path): (bins, logits)."""
    _, _, tree, tcfg = vocoder
    model = load_wavenet_params(WaveNet(tcfg), tree).eval()
    outs, em = wavenet_incremental_generate(
        model, tcfg, c.shape[0] * 4, c=torch.from_numpy(c[None]),
        sample=False, use_fused_stack=True)
    return em[0].numpy(), outs[0].numpy()


def jax_standalone(vocoder, c, **kw):
    params, jcfg, _, _ = vocoder
    _, want = jax_generate(params, jcfg, jax.random.PRNGKey(0),
                           c.shape[0] * 4, c=jnp.asarray(c[None]),
                           sample=False, **kw)
    return np.asarray(want)[0]


def assert_stats_match(server, jax_server):
    """The port's ``stats`` hold JAX's keys with JAX's values, and beside
    them the raw slot counts whose rounded quotient is the utilization."""
    got, want = server.stats, jax_server.stats
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"busy_slot_steps", "slot_steps"}
    assert got["slot_steps"] == (got["launches"] * got["slots"]
                                 * got["chunk_size"])
    if got["slot_steps"]:
        assert got["slot_utilization"] == round(
            got["busy_slot_steps"] / got["slot_steps"], 4)


def flips_at_near_ties(wave, want, logits):
    """The bins where ``wave`` leaves ``want`` (a stream of the same
    request): raises unless the first is a near-tie of ``logits``; returns
    how many differ."""
    diff = np.flatnonzero(wave != want)
    if len(diff):
        top2 = np.sort(logits[diff[0]])[-2:]
        assert top2[1] - top2[0] <= NEAR_TIE, (diff[0], top2)
    return len(diff)


def test_greedy_matches_jax_and_standalone_across_chunks(vocoder):
    """Chunk 7 divides no request length: every stream crosses chunk
    boundaries mid-flight; 5 requests through 2 slots reuse the slots, so
    a missing age mask would show here."""
    requests = conds([6, 4, 12, 9, 3])
    jax_server, server = servers(vocoder, slots=2, chunk_size=7,
                                 max_frames=12, sample=False)
    want = jax_server.run(requests)
    got = server.run(requests)
    flips = 0
    for c, g, w in zip(requests, got, want):
        assert g.wave.shape == (c.shape[0] * 4,) and g.wave.dtype == np.int32
        assert g.bucket == w.bucket == 12
        np.testing.assert_array_equal(g.wave, w.wave)
        bins, logits = standalone(vocoder, c)
        flips += flips_at_near_ties(g.wave, bins, logits)
        np.testing.assert_array_equal(jax_standalone(vocoder, c), w.wave)
    assert flips == 0     # none on this fixture; see flips_at_near_ties
    assert_stats_match(server, jax_server)
    assert server.stats["launches"] >= 3
    assert 0.0 < server.stats["slot_utilization"] <= 1.0


def test_stream_independent_of_admission_time_and_neighbors(vocoder):
    target = conds([8], seed=9)[0]
    _, alone_server = servers(vocoder, slots=2, chunk_size=16, max_frames=8,
                              sample=False)
    alone = alone_server.run([target])[0].wave
    # admitted LAST behind a crowd of other lengths: another slot, another
    # clock, a slot whose ring holds a previous occupant's history
    crowd = conds([5, 8, 3, 6], seed=10) + [target]
    jax_server, server = servers(vocoder, slots=2, chunk_size=16,
                                 max_frames=8, sample=False)
    late = server.run(crowd)[4].wave
    np.testing.assert_array_equal(late, alone)
    np.testing.assert_array_equal(late, jax_server.run(crowd)[4].wave)


def jax_draws(seed, rid, n, width, scalar=False):
    """JAX's draws for request ``rid`` of a continuous server: its slot key
    fold_in(PRNGKey(seed), rid), split once a step into (next key, sample
    key); the categorical's Gumbel noise over ``width`` bins, or the
    mixture sampler's Gumbel over its components and its u."""
    def step(key, _):
        nxt, ks = jax.random.split(key)
        if not scalar:
            return nxt, jax.random.gumbel(ks, (width,), jnp.float32)
        k_sel, k_u = jax.random.split(ks)
        g = jax.random.gumbel(k_sel, (1, 1, width - 1), jnp.float32)
        u = jax.random.uniform(k_u, (1, 1), minval=1e-5, maxval=1.0 - 1e-5)
        return nxt, jnp.concatenate([g[0, 0], u[0].astype(jnp.float32)])

    key = jax.random.fold_in(jax.random.PRNGKey(seed), rid)
    return np.asarray(jax.lax.scan(step, key, None, length=n)[1])


def test_sampled_streams_follow_jax_draws(vocoder):
    """Fed JAX's draws, the port samples JAX's streams, whatever the slots,
    chunk and queue; with its own seeded draws, request 2's stream is the
    same alone-in-queue or in a crowd, and differs from the greedy one."""
    target = conds([6], seed=3)[0]
    filler = conds([4, 5], seed=4)
    requests = filler + [target]
    noises = [jax_draws(0, i, c.shape[0] * 4, 32)
              for i, c in enumerate(requests)]
    for kw in (dict(slots=4, chunk_size=8), dict(slots=2, chunk_size=32)):
        jax_server, server = servers(vocoder, max_frames=6, sample=True, **kw)
        want = jax_server.run(requests)
        got = server.run(requests, noises=noises)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.wave, w.wave)
        assert_stats_match(server, jax_server)
    a = servers(vocoder, slots=4, chunk_size=8, max_frames=6,
                sample=True)[1].run(requests)[2].wave
    b = servers(vocoder, slots=2, chunk_size=32, max_frames=6,
                sample=True)[1].run(requests)[2].wave
    np.testing.assert_array_equal(a, b)
    g = servers(vocoder, slots=2, chunk_size=8, max_frames=6,
                sample=False)[1].run(requests)[2].wave
    assert not np.array_equal(a, g)


@pytest.mark.parametrize("weight_quant", ["int8", "int8_block"])
def test_int8_compositions(vocoder, weight_quant):
    requests = conds([6], seed=5) + conds([3, 5], seed=6)
    jax_server, server = servers(vocoder, slots=2, chunk_size=8,
                                 max_frames=6, sample=False,
                                 weight_quant=weight_quant)
    want = jax_server.run(requests)
    got = server.run(requests)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.wave, w.wave)
    np.testing.assert_array_equal(
        got[0].wave, jax_standalone(vocoder, requests[0],
                                    weight_quant=weight_quant))
    assert_stats_match(server, jax_server)


def test_rejects_oversized_conditioning_before_enqueuing(vocoder):
    _, server = servers(vocoder, slots=2, chunk_size=8, max_frames=4)
    with pytest.raises(ValueError, match="max_frames"):
        server.run(conds([3, 5]))
    assert server.pending == 0 and server.stats["launches"] == 0
    with pytest.raises(ValueError, match="max_frames"):
        server.submit(conds([5])[0])
    assert server.pending == 0


def test_online_submit_step_collect(vocoder):
    """Requests submitted while others are in flight complete with JAX's
    streams; collect is take-once; the latency split adds up; a drain
    after the pool emptied (clock rewound) gives the same stream again."""
    c0, c1, c2 = conds([12, 6, 9], seed=21)
    jax_server, server = servers(vocoder, slots=2, chunk_size=5,
                                 max_frames=12, sample=False)
    ids = {}
    for name, srv in (("jax", jax_server), ("port", server)):
        r0 = srv.submit(c0)
        assert srv.step() == [] and srv.collect(r0) is None
        r1 = srv.submit(c1)          # joins mid-flight
        r2 = srv.submit(c2)          # queues behind it
        done = []
        while srv.pending:
            done += srv.step()
        assert sorted(done) == [r0, r1, r2]
        ids[name] = (r0, r1, r2)
    assert ids["jax"] == ids["port"]
    for rid, c in zip(ids["port"], (c0, c1, c2)):
        got = server.collect(rid)
        np.testing.assert_array_equal(got.wave, jax_server.collect(rid).wave)
        np.testing.assert_array_equal(got.wave, standalone(vocoder, c)[0])
        assert server.collect(rid) is None
    st = server.stats
    assert_stats_match(server, jax_server)
    assert st["mean_latency_chunks"] > 0
    for k in ("latency_chunks", "admission_wait_chunks", "decode_chunks"):
        assert st[k] is not None and st[k]["max"] >= st[k]["p50"] >= 0
    assert st["admission_wait_chunks"]["max"] >= 1
    assert st["latency_chunks"]["mean"] == pytest.approx(
        st["admission_wait_chunks"]["mean"] + st["decode_chunks"]["mean"],
        abs=0.02)
    again = server.run([c0])[0].wave
    np.testing.assert_array_equal(again, jax_server.run([c0])[0].wave)


def test_speaker_conditioned_streams_match_jax():
    """A speaker-conditioned model (global + local conditioning, k=3,
    legacy off) through 3 slots: waves equal to JAX's."""
    kw = dict(FIXTURE_KW, gin_channels=4, n_speakers=3, kernel_size=3,
              legacy=False)
    jcfg = JaxConfig(**kw)
    params = wavenet_init(jax.random.PRNGKey(2), jcfg)
    jax_server = JaxServer(params, jcfg, slots=3, chunk_size=9,
                           max_frames=10, sample=False)
    server = ContinuousSynthesisServer(
        jax.tree_util.tree_map(np.asarray, params), WaveNetConfig(**kw),
        slots=3, chunk_size=9, max_frames=10, sample=False, device="cpu")
    requests = conds([10, 3, 7, 5, 9, 2], seed=8)
    speakers = [2, 0, 1, 1, 0, 2]
    want = jax_server.run(requests, speakers)
    got = server.run(requests, speakers)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.wave, w.wave)
    assert_stats_match(server, jax_server)


def test_noise_and_seed_are_checked(vocoder):
    _, server = servers(vocoder, slots=2, chunk_size=8, max_frames=6,
                        sample=True)
    with pytest.raises(ValueError, match="noises"):
        server.run(conds([3, 4]), noises=[np.zeros((12, 32), np.float32)])
    with pytest.raises(ValueError, match="negative"):
        server.submit(conds([3])[0], seed=-1)
    with pytest.raises(ValueError, match="needs"):
        server.submit(conds([3])[0], noise=np.zeros((11, 32), np.float32))
    assert server.pending == 0
