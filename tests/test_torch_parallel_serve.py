"""PyTorch port: BucketedParallelSynthesisServer against the JAX server, for
both vocoder kinds, on the same numpy parameters and mel frames and on the
JAX server's own latent noise (handed to the port through ``noises``: the
two frameworks' generators give different numbers from one seed).

Tolerance: waves within 1e-5 (small f32 conv stacks in another summation
order); batch-composition independence is bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models import clarinet as jax_clarinet
from vqvae_speech_tpu.models.flowavenet import model as jax_flow
from vqvae_speech_tpu.serve import BucketedParallelSynthesisServer as JaxServer
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models import clarinet
from vqvae_speech_tpu_torch.models.flowavenet import model as flow
from vqvae_speech_tpu_torch.serve import BucketedParallelSynthesisServer

ATOL = 1e-5
CIN = 8
FACTOR = 16
BUCKETS = (4, 8)
STUDENT = dict(num_blocks_student=(1, 2), num_layers=3, front_channels=8,
               residual_channels=16, gate_channels=32, skip_channels=16,
               kernel_size=3, cin_channels=CIN)
TEACHER = dict(num_blocks=1, num_layers=2, front_channels=8,
               residual_channels=8, gate_channels=16, skip_channels=8,
               cin_channels=CIN, upsample_scales=(4, 4))
FLOW = dict(cin_channel=CIN, n_block=3, n_flow=2, n_layer=2,
            block_per_split=2, filter_size=16, upsample_scales=(4, 4))


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def servers(kind, seed=0, **kw):
    """(the JAX server, the port's server) over one numpy tree."""
    if kind == "flowavenet":
        cfg = flow.FlowavenetConfig(**FLOW)
        tree = convert.numpy_flowavenet_params(cfg, seed)
        jax_args = (as_jax(tree), jax_flow.FlowavenetConfig(**FLOW))
        jax_kw, port_kw = {}, {}
    else:
        cfg = clarinet.StudentConfig(**STUDENT)
        tcfg = clarinet.GaussianWaveNetConfig(**TEACHER)
        tree = convert.numpy_student_params(cfg, seed)
        teacher = convert.numpy_gaussian_wavenet_params(tcfg, seed + 1)
        jax_args = (as_jax(tree), jax_clarinet.StudentConfig(**STUDENT))
        jax_kw = dict(teacher_params=as_jax(teacher),
                      teacher_cfg=jax_clarinet.GaussianWaveNetConfig(**TEACHER))
        port_kw = dict(teacher_params=teacher, teacher_cfg=tcfg)
    return (JaxServer(kind, *jax_args, frame_buckets=BUCKETS, **jax_kw, **kw),
            BucketedParallelSynthesisServer(
                kind, tree, cfg, frame_buckets=BUCKETS, device="cpu",
                **port_kw, **kw))


def mels(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((n, CIN)).astype(np.float32) for n in lengths]


def jax_noises(lengths, seed):
    """The unit-normal z the JAX server draws for each request
    (serve.py: fold_in(PRNGKey(seed), index), shape (bucket * factor, 1))."""
    key = jax.random.PRNGKey(seed)
    out = []
    for i, n in enumerate(lengths):
        T = min(b for b in BUCKETS if n <= b) * FACTOR
        out.append(np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), (T, 1), jnp.float32)))
    return out


LENGTHS = [4, 3, 8, 6, 2, 7, 5]        # 3 in bucket 4, 4 in bucket 8


@pytest.mark.parametrize("kind,max_batch,fused", [
    ("iaf_student", 2, False), ("flowavenet", 2, False),
    ("iaf_student", 1, True), ("flowavenet", 1, True)])
def test_waves_match_jax_server(kind, max_batch, fused):
    jax_server, server = servers(kind, max_batch=max_batch,
                                 use_fused_chain=fused)
    requests = mels(LENGTHS)
    want = jax_server.synthesize(requests, seed=3)
    got = server.synthesize(requests, seed=3, noises=jax_noises(LENGTHS, 3))
    launches = sum(-(-n // max_batch) for n in (3, 4))
    assert server.stats == dict(
        served_buckets=list(BUCKETS), launches=launches, max_batch=max_batch,
        upsample_factor=FACTOR)
    assert jax_server.stats["launches"] == launches
    for c, g, w in zip(requests, got, want):
        assert g.bucket == w.bucket
        assert g.wave.shape == w.wave.shape == (c.shape[0] * FACTOR,)
        assert g.wave.dtype == np.float32 and np.isfinite(g.wave).all()
        np.testing.assert_allclose(g.wave, w.wave, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["iaf_student", "flowavenet"])
def test_fused_single_stream_matches_plain_server(kind):
    _, plain = servers(kind, seed=1, max_batch=4)
    _, fused = servers(kind, seed=1, max_batch=1, use_fused_chain=True)
    requests = mels([8, 5, 4], seed=2)
    for g, w in zip(fused.synthesize(requests, seed=7),
                    plain.synthesize(requests, seed=7)):
        np.testing.assert_allclose(g.wave, w.wave, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["iaf_student", "flowavenet"])
def test_batch_composition_independence(kind):
    """A request's wave depends on (seed, its index, its mel) only: alone in
    a padded launch or with neighbours in it, in one bucket or among
    requests of another, bit for bit (every launch of a bucket has one
    shape, so each row goes through the same arithmetic)."""
    _, server = servers(kind, seed=2, max_batch=4)
    requests = mels([6, 8, 7, 5, 8], seed=4)       # all in bucket 8
    together = server.synthesize(requests, seed=11)
    alone = server.synthesize(requests[:1], seed=11)
    np.testing.assert_array_equal(together[0].wave, alone[0].wave)
    mixed = server.synthesize(requests[:2] + mels([3, 4], seed=5), seed=11)
    np.testing.assert_array_equal(together[1].wave, mixed[1].wave)
    # the same seed, the same wave; another seed or index, another noise
    again = server.synthesize(requests, seed=11)
    np.testing.assert_array_equal(together[3].wave, again[3].wave)
    other = server.synthesize(requests, seed=12)
    assert not np.array_equal(together[0].wave, other[0].wave)
    shifted = server.synthesize(requests[1:], seed=11)
    assert not np.array_equal(together[1].wave, shifted[0].wave)


def test_constructor_and_request_errors():
    cfg = flow.FlowavenetConfig(**FLOW)
    tree = convert.numpy_flowavenet_params(cfg, 0)
    kw = dict(frame_buckets=BUCKETS, device="cpu")
    with pytest.raises(ValueError, match="unknown parallel vocoder kind"):
        BucketedParallelSynthesisServer("wavenet", tree, cfg, **kw)
    with pytest.raises(ValueError, match="teacher_params"):
        BucketedParallelSynthesisServer("iaf_student", tree, cfg, **kw)
    with pytest.raises(ValueError, match="max_batch=1"):
        BucketedParallelSynthesisServer("flowavenet", tree, cfg,
                                        use_fused_chain=True, **kw)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        BucketedParallelSynthesisServer("flowavenet", tree, cfg,
                                        compute_dtype=torch.bfloat16, **kw)
    with pytest.raises(TypeError):
        BucketedParallelSynthesisServer("flowavenet", tree, cfg,
                                        frame_buckets=BUCKETS)  # no device
    server = BucketedParallelSynthesisServer("flowavenet", tree, cfg, **kw)
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        server.synthesize(mels([9]))
    with pytest.raises(ValueError, match="noises for 1 requests"):
        server.synthesize(mels([4]), noises=[])
    with pytest.raises(ValueError, match="its bucket needs"):
        server.synthesize(mels([3]), noises=[np.zeros((3 * FACTOR, 1))])
    with pytest.raises(ValueError, match="seed"):
        server.synthesize(mels([4]), seed=-1)
