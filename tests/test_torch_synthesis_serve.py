"""PyTorch port: BucketedSynthesisServer against the JAX server, greedy, on
the small vocoder of tests/test_serve.py. Waves must be identical: greedy
bins are integers, and the port's decode follows JAX's stream exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from vqvae_speech_tpu.models.wavenet.model import WaveNetConfig as JaxConfig
from vqvae_speech_tpu.models.wavenet.model import wavenet_init
from vqvae_speech_tpu.serve import BucketedSynthesisServer as JaxServer
from vqvae_speech_tpu_torch.models.wavenet import WaveNetConfig
from vqvae_speech_tpu_torch.serve import BucketedSynthesisServer

VOCODER_KW = dict(out_channels=32, layers=2, stacks=1, residual_channels=8,
                  gate_channels=8, skip_out_channels=8, kernel_size=2,
                  cin_channels=4, gin_channels=-1,
                  upsample_conditional_features=True, upsample_scales=(2, 2))
GC_KW = dict(VOCODER_KW, gin_channels=4, n_speakers=3, layers=4, stacks=2,
             kernel_size=3)


def vocoder(kw, seed=0):
    jcfg = JaxConfig(**kw)
    params = wavenet_init(jax.random.PRNGKey(seed), jcfg)
    return params, jax.tree_util.tree_map(np.asarray, params), jcfg, \
        WaveNetConfig(**dataclasses.asdict(jcfg))


def conds(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 4)).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("kw,speakers", [(VOCODER_KW, False), (GC_KW, True)])
def test_waves_identical_to_jax_server(kw, speakers):
    params, tree, jcfg, tcfg = vocoder(kw)
    requests = conds([6, 4, 12, 9, 3, 11, 7])   # 3 in bucket 6, 4 in bucket 12
    spk = [2, 0, 1, 1, 0, 2, 1] if speakers else None
    jax_server = JaxServer(params, jcfg, frame_buckets=(6, 12), max_batch=2)
    server = BucketedSynthesisServer(tree, tcfg, frame_buckets=(6, 12),
                                     max_batch=2, device="cpu")
    want = jax_server.synthesize(requests, speaker_ids=spk)
    got = server.synthesize(requests, speaker_ids=spk)
    assert server.stats == jax_server.stats
    assert server.stats["launches"] == 4            # ceil(3/2) + ceil(4/2)
    for c, g, w in zip(requests, got, want):
        assert g.bucket == w.bucket
        assert g.wave.shape == (c.shape[0] * 4,) and g.wave.dtype == np.int32
        np.testing.assert_array_equal(g.wave, w.wave)


def test_batch_composition_independence():
    _, tree, _, tcfg = vocoder(GC_KW, seed=1)
    server = BucketedSynthesisServer(tree, tcfg, frame_buckets=(6,),
                                     max_batch=4, device="cpu")
    target = conds([6], seed=9)[0]
    alone = server.synthesize([target], speaker_ids=[2])[0].wave
    crowd = server.synthesize(conds([5, 6], seed=10) + [target],
                              speaker_ids=[0, 1, 2])
    np.testing.assert_array_equal(crowd[2].wave, alone)


def test_generate_batch_is_one_padded_launch():
    _, tree, _, tcfg = vocoder(VOCODER_KW)
    server = BucketedSynthesisServer(tree, tcfg, frame_buckets=(6,),
                                     max_batch=3, device="cpu")
    c = torch.from_numpy(np.stack(conds([6, 6, 6], seed=4)))
    outs, emitted = server.generate_batch(c)
    assert tuple(outs.shape) == (3, 24, 32) and tuple(emitted.shape) == (3, 24)
    assert emitted.dtype == torch.int32
    assert torch.equal(emitted, outs.argmax(-1).to(torch.int32))


@pytest.mark.parametrize("kwargs", [{"compute_dtype": torch.float16},
                                    {"weight_quant": "int4"},
                                    {"mesh": object()}])
def test_unported_options_raise(kwargs):
    """bf16 and int8 are served now (below); a dtype or quantization the
    JAX decode does not take raises ValueError. The tensor-parallel decode
    is ported (tests/test_torch_parallel.py serves it over 4 ranks): a mesh
    that is not a (data, model) DeviceMesh raises TypeError, and a mesh
    whose model axis has one rank serves the mesh-less waves."""
    from tests.torch_world import world_of_one

    params, tree, _, tcfg = vocoder(VOCODER_KW)
    with pytest.raises(TypeError if "mesh" in kwargs else ValueError):
        BucketedSynthesisServer(tree, tcfg, device="cpu", **kwargs)
    if "mesh" in kwargs:
        requests = conds([3, 5], seed=1)
        with world_of_one() as mesh:
            waves = [[r.wave for r in BucketedSynthesisServer(
                tree, tcfg, frame_buckets=(6,), max_batch=2, mesh=m,
                device="cpu").synthesize(requests)] for m in (mesh, None)]
        for a, b in zip(*waves):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weight_quant", ["int8", "int8_block"])
def test_quantized_waves_identical_to_jax_server(weight_quant):
    params, tree, jcfg, tcfg = vocoder(GC_KW, seed=2)
    requests = conds([6, 4, 12, 9, 3], seed=3)
    spk = [2, 0, 1, 1, 0]
    jax_server = JaxServer(params, jcfg, frame_buckets=(6, 12), max_batch=2,
                           weight_quant=weight_quant)
    server = BucketedSynthesisServer(tree, tcfg, frame_buckets=(6, 12),
                                     max_batch=2, weight_quant=weight_quant,
                                     device="cpu")
    want = jax_server.synthesize(requests, speaker_ids=spk)
    got = server.synthesize(requests, speaker_ids=spk)
    assert server.stats == jax_server.stats
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.wave, w.wave)


# a near-tie at bf16: the top two logits within one bf16 ulp at [0.5, 1)
BF16_NEAR_TIE = 2 ** -8


def test_bf16_waves_follow_jax_server():
    """bf16: each wave equal to the JAX bf16 server's up to its first
    near-tie (the port's own logits of the launch say where); XLA keeps f32
    between fused ops in its scan, torch rounds every op to bf16."""
    params, tree, jcfg, tcfg = vocoder(GC_KW, seed=2)
    requests = conds([6, 5, 6], seed=4)
    spk = [2, 0, 1]
    jax_server = JaxServer(params, jcfg, frame_buckets=(6,), max_batch=3,
                           compute_dtype=jax.numpy.bfloat16)
    server = BucketedSynthesisServer(tree, tcfg, frame_buckets=(6,),
                                     max_batch=3, device="cpu",
                                     compute_dtype=torch.bfloat16)
    assert server.model.first_conv.v.dtype == torch.bfloat16
    want = jax_server.synthesize(requests, speaker_ids=spk)
    got = server.synthesize(requests, speaker_ids=spk)
    c, g = server.padded_batch(requests, spk, 6)
    outs, emitted = server.generate_batch(c, g)
    assert outs.dtype == torch.float32
    agree = 0
    for row, (gw, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gw.wave, emitted[row, :len(gw.wave)])
        diff = np.flatnonzero(gw.wave != w.wave)
        if len(diff):
            top2 = np.sort(outs[row, diff[0]].numpy())[-2:]
            assert top2[1] - top2[0] <= BF16_NEAR_TIE, (row, diff[0], top2)
        agree += diff[0] if len(diff) else len(gw.wave)
    assert agree >= 24          # the streams agree well past their start


def test_oversize_request_rejected():
    _, tree, _, tcfg = vocoder(VOCODER_KW)
    server = BucketedSynthesisServer(tree, tcfg, frame_buckets=(6,),
                                     device="cpu")
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        server.synthesize(conds([7]))
