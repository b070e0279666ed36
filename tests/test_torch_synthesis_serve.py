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


@pytest.mark.parametrize("kwargs", [{"compute_dtype": torch.bfloat16},
                                    {"weight_quant": "int8"},
                                    {"mesh": object()}])
def test_unported_options_raise(kwargs):
    _, tree, _, tcfg = vocoder(VOCODER_KW)
    with pytest.raises(NotImplementedError):
        BucketedSynthesisServer(tree, tcfg, device="cpu", **kwargs)


def test_oversize_request_rejected():
    _, tree, _, tcfg = vocoder(VOCODER_KW)
    server = BucketedSynthesisServer(tree, tcfg, frame_buckets=(6,),
                                     device="cpu")
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        server.synthesize(conds([7]))
