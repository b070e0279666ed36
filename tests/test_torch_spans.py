"""PyTorch port: the program's spans (``utils/profiling.annotate``) and where
the servers and the train step open them, on the CPU at tiny sizes.

Spans nest by thread with their parents and ids; off, ``annotate`` records
nothing and hands back one shared no-op context; ``trace`` returns the
region's spans. ``ContinuousSynthesisServer`` opens one ``ar.admit`` a
request and one ``ar.decode_chunk`` a ``step()``, the train step one
``train.forward``, ``train.backward`` and ``train.optimizer`` a step, the
encode server one ``encode.features`` an ``encode_batch``; what each
computes is bit-equal with spans on and off. The server's raw slot counts
are held to the benchmark's own count over a window of its tiny AR cell.
"""
import copy
import threading

import numpy as np
import pytest
import torch

from vqvae_speech_tpu_torch.convert import numpy_params, numpy_wavenet_params
from vqvae_speech_tpu_torch.models.conv_vqvae import ConvVQVAE
from vqvae_speech_tpu_torch.models.wavenet import WaveNetConfig
from vqvae_speech_tpu_torch.serve import (
    BucketedEncodeServer,
    ContinuousSynthesisServer,
)
from vqvae_speech_tpu_torch.train import trainer
from vqvae_speech_tpu_torch.utils import profiling
from vqvae_speech_tpu_torch.utils.profiling import (
    annotate,
    record_spans,
    trace,
)

WAVENET_KW = dict(out_channels=32, layers=4, stacks=2, residual_channels=8,
                  gate_channels=8, skip_out_channels=8, kernel_size=2,
                  cin_channels=4, gin_channels=-1,
                  upsample_conditional_features=True, upsample_scales=(2, 2))
CONV_CFG = dict(
    input_features_type="mfcc", input_features_filters=13,
    augment_input_features=True, output_features_filters=13,
    augment_output_features=True, sampling_rate=16000, num_hiddens=16,
    num_residual_layers=2, residual_channels=16, embedding_dim=4,
    num_embeddings=5, commitment_cost=0.25, decay=0.0,
    use_kaiming_normal=False, use_jitter=False, jitter_probability=0.12,
    use_speaker_conditioning=False, learning_rate=2e-4)


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_spans_nest_by_thread_with_parents_and_ids():
    def worker():
        with annotate("other", 7):
            pass

    with record_spans() as spans:
        with annotate("outer", 3):
            with annotate("inner"):
                with annotate("leaf", 1):
                    pass
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(10)
            with annotate("inner"):
                pass
    assert not thread.is_alive()
    assert [s.name for s in spans] == ["outer", "inner", "leaf", "other",
                                       "inner"]
    outer, inner, leaf, other, again = spans
    assert (outer.parent, inner.parent, leaf.parent, again.parent) == (
        -1, 0, 1, 0)
    assert other.parent == -1 and other.thread != outer.thread
    assert [s.id for s in spans] == [3, None, 1, 7, None]
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= inner.start_ns and leaf.end_ns <= inner.end_ns
    assert again.end_ns <= outer.end_ns


def test_nothing_recorded_when_off():
    assert annotate("a") is annotate("b", 2) is profiling._OFF
    with annotate("a", 1):
        pass
    with record_spans() as spans:
        pass
        with pytest.raises(RuntimeError, match="already"):
            with record_spans():
                pass
    assert spans == []
    assert annotate("a") is profiling._OFF


def test_trace_on_the_cpu_returns_the_programs_spans():
    with trace(None) as t:
        with annotate("port.region", 5):
            torch.ones(8).cumsum(0)
    assert t.path is None and t.records == [] and t.events == []
    assert [(s.name, s.id, s.parent) for s in t.spans] == [
        ("port.region", 5, -1)]
    assert annotate("x") is profiling._OFF


def _conds(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 4)).astype(np.float32) for n in lengths]


def test_ar_server_spans_and_streams_with_spans_on_and_off():
    cfg = WaveNetConfig(**WAVENET_KW)
    tree = numpy_wavenet_params(cfg, 0)
    requests = _conds([5, 2, 6, 3, 4], seed=1)
    servers = [ContinuousSynthesisServer(tree, cfg, slots=3, chunk_size=5,
                                         max_frames=6, device="cpu")
               for _ in range(2)]
    want = servers[0].run(requests)
    server = servers[1]
    with record_spans() as spans:
        got = server.run(requests)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.wave, b.wave)
    launches = server.stats["launches"]
    steps = by_name(spans, "ar.step")
    assert [s.id for s in steps] == list(range(launches))
    assert sorted(s.id for s in by_name(spans, "ar.admit")) == list(range(5))
    for name in ("ar.decode_chunk", "ar.retire"):
        assert len(by_name(spans, name)) == launches
    step_index = {i for i, s in enumerate(spans) if s.name == "ar.step"}
    for name in ("ar.admit", "ar.decode_chunk", "ar.retire"):
        assert all(s.parent in step_index for s in by_name(spans, name))
    # one (slots, chunk) launch a step; every sample of every request counted
    st = server.stats
    assert st["slot_steps"] == launches * 3 * 5
    assert st["busy_slot_steps"] == sum(4 * len(c) for c in requests)
    assert st["slot_utilization"] == round(
        st["busy_slot_steps"] / st["slot_steps"], 4)


def _train_pair():
    cfg = dict(CONV_CFG, input_features_dim=24, output_features_dim=24)
    torch.manual_seed(0)
    model = ConvVQVAE.from_config(cfg)
    optimizer = trainer.make_optimizer(cfg["learning_rate"])
    states = [trainer.create_train_state(m, optimizer, device="cpu", seed=3)
              for m in (model, copy.deepcopy(model))]
    gen = torch.Generator().manual_seed(4)
    batches = [{"input_features": x, "output_features": x}
               for x in torch.randn((2, 3, 24, 39), generator=gen)]
    return trainer.make_train_step(cfg, optimizer), states, batches


def test_train_step_spans_and_state_with_spans_on_and_off():
    step, (off, on), batches = _train_pair()
    for batch in batches:
        off, _ = step(off, batch)
    with record_spans() as spans:
        for batch in batches:
            on, _ = step(on, batch)
    steps = by_name(spans, "train.step")
    assert [s.id for s in steps] == [0, 1]
    for name in ("train.forward", "train.backward", "train.optimizer"):
        got = by_name(spans, name)
        assert len(got) == 2
        assert [spans[s.parent].name for s in got] == ["train.step"] * 2
    for a, b in zip(off.model.state_dict().values(),
                    on.model.state_dict().values()):
        assert torch.equal(a, b)
    for moments in ("mu", "nu", "nu_max"):
        for a, b in zip(getattr(off.opt_state, moments),
                        getattr(on.opt_state, moments)):
            assert torch.equal(a, b)
    assert off.opt_state.count == on.opt_state.count == 2


def test_encode_batch_spans_and_codes_with_spans_on_and_off():
    params, state = numpy_params(CONV_CFG, 5)
    server = BucketedEncodeServer(params, state, CONV_CFG,
                                  wave_buckets=(800, 1600), max_batch=2,
                                  device="cpu")
    gen = torch.Generator().manual_seed(6)
    waves = [0.1 * torch.randn((2, b), generator=gen) for b in (800, 1600)]
    off = [server.encode_batch(w) for w in waves]
    with record_spans() as spans:
        on = [server.encode_batch(w) for w in waves]
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    batches = by_name(spans, "encode.batch")
    features = by_name(spans, "encode.features")
    assert len(batches) == len(features) == 2
    assert all(spans[s.parent].name == "encode.batch" for s in features)


def test_slot_counts_over_a_window_of_the_tiny_ar_cell():
    from h100bench import harness
    from h100bench.tests import tiny

    torch.manual_seed(0)
    ctx = harness.Context("wavenet-ar-c64", tiny.SEED, "cpu",
                          tiny.OVERRIDES["wavenet-ar-c64"])
    cell = harness.driver(ctx.traffic["kind"]).Cell(ctx)
    cell.setup()
    before = cell.server.stats
    cell.window(0.3)
    after = cell.server.stats
    assert cell.rec["samples"] > 0
    assert (after["busy_slot_steps"] - before["busy_slot_steps"]
            == cell.rec["samples"])
    assert after["slot_steps"] - before["slot_steps"] == cell.rec["slot_steps"]
