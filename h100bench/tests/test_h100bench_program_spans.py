"""``h100bench/program_spans.py`` and the readers of ``source``
``program_span``: the attribution on records made by hand; on the tiny cells
on the CPU, the segment's calls (the driver's ``drive_segment``) go through
the program's spans and every reader returns None; against a program
without spans, or a cell without the segment's hooks, no segment."""
from types import SimpleNamespace

import pytest
import torch

from h100bench import harness, program_spans
from h100bench.tests import tiny
from vqvae_speech_tpu_torch.utils.profiling import DeviceRecord, Span

# the cells' readers of the program's spans
READERS = {"wavenet-ar-c64": ("admit_ms.ar", "admit_idle_share.ar"),
           "vq44-train-b64": ("forward_ms.train", "backward_ms.train",
                              "optimizer_ms.train"),
           "vq44-encode-bulk": ("features_ms.encode", "enqueue_ms.encode")}
# the spans each of the segment's calls opens once
OPENS = {"wavenet-ar-c64": ("ar.step", "ar.decode_chunk", "ar.retire"),
         "vq44-train-b64": ("train.step", "train.forward", "train.backward",
                            "train.optimizer"),
         "vq44-encode-bulk": ("encode.batch", "encode.features")}


def test_every_reader_is_a_program_span_metric_of_its_cell():
    entries = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for workload, names in READERS.items():
        for name in names:
            assert entries[name]["source"] == "program_span"
            assert entries[name]["workloads"] == [workload]


def test_attribution_by_launch_call_and_idle_middle():
    main, other = 1, 2
    spans = [Span("train.step", 0, 100, -1, 0, main),
             Span("train.forward", 10, 40, 0, None, main),
             Span("elsewhere", 0, 1000, -1, None, other),
             Span("train.backward", 40, 90, 0, None, main),
             Span("train.optimizer", 92, 99, 0, None, main)]
    records = [
        DeviceRecord("fwd", 50, 60, 15),                  # forward
        DeviceRecord("bwd", 60, 80, 45),                  # launched in bwd
        DeviceRecord("step", 91, 92, 91),                 # step's own
        DeviceRecord("opt", 96, 106, 96),
        DeviceRecord("lost", 106, 108, None),             # no launch record
        DeviceRecord("late", 230, 234, 230)]              # outside
    att = program_spans.Attribution(spans, records, main)
    got = {k: round(v * 1e6) for k, v in att.device_ms.items()}
    assert got == {"train.forward": 10, "train.backward": 20,
                   "train.step": 1, "train.optimizer": 10,
                   program_spans.OUTSIDE: 6}
    # gaps 80-91 (middle 85.5: backward), 92-96 (94: optimizer),
    # 108-230 (169: outside)
    idle = {k: round(v * 1e6, 1) for k, v in att.idle_ms.items()}
    assert idle == {"train.backward": 11.0, "train.optimizer": 4.0,
                    program_spans.OUTSIDE: 122.0}
    assert att.unattributed_share == pytest.approx(6 / 47)
    assert att.lead_ns == 0
    assert att.innermost(41) == "train.backward"
    assert att.innermost(91) == "train.step"
    assert att.innermost(-1) is None


def test_a_record_stamped_before_its_launch_shows_the_clocks_lead():
    """k2 reads 3 before its launch call: the lead is noted, and the gap
    20-30 is charged at its middle as stamped, in ``a``."""
    spans = [Span("a", 0, 26, -1, None, 1), Span("b", 26, 60, -1, None, 1)]
    records = [DeviceRecord("k1", 10, 20, 13),
               DeviceRecord("k2", 30, 40, 33),
               DeviceRecord("k3", 50, 55, None)]
    att = program_spans.Attribution(spans, records, 1)
    assert att.lead_ns == 3
    assert att.idle_ms == {"a": pytest.approx(1e-5),
                           "b": pytest.approx(1e-5)}
    assert att.device_ms == {"a": pytest.approx(1e-5),
                             "b": pytest.approx(1e-5),
                             program_spans.OUTSIDE: pytest.approx(5e-6)}


def _cell(workload):
    torch.manual_seed(0)
    ctx = harness.Context(workload, tiny.SEED, "cpu",
                          tiny.OVERRIDES[workload])
    cell = harness.driver(ctx.traffic["kind"]).Cell(ctx)
    cell.setup()
    if workload == "vq44-encode-bulk":
        cell.codes = {}
    return cell


@pytest.mark.parametrize("workload", sorted(OPENS))
def test_segment_calls_open_the_programs_spans_and_readers_give_none(
        workload):
    from vqvae_speech_tpu_torch.utils.profiling import record_spans

    cell = _cell(workload)
    with record_spans() as spans:
        cell.drive_segment(cell.SEGMENT_CALLS)
    for name in OPENS[workload]:
        assert sum(s.name == name for s in spans) == cell.SEGMENT_CALLS, name
    for name in READERS[workload]:
        assert harness.reader(name).read(cell, None) is None, name
    assert cell.program_spans is None


def test_no_segment_against_a_program_without_spans(monkeypatch):
    from vqvae_speech_tpu_torch.utils import profiling

    class Cell:
        dev = torch.device("cuda")

    monkeypatch.delattr(profiling, "record_spans")
    cell = Cell()
    assert program_spans.segment(cell) is None
    assert harness.reader("forward_ms.train").read(cell, None) is None


def test_no_segment_for_a_cell_without_the_hooks():
    """A driver that gives no ``SEGMENT_CALLS`` and ``drive_segment`` gets
    no segment, on a card as well, and its readers None."""

    class Cell:
        dev = torch.device("cuda")

    cell = Cell()
    assert program_spans.segment(cell) is None
    assert harness.reader("admit_ms.ar").read(cell, None) is None


class _Ctx:
    def __init__(self):
        self.notes = {}

    def note(self, name, value):
        self.notes[name] = value


class _Counting:
    """A cell whose segment calls open one span each; its ``dev`` claims a
    card so that the segment runs on the CPU (its syncs patched out)."""
    SEGMENT_CALLS = 2

    def __init__(self):
        self.ctx, self.calls = _Ctx(), 0
        self.dev = SimpleNamespace(type="cuda")

    def drive_segment(self, n):
        from vqvae_speech_tpu_torch.utils.profiling import annotate
        for _ in range(n):
            with annotate("stub.call"):
                self.calls += 1


def _lose_regions(monkeypatch, lost, error="sentinels"):
    """``profiling.trace`` loses its first ``lost`` regions as a lost
    sentinel run does (noted in RETAKEN, then raising), or raises another
    error."""
    import contextlib

    from vqvae_speech_tpu_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, "RETAKEN", [])
    orig, taken = profiling.trace, []

    @contextlib.contextmanager
    def trace(logdir):
        with orig(logdir) as out:
            yield out
        taken.append(1)
        if len(taken) <= lost:
            if error == "sentinels":
                profiling.RETAKEN.append((0, 1, 1, 1, 0, False))
            raise RuntimeError("lost")
    monkeypatch.setattr(profiling, "trace", trace)


def test_a_region_the_profiler_lost_is_driven_again(monkeypatch):
    _lose_regions(monkeypatch, 1)
    cell = _Counting()
    seg = program_spans.segment(cell)
    assert seg.calls == 2 and len(seg.host_ms["stub.call"]) == 2
    assert cell.calls == 2 + 2 * 2
    assert cell.ctx.notes["program_segment_retaken"] == 1
    assert cell.ctx.notes["program_span_counts"] == {"stub.call": 2}


def test_the_segment_raises_past_its_takes_or_on_another_error(monkeypatch):
    _lose_regions(monkeypatch, program_spans.TAKES)
    with pytest.raises(RuntimeError):
        program_spans.segment(_Counting())
    _lose_regions(monkeypatch, 1, error="other")
    cell = _Counting()
    with pytest.raises(RuntimeError):
        program_spans.segment(cell)
    assert cell.calls == 2 + 2
