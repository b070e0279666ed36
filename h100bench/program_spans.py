"""The program's own spans (``utils/profiling.annotate``), read in one short
segment of a cell's calls, for the per-layer metrics of ``source``
``program_span``.

The segment runs after the harness's own trace, when the first such reader
asks, and is kept on the cell (``cell.program_spans``), so that every reader
of a cell reads the same calls. The driver's ``Cell`` says what they are:
``SEGMENT_CALLS``, their number, and ``drive_segment(n)``, which makes n of
them (6 chunks of the AR loop, 20 train steps or 12 encode launches in the
drivers here). It drives them twice:

(a) spans on (``profiling.record_spans``), no profiler: each span's host
    duration;
(b) spans on inside ``profiling.trace(None)``: CUDA activity alone, which
    brings each launch call's record with it, on the spans' clock. A region
    whose sentinels the profiler lost raises and is driven again, with the
    next n calls, up to ``TAKES`` times in all (``program_segment_retaken``
    counts the regions lost). Each
    kernel, copy or fill is charged to the innermost main-thread span whose
    interval holds its launch call (not to the span that runs while the
    device runs it: autograd's device thread launches the backward's
    kernels while the main thread waits in ``train.backward``). Each idle
    gap of the device, between the segment's first and last record, goes to
    the innermost span at its middle (``outside_spans`` where none is open).
    The device's stamps are the profiler's, converted to the host's clock
    with an error that drifts within a segment, so the middles are taken as
    they are; a record stamped before its own launch call shows the error
    at least, and the largest such lead of the segment is noted
    (``program_device_clock_lead_us``; on an H100 with torch 2.11 from
    -8 us, none, to 4.3 ms).

Device work launched outside every span, or whose launch call has no record,
is unattributed; its share of the segment's device time is noted beside the
compared numbers (``program_unattributed_share``), with the idle by span
(``program_idle_by_span``, ms over the segment), the device ms a call by
span and the median host ms by span. A cell without the two hooks, a
program without spans (no ``record_spans`` in ``utils/profiling``) or a run
without a card gives no segment, and its readers None.
"""
import bisect
import statistics
import threading

OUTSIDE = "outside_spans"
TAKES = 3


class Attribution:
    """Where the device's time and idle went over a segment's records, by
    the innermost span of ``thread``: ``device_ms`` and ``idle_ms`` by span
    name (what lies outside every span, or was launched by a call with no
    record, under ``OUTSIDE``), and ``lead_ns``, the most by which a
    record's device stamp precedes its own launch call (None without launch
    records)."""

    def __init__(self, spans, records, thread):
        own = [(i, s) for i, s in enumerate(spans) if s.thread == thread]
        own.sort(key=lambda p: p[1].start_ns)
        at = {i: k for k, (i, _) in enumerate(own)}
        self._spans = [s for _, s in own]
        self._starts = [s.start_ns for s in self._spans]
        self._parent = [at.get(s.parent, -1) for s in self._spans]
        self.device_ms, self.idle_ms = {}, {}
        for r in records:
            name = (r.launch_ns is not None and self.innermost(r.launch_ns)
                    or OUTSIDE)
            self.device_ms[name] = (self.device_ms.get(name, 0.0)
                                    + 1e-6 * (r.end_ns - r.start_ns))
        leads = [r.launch_ns - r.start_ns for r in records
                 if r.launch_ns is not None]
        self.lead_ns = max(leads) if leads else None
        end = None
        for r in sorted(records, key=lambda r: r.start_ns):
            if end is not None and r.start_ns > end:
                name = self.innermost(0.5 * (r.start_ns + end)) or OUTSIDE
                self.idle_ms[name] = (self.idle_ms.get(name, 0.0)
                                      + 1e-6 * (r.start_ns - end))
            end = r.end_ns if end is None else max(end, r.end_ns)

    def innermost(self, t):
        """The name of the innermost span that holds time ``t``, or None."""
        k = bisect.bisect_right(self._starts, t) - 1
        while k >= 0:
            span = self._spans[k]
            if span.end_ns is not None and span.end_ns >= t:
                return span.name
            k = self._parent[k]
        return None

    @property
    def unattributed_share(self):
        total = sum(self.device_ms.values())
        return self.device_ms.get(OUTSIDE, 0.0) / total if total else None


class Segment:
    """A cell's segment: ``calls``, ``host_ms`` (each span's host durations
    in (a), by name) and ``attribution`` ((b)'s ``Attribution``)."""

    def __init__(self, calls, host_ms, attribution):
        self.calls, self.host_ms = calls, host_ms
        self.attribution = attribution

    def median_host_ms(self, name):
        got = self.host_ms.get(name)
        return statistics.median(got) if got else None

    def device_ms_a_call(self, name):
        ms = self.attribution.device_ms.get(name)
        return None if ms is None else ms / self.calls


def segment(cell):
    """The cell's segment, run on the first call and kept on the cell; None
    for a cell without ``SEGMENT_CALLS`` and ``drive_segment``, without a
    card or against a program without spans."""
    if not hasattr(cell, "program_spans"):
        cell.program_spans = _run(cell)
    return cell.program_spans


def _run(cell):
    import torch

    from vqvae_speech_tpu_torch.utils import profiling

    n = getattr(cell, "SEGMENT_CALLS", None)
    drive = getattr(cell, "drive_segment", None)
    if (n is None or drive is None or cell.dev.type != "cuda"
            or not hasattr(profiling, "record_spans")):
        return None
    torch.cuda.synchronize()
    with profiling.record_spans() as spans:
        drive(n)
    torch.cuda.synchronize()
    host_ms = {}
    for s in spans:
        if s.end_ns is not None:
            host_ms.setdefault(s.name, []).append(
                1e-6 * (s.end_ns - s.start_ns))
    lost = 0
    while True:
        before = len(profiling.RETAKEN)
        try:
            with profiling.trace(None) as traced:
                drive(n)
            break
        except RuntimeError:
            if len(profiling.RETAKEN) == before or lost + 1 == TAKES:
                raise
            lost += 1
    att = Attribution(traced.spans, traced.records, threading.get_ident())
    seg = Segment(n, host_ms, att)
    note = cell.ctx.note
    note("program_segment_retaken", lost)
    note("program_span_counts", {k: len(v)
                                 for k, v in sorted(host_ms.items())})
    note("program_idle_by_span", dict(sorted(att.idle_ms.items())))
    note("program_unattributed_share", att.unattributed_share)
    if att.lead_ns is not None:
        note("program_device_clock_lead_us", 1e-3 * att.lead_ns)
    note("program_device_ms_by_span", {
        k: v / n for k, v in sorted(att.device_ms.items())})
    note("program_host_ms_by_span", {k: statistics.median(v)
                                     for k, v in sorted(host_ms.items())})
    return seg
