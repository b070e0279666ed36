"""Device time and kernel counts of a call, from torch.profiler's CUDA
activity, guarded against the device events the profiler loses; the
program's spans (``annotate``), recorded in memory while ``record_spans`` or
``trace`` is open; ``trace``, a region's spans, device records and Chrome
trace; and ``StepTimer``, the trainer's per-step timing (counterparts of the
JAX package's ``utils/profiling.py``)."""
import contextlib
import os
import threading
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# Sentinel kernels mark a window: launches of torch.erfinv_ before the
# profiled call and of torch.digamma_ after it, a sync after each, at least
# LEADS of each and for at least SPAN seconds (the tail for at least
# TAIL_SHARE of the call's time if that is longer). Nothing else in this
# package launches either.
_LEAD, _TAIL = "erfinv", "digamma"
LEADS, SPAN, TAIL_SHARE, WINDOWS = 8, 5e-3, 5e-2, 8
# one entry a window that did not count, in every device_events call of the
# process: (lead sentinels seen, launched, tail sentinels seen, launched,
# other device events, whether they added up)
RETAKEN: List[tuple] = []


class DeviceEvent(NamedTuple):
    key: str        # kernel name (or Memcpy/Memset)
    us: float       # device microseconds, summed over its launches
    count: int      # launches


class Window(NamedTuple):
    seconds: float              # host seconds of fn up to its device work's end
    events: List[DeviceEvent]   # fn's device events
    leads_seen: int
    leads: int                  # lead sentinels launched
    tails_seen: int
    tails: int                  # tail sentinels launched


def _sentinels(launch: Callable[[], object], count: int, span: float) -> int:
    """Launches ``launch``, a sync after each, ``count`` times and on until
    ``span`` seconds have passed; returns how many launched."""
    t0, n = time.perf_counter(), 0
    while n < count or time.perf_counter() - t0 < span:
        launch()
        torch.cuda.synchronize()
        n += 1
    return n


@contextlib.contextmanager
def _window(leads: int, span: float, tail_share: float, activities):
    """A profiler window around the body, opened and closed by sentinel
    runs; yields a dict that holds, once the body is done, the ``Window``
    and the profiler (``"window"``, ``"prof"``). With host activity
    recorded too, the host's operators (which carry the device time of the
    kernels they launched) are left out of the events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mark = torch.full((8,), 0.5, device="cuda")
    torch.cuda.synchronize()
    got = {}
    with profile(activities=activities) as prof:
        n_leads = _sentinels(mark.erfinv_, leads, span)
        t0 = time.perf_counter()
        yield got
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        n_tails = _sentinels(mark.digamma_, leads,
                             max(span, tail_share * window))
    host = ProfilerActivity.CPU in activities
    events, leads_seen, tails_seen = [], 0, 0
    for e in prof.key_averages():
        if not e.self_device_time_total > 0:
            continue
        if host and e.device_type == DeviceType.CPU:
            continue
        if _LEAD in e.key:
            leads_seen += e.count
        elif _TAIL in e.key:
            tails_seen += e.count
        else:
            events.append(DeviceEvent(e.key, e.self_device_time_total,
                                      e.count))
    got["window"] = Window(window, events, leads_seen, n_leads, tails_seen,
                           n_tails)
    got["prof"] = prof


def one_window(fn: Callable[[], object], leads: int = LEADS,
               span: float = SPAN, tail_share: float = TAIL_SHARE) -> Window:
    """One profiler window around ``fn``, opened and closed by sentinel runs
    of at least ``leads`` launches and ``span`` seconds (the closing one at
    least ``tail_share`` of ``fn``'s time). No retake, no check:
    ``device_events`` is the entry point; this one serves it and
    scripts/profiler_window_probe.py."""
    from torch.profiler import ProfilerActivity

    with _window(leads, span, tail_share, [ProfilerActivity.CUDA]) as got:
        fn()
    return got["window"]


def device_events(fn: Callable[[], object],
                  check: Optional[Callable[[List[DeviceEvent]], bool]] = None
                  ) -> Tuple[float, List[DeviceEvent]]:
    """(host seconds of ``fn``, everything that ran on the device meanwhile).

    A bare window is not to be trusted. The profiler's library (Kineto)
    drops every device record whose timestamp, converted to the host's
    clock, falls outside the window's host-clock range (its own log, with
    KINETO_LOG_LEVEL=0, counts them as "Out-of-range"), and on an NVIDIA
    H100 with torch 2.11 those converted timestamps stray: kernels are
    stamped up to ~0.85 ms before their own launch in a window of 100000
    launches (scripts/profiler_window_probe.py --long). So the first device
    kernels of a window go missing (1 to 16 of them in runs of
    chip_smoke.py, at times all of a 2 ms run), and at times the last ones:
    every closing sentinel of a two-second window, 10 ms of them once, and
    K2 launches with them; the last 2041 launches of a one-second window
    and the 10 ms of sentinels after them. So the window opens with a run of sentinel kernels that
    takes the loss at its start and closes with a run of another kind that
    takes it at its end, each of at least ``LEADS`` launches and ``SPAN``
    seconds, the closing one at least ``TAIL_SHARE`` of ``fn``'s time. It
    counts only if a lead sentinel shows, so that the loss ended before
    ``fn`` began, and a tail sentinel shows, so that the profiler was still
    recording after ``fn``. A caller that knows how often ``fn`` launches
    some kernel passes ``check``, which sees the events and says whether
    they add up. Any window that does not count is noted in ``RETAKEN`` and
    taken again with both runs twice as long, ``WINDOWS`` times in all, and
    then this raises: what callers print from here is a measurement, never
    a blank. ``fn`` may so run more than once."""
    seen, leads, span = [], LEADS, SPAN
    for _ in range(WINDOWS):
        w = one_window(fn, leads, span)
        added_up = bool(w.events) and (check is None or check(w.events))
        if w.leads_seen and w.tails_seen and added_up:
            return w.seconds, w.events
        seen.append((w.leads_seen, w.leads, w.tails_seen, w.tails,
                     len(w.events), added_up))
        RETAKEN.append(seen[-1])
        leads, span = 2 * leads, 2 * span
    raise RuntimeError(
        f"torch.profiler lost device events in {WINDOWS} windows running: "
        f"(lead sentinels seen, launched, tail sentinels seen, launched, "
        f"other device events, whether they added up) {seen}")


class Span(NamedTuple):
    """One span of the program, as ``annotate`` records it. Its stamps are
    ``time.time_ns()``, the clock torch.profiler converts its time stamps
    to, so a span and the host call that launched a kernel compare directly
    (the kernels' own converted stamps stray from that clock: on an NVIDIA
    H100 with torch 2.11, from 4 us after their launch calls to 4.3 ms
    before them)."""
    name: str
    start_ns: int
    end_ns: Optional[int]   # None: still open when the record was taken
    parent: int             # index of the enclosing span of its thread, or -1
    id: Optional[int]       # request id, step or launch index, or None
    thread: int


class _Recording:
    """The spans of one ``record_spans`` region: rows in the order they
    opened, and a stack of open rows a thread."""

    def __init__(self):
        self.rows: List[list] = []
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> List[int]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDING: Optional[_Recording] = None
_OFF = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("_rec", "_name", "_id", "_row", "_rf")

    def __init__(self, rec: _Recording, name: str, id: Optional[int]):
        self._rec, self._name, self._id = rec, name, id

    def __enter__(self):
        rec = self._rec
        stack = rec.stack()
        row = [self._name, 0, None, stack[-1] if stack else -1, self._id,
               threading.get_ident()]
        with rec.lock:
            stack.append(len(rec.rows))
            rec.rows.append(row)
        self._row, self._rf = row, None
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        row[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._row[2] = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._rec.stack().pop()
        return False


def annotate(name: str, id: Optional[int] = None):
    """The program's span around the enclosed code: ``name``, its start and
    end, the span open around it on its thread, and ``id`` (a request id,
    step or launch index, shared by one request's spans).

    Off (no ``record_spans`` or ``trace`` region open, the default) it
    returns one shared no-op context and records nothing. On, it keeps the
    span in memory and, while a torch.profiler runs, opens a
    ``record_function(name)`` too, so that Chrome traces show it."""
    rec = _RECORDING
    if rec is None:
        return _OFF
    return _OpenSpan(rec, name, id)


@contextlib.contextmanager
def record_spans():
    """Turns the program's spans on for the enclosed region; yields a list
    that holds them (``Span``, in the order they opened) once the region
    ends. Regions do not nest: opening one inside another raises."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("the program's spans are being recorded already")
    rec = _RECORDING = _Recording()
    spans: List[Span] = []
    try:
        yield spans
    finally:
        _RECORDING = None
        spans.extend(Span(*row) for row in rec.rows)


class DeviceRecord(NamedTuple):
    """A kernel, copy or fill the device ran, on the spans' clock, with the
    host stamp of the runtime or driver call that launched it (None where
    the profiler gave no such record)."""
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]


def _device_records(prof) -> List[DeviceRecord]:
    """The window's device work, its sentinels left out, each record joined
    to its launch call by the correlation id the two share. The launch calls
    are the host records of the CUDA runtime and driver APIs (``cuda...``,
    ``cu...``); the profiler's own host records (module loading, buffer
    requests) share the id too and are left out by name; of a runtime call
    and the driver call inside it, the outer one's stamp is kept."""
    from torch.autograd import DeviceType

    launches, work = {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith("cu"):
                c = e.correlation_id()
                launches[c] = min(launches.get(c, e.start_ns()), e.start_ns())
        elif not (_LEAD in name or _TAIL in name or e.is_user_annotation()):
            work.append((e.correlation_id(), name, e.start_ns(), e.end_ns()))
    return sorted((DeviceRecord(name, start, end, launches.get(c))
                   for c, name, start, end in work), key=lambda r: r.start_ns)


class Trace:
    """What ``trace`` recorded, filled in when its region ends: the Chrome
    trace's ``path`` (None when none was written), the program's ``spans``
    and, on a card, the region's device ``events`` (summed by name) and
    ``records`` (one a kernel, copy or fill)."""

    def __init__(self):
        self.path: Optional[str] = None
        self.spans: List[Span] = []
        self.events: List[DeviceEvent] = []
        self.records: List[DeviceRecord] = []


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Record the enclosed region: the program's spans and, with a
    ``logdir``, a Chrome trace (``trace_<ns>.json`` under it, for
    chrome://tracing or Perfetto); yields a ``Trace``.

    In a process with a card the window records CUDA activity, which brings
    each launch call's record with it, and is opened and closed by the
    sentinel runs of ``device_events``; with a ``logdir`` it records the
    host's operators too, for the file. A region whose lead or tail
    sentinels the profiler lost raises on exit, since its device records
    cannot be trusted (a region, unlike a function, cannot be taken again).
    Without a card it records the host's activity alone."""
    from torch.profiler import ProfilerActivity, profile

    out = Trace()
    path = None
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    with record_spans() as out.spans:
        if not torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                yield out
            if path is not None:
                prof.export_chrome_trace(path)
                out.path = path
            return
        activities = [ProfilerActivity.CUDA]
        if path is not None:
            activities.insert(0, ProfilerActivity.CPU)
        with _window(LEADS, SPAN, TAIL_SHARE, activities) as got:
            yield out
    w, prof = got["window"], got["prof"]
    if path is not None:
        prof.export_chrome_trace(path)
        out.path = path
    out.events, out.records = w.events, _device_records(prof)
    if not (w.leads_seen and w.tails_seen):
        seen = (w.leads_seen, w.leads, w.tails_seen, w.tails, len(w.events))
        RETAKEN.append(seen + (False,))
        raise RuntimeError(
            f"torch.profiler lost device events in the traced region ({path}):"
            f" (lead sentinels seen, launched, tail sentinels seen, launched,"
            f" other device events) {seen}")


class StepTimer:
    """Honest per-step timing: waits for the step's device work before
    stamping.

    Usage:
        timer = StepTimer()
        for batch in loader:
            with timer.step():
                state, metrics = train_step(state, batch)
                timer.block_on(metrics)
        print(timer.summary())
    """

    def __init__(self, window: int = 200):
        self._times = deque(maxlen=window)

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self._times.append(time.perf_counter() - t0)

    def block_on(self, metrics: dict):
        """``torch.cuda.synchronize`` on the device of the metrics' tensors
        (nothing to wait for on the CPU)."""
        for value in metrics.values():
            if value.device.type == "cuda":
                torch.cuda.synchronize(value.device)
            return

    @property
    def num_steps(self):
        return len(self._times)

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
