"""Device time and kernel counts of a call, from torch.profiler's CUDA
activity, guarded against the device events the profiler loses; ``trace``
and ``annotate``, a Chrome trace of a region and a named span in it; and
``StepTimer``, the trainer's per-step timing (counterparts of the JAX
package's ``utils/profiling.py``)."""
import contextlib
import os
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


class Trace:
    """What ``trace`` recorded, filled in when its region ends: the Chrome
    trace's ``path`` and, on a card, the region's device ``events``."""

    def __init__(self):
        self.path: Optional[str] = None
        self.events: List[DeviceEvent] = []


@contextlib.contextmanager
def trace(logdir: str):
    """Write a Chrome trace (``trace_<ns>.json`` under ``logdir``, for
    chrome://tracing or Perfetto) of the enclosed region; yields a
    ``Trace``.

    In a process with a card the window records CUDA activity and is opened
    and closed by the sentinel runs of ``device_events``; a region whose
    lead or tail sentinels the profiler lost raises on exit, since its
    device records cannot be trusted (a region, unlike a function, cannot be
    taken again). Without a card it records the host's activity alone."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    out = Trace()
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    if not torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield out
        prof.export_chrome_trace(path)
        out.path = path
        return
    with _window(LEADS, SPAN, TAIL_SHARE,
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]) as got:
        yield out
    w = got["window"]
    got["prof"].export_chrome_trace(path)
    out.path, out.events = path, w.events
    if not (w.leads_seen and w.tails_seen):
        seen = (w.leads_seen, w.leads, w.tails_seen, w.tails, len(w.events))
        RETAKEN.append(seen + (False,))
        raise RuntimeError(
            f"torch.profiler lost device events in the traced region ({path}):"
            f" (lead sentinels seen, launched, tail sentinels seen, launched,"
            f" other device events) {seen}")


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return torch.profiler.record_function(name)


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
