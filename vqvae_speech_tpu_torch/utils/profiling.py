"""Device time and kernel counts of a call, from torch.profiler's CUDA
activity, guarded against the device events the profiler loses."""
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

# Sentinel kernels mark a window: launches of torch.erfinv_ before the
# profiled call, a sync after each, and one of torch.digamma_ after the
# call. Nothing else in this package launches either.
_LEAD, _TAIL = "erfinv", "digamma"
LEADS, WINDOWS = 8, 5


class DeviceEvent(NamedTuple):
    key: str        # kernel name (or Memcpy/Memset)
    us: float       # device microseconds, summed over its launches
    count: int      # launches


def one_window(fn: Callable[[], object], leads: int = LEADS
               ) -> Tuple[float, List[DeviceEvent], int, int]:
    """One profiler window around ``fn``: (host seconds of ``fn`` up to the
    end of its device work, its device events, lead sentinels seen of
    ``leads``, tail sentinels seen of 1). No retake, no check:
    ``device_events`` is the entry point; this one serves it and
    scripts/profiler_window_probe.py."""
    from torch.profiler import ProfilerActivity, profile

    mark = torch.full((8,), 0.5, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(leads):
            mark.erfinv_()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        mark.digamma_()
        torch.cuda.synchronize()
    events, leads_seen, tail_seen = [], 0, 0
    for e in prof.key_averages():
        if not e.self_device_time_total > 0:
            continue
        if _LEAD in e.key:
            leads_seen += e.count
        elif _TAIL in e.key:
            tail_seen += e.count
        else:
            events.append(DeviceEvent(e.key, e.self_device_time_total,
                                      e.count))
    return window, events, leads_seen, tail_seen


def device_events(fn: Callable[[], object],
                  check: Optional[Callable[[List[DeviceEvent]], bool]] = None
                  ) -> Tuple[float, List[DeviceEvent]]:
    """(host seconds of ``fn``, everything that ran on the device meanwhile).

    A bare window is not to be trusted. On an NVIDIA H100 with torch 2.11,
    in a process that has profiled other work before (seen from the first
    window after a train step on, not in every run), the FIRST k device
    kernels launched in a window are missing from the profiler's events,
    in every window or in every other one: with k = 1 a window around n
    launches of one kernel shows n - 1 and a window around one launch shows
    nothing; k was 4 at the end of a run of chip_smoke.py. k counts
    kernels, not time: a sleep inside the window before the first launch,
    or after it, saves nothing (scripts/profiler_window_probe.py shows
    each). So the window opens with ``LEADS`` sentinel kernels that take
    the loss and closes with one more. It counts only if a lead sentinel
    shows, so that the loss ended before ``fn`` began, and the last one
    shows, so that the profiler was still recording after ``fn``. Runs of
    kernels have also been seen to go from the middle and the end of a
    window, so a caller that knows how often ``fn`` launches some kernel
    passes ``check``, which sees the events and says whether they add up.
    Any window that does not count is taken again with twice the leads,
    ``WINDOWS`` times in all, and then this raises: what callers print from
    here is a measurement, never a blank. ``fn`` may so run more than
    once."""
    seen, leads = [], LEADS
    for _ in range(WINDOWS):
        window, events, leads_seen, tail_seen = one_window(fn, leads)
        added_up = bool(events) and (check is None or check(events))
        if leads_seen and tail_seen and added_up:
            return window, events
        seen.append((leads_seen, leads, tail_seen, len(events), added_up))
        leads *= 2
    raise RuntimeError(
        f"torch.profiler lost device events in {WINDOWS} windows running: "
        f"(lead sentinels seen, launched, last sentinel of 1, other device "
        f"events, whether they added up) {seen}")
