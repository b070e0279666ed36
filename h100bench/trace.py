"""A profiled window of the device, guarded against the records the
profiler loses, and what the harness reads from it.

The window logic is a copy of ``vqvae_speech_tpu_torch/utils/profiling.py``
(``_window``, ``device_events``): torch.profiler (Kineto) drops device
records whose converted time stamps stray outside the window, so the window
opens with a run of sentinel kernels (``erfinv_``) and closes with a run of
another kind (``digamma_``), each at least 8 launches and 5 ms (the closing
one at least 5% of the body's time), and counts only if both kinds show.
A region cannot be taken again: a window that lost its sentinels raises.

Spans are the harness's own: ``span(name)`` marks a host region
(``record_function("bench.<name>")``) around a call into the program, and
the idle gaps of the device are charged to the innermost span the host was
in at the gap's middle.
"""
import contextlib
import time

import torch

LEAD, TAIL = "erfinv", "digamma"
LEADS, SPAN, TAIL_SHARE = 8, 5e-3, 5e-2
PREFIX = "bench."


def span(name: str):
    """A named host region of the harness."""
    return torch.profiler.record_function(PREFIX + name)


def _sentinels(launch, count, seconds):
    t0, n = time.perf_counter(), 0
    while n < count or time.perf_counter() - t0 < seconds:
        launch()
        torch.cuda.synchronize()
        n += 1
    return n


class Traced:
    """What a traced window holds once it closed: ``window_s`` (host
    seconds of the body, to its device work's end), ``kernels``
    ({name: (device seconds, launches)}), ``busy_s`` and, from the
    timeline, ``gaps`` ([(span, seconds)] summed by span)."""

    def __init__(self):
        self.window_s = 0.0
        self.kernels = {}
        self.busy_s = 0.0
        self.gaps = {}

    def seconds_of(self, needle: str) -> float:
        return sum(s for k, (s, _) in self.kernels.items() if needle in k)

    def launches_of(self, needle: str) -> int:
        return sum(n for k, (_, n) in self.kernels.items() if needle in k)

    def breakdown(self, gaps=None, top=10):
        """The top device operations by time and, from ``gaps`` (a
        host-recorded window's), the longest idle gaps by span."""
        gaps = self.gaps if gaps is None else gaps
        ops = sorted(((k, s) for k, (s, _) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


@contextlib.contextmanager
def window(host: bool = False):
    """Profile the body's device work; yields a ``Traced`` filled in on
    exit. With ``host`` the host's operators and the harness's spans are
    recorded too, for the idle gaps' causes; that costs the host time on
    every operator, so the device's busy and idle times are read from a
    window without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = Traced()
    mark = torch.full((8,), 0.5, device="cuda")
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        _sentinels(mark.erfinv_, LEADS, SPAN)
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out.window_s = time.perf_counter() - t0
        _sentinels(mark.digamma_, LEADS, max(SPAN, TAIL_SHARE * out.window_s))
    leads = tails = 0
    for e in prof.key_averages():
        if not e.self_device_time_total > 0 or e.device_type == DeviceType.CPU:
            continue
        if e.key.startswith(PREFIX):
            continue
        if LEAD in e.key:
            leads += e.count
        elif TAIL in e.key:
            tails += e.count
        else:
            out.kernels[e.key] = (e.self_device_time_total * 1e-6, e.count)
    if not (leads and tails and out.kernels):
        raise RuntimeError(
            f"torch.profiler lost device events in the traced window: lead "
            f"sentinels seen {leads}, tail sentinels seen {tails}, other "
            f"kernels {len(out.kernels)}")
    out.busy_s = sum(s for s, _ in out.kernels.values())
    if host:
        out.gaps = _idle_gaps(prof.events())


def _idle_gaps(events):
    """The device's idle time between the first and the last kernel of the
    body, charged to the innermost harness span at each gap's middle
    (``outside_spans`` where there is none)."""
    from torch.autograd import DeviceType

    kernels, spans = [], []
    for e in events:
        name = e.name
        if e.device_type == DeviceType.CPU:
            if name.startswith(PREFIX):
                spans.append((e.time_range.start, e.time_range.end,
                              name[len(PREFIX):]))
        elif not name.startswith(PREFIX):
            kernels.append((e.time_range.start, e.time_range.end, name))
    body = [k for k in kernels if LEAD not in k[2] and TAIL not in k[2]]
    if not body:
        return {}
    body.sort()
    gaps, end = {}, body[0][1]
    for start, stop, _ in body[1:]:
        if start > end:
            mid = 0.5 * (start + end)
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            name = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                    else "outside_spans")
            gaps[name] = gaps.get(name, 0.0) + (start - end) * 1e-6
        end = max(end, stop)
    return gaps
