#!/usr/bin/env python3
"""Which device events torch.profiler loses around a short launch.

    python3 scripts/profiler_window_probe.py [windows]

On one NVIDIA GPU: runs chip_smoke.py's phases kernel, slice, train and
step_kernel, and where the step_kernel phase counts the device kernels of one
prepared WaveNet decode step (one cooperative launch, about 0.18 ms), takes
`windows` (default 6) profiler windows of each of these kinds around it and
prints the decode-step kernels each window showed:

- bare windows around 1, 2, 5 and 20 launches;
- bare windows around 1 launch with the host asleep for 20 ms inside the
  window before the launch and after its end;
- windows around 1 launch guarded by LEADS sentinel kernels before it and
  as many after (utils/profiling.py's count, without its minimum time),
  with the sentinels seen and whether the window counts.

After the phases it takes guarded windows around one small elementwise kernel
behind 1, 3, 8 and 16 leading sentinels, and behind 1 and 3 with the host
asleep for 10 ms between the sentinels and the kernel, which shows how many
kernels the loss takes and that it counts kernels, not time. With `--phases=a,b,...` it runs those
phases of chip_smoke.py only (`--phases=step_kernel`: that phase alone).
The loss is not seen in every run.

With `--long` it runs no phase and takes `windows` guarded windows (the
defaults of utils/profiling.py) around each of 1000, 10000, 50000, 100000
and 200000 back-to-back launches of one small elementwise kernel, and prints
the launches each window showed beside the sentinels: whether a long window
loses its start or its end. Set KINETO_LOG_LEVEL=0
to see the profiler library's own messages. Imports nothing of JAX.
"""
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from vqvae_speech_tpu_torch.utils.profiling import LEADS, one_window  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    phases = [a.split("=", 1)[1] for a in sys.argv[1:]
              if a.startswith("--phases=")]
    windows = int(args[0]) if args else 6
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if "--long" in sys.argv:
        long_windows(windows, gpu)
        return
    counts_of = chip_smoke._device_kernel_counts
    calls = [0]

    def seen(fn, reps=1, pad=0.0, leads=0):
        def run():
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)

        w = one_window(run, leads=leads, span=0, tail_share=0)
        return sum(e.count for e in w.events), w.leads_seen, w.tails_seen

    def probe(fn):
        calls[0] += 1
        if ("kernel" in ran.split(",")
                and calls[0] <= len(chip_smoke.KERNEL_SHAPES)):
            return counts_of(fn)      # the kernel phase's own counts
        for reps in (1, 2, 5, 20):
            print(f"probe: bare windows around {reps} launch(es) show "
                  f"{[seen(fn, reps)[0] for _ in range(windows)]} kernels")
        print("probe: bare windows around 1 launch, 20 ms asleep before and "
              f"after, show {[seen(fn, pad=0.02)[0] for _ in range(windows)]}")
        guarded = [seen(fn, leads=LEADS) for _ in range(windows)]
        print(f"probe: guarded windows around 1 launch show (kernels, lead "
              f"sentinels of {LEADS}, tail sentinels of {LEADS}) {guarded}; "
              f"{sum(1 for k, a, b in guarded if k and a and b)} count "
              f"[{gpu}]", flush=True)
        return counts_of(fn)

    ran = phases[0] if phases else "kernel,slice,train,step_kernel"
    chip_smoke._device_kernel_counts = probe
    sys.argv = ["chip_smoke.py", "--phases", ran]
    chip_smoke.main()

    x = torch.ones(1024, device="cuda")

    def plain():
        x.mul_(1.0)

    def paused():
        time.sleep(0.01)
        x.mul_(1.0)

    for leads, fn in ((1, plain), (3, plain), (8, plain), (16, plain),
                      (1, paused), (3, paused)):
        rows = [one_window(fn, leads=leads, span=0, tail_share=0)
                for _ in range(windows)]
        print(f"probe, after phases {ran}: windows around one elementwise "
              f"kernel behind {leads} sentinel(s)"
              f"{', 10 ms asleep before it' if fn is paused else ''} show "
              "(kernels, lead sentinels, tail sentinels, of as many each) "
              f"{[(sum(e.count for e in r.events), r.leads_seen, r.tails_seen) for r in rows]}"
              f" [{gpu}]", flush=True)


def long_windows(windows, gpu):
    x = torch.ones(1024, device="cuda")
    for n in (1000, 10000, 50000, 100000, 200000):
        def run():
            for _ in range(n):
                x.mul_(1.0)
        rows = []
        for _ in range(windows):
            t0 = time.perf_counter()
            w = one_window(run)
            rows.append((sum(e.count for e in w.events), w.leads_seen,
                         w.leads, w.tails_seen, w.tails,
                         round(time.perf_counter() - t0, 2)))
        print(f"probe: guarded windows around {n} launches show (launches, "
              f"lead sentinels seen, launched, tail sentinels seen, "
              f"launched, seconds with the profiler's processing) {rows} "
              f"[{gpu}]", flush=True)


if __name__ == "__main__":
    main()
