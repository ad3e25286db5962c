#!/usr/bin/env python3
"""Check whether ``torch.profiler`` keeps the card's events as a process
ages.

    python3 volsync_tpu_torch/tools/trace_clock_probe.py [--sleep S]

Traces four short sessions (CPU and CUDA activity) at the start of the
process and again after ``S`` seconds idle (default 240): six 256 x 256
matmuls with the window padded by 0, 0.05 and 0.3 s of idle at both
ends, then 400 matmuls spread over about 0.4 s. For each session it
prints the kernel launches the host recorded, the device events the
trace kept, and each kept kernel's start minus its launch's start
(microseconds: min, median, max), matched by correlation id. A negative
offset is an error of the trace's clock, since no kernel starts before
its launch. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import sys
import time


def sessions(torch, label: str, t0: float) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256, device="cuda")
    for pad, n, gap in ((0, 6, 0), (0.05, 6, 0), (0.3, 6, 0),
                        (0, 400, 1e-3)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(n):
                torch.mm(x, x)
                if gap:
                    time.sleep(gap)
            torch.cuda.synchronize()
            time.sleep(pad)
        events = list(prof.profiler.kineto_results.events())
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if e.device_type() == DeviceType.CPU
                  and "LaunchKernel" in e.name()}
        device = [e for e in events if e.device_type() != DeviceType.CPU]
        offs = sorted((e.start_ns() - launch[e.correlation_id()]) / 1e3
                      for e in device if e.correlation_id() in launch)
        print(f"{label}, pad {pad} s, {n} matmuls: {len(launch)} launches, "
              f"{len(device)} device events kept, offsets us min/median/max "
              + (f"{offs[0]:.1f}/{offs[len(offs) // 2]:.1f}/{offs[-1]:.1f}"
                 if offs else "none")
              + f" (process age {time.perf_counter() - t0:.1f} s)",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sleep", type=float, default=240.0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("trace_clock_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)
    sessions(torch, "start", t0)
    time.sleep(args.sleep)
    sessions(torch, f"after {args.sleep:g} s idle", t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
