"""One run of one cell of the PyTorch/CUDA port's benchmark.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``volsync_tpu_torch``).
The run is a fresh process: it loads the program, makes the cell's inputs
from the seed, warms up (all of that is ``setup_s``), measures for
``--seconds``, reads the device's peak memory, lets the program go, has
the plain reference judge what the timed path produced, and prints one
JSON line last on standard output. With ``--trace 0`` the line holds the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from spans, counters and a ``torch.profiler`` trace of the window. Each
number compared with the reference is printed with its limit, last on
standard error and last in the line (``compared``).

It exits non-zero, printing no result, without enough CUDA cards, when
the program is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.devtrace import DeviceTrace  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "volsync_tpu")
HBM_BYTES_S = 3.35e12
INT32_LANES_PER_SM = 64


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class RunContext:
    cell: spec.Cell
    seed: int
    device: object      # the program's device: None is its default, CUDA
    gen_device: str     # where the inputs are drawn
    workdir: Path
    trace: bool

    def log(self, msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a per-layer reader sees."""
    spans: dict
    inputs: dict
    trace: DeviceTrace
    card: dict


def card_info(torch) -> dict:
    """The card's SMs and maximum SM clock (nvidia-smi), for rooflines."""
    props = torch.cuda.get_device_properties(0)
    info = {"sms": props.multi_processor_count, "max_sm_hz": None,
            "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30).stdout.strip().split(",")
        info["max_sm_hz"] = float(out[0]) * 1e6
        info["power_limit_w"] = float(out[1])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def roofline(run: Run, family: str, lengths) -> float | None:
    """Share (%) of the family's floor in its kernels' summed device time:
    the floor is the larger of its operations over the card's INT32 issue
    rate and its bytes over HBM bandwidth."""
    fam = spec.load_module("kernels", family)
    seconds = run.trace.kernel_seconds(fam.KERNELS)
    if not seconds or not lengths or not run.card.get("max_sm_hz"):
        return None
    ops, nbytes = fam.work(lengths)
    peak = run.card["sms"] * INT32_LANES_PER_SM * run.card["max_sm_hz"]
    return 100.0 * max(ops / peak, nbytes / HBM_BYTES_S) / seconds


def _span_delta(after: dict, before: dict) -> dict:
    return {k: v[1] - before.get(k, (0, 0.0))[1] for k, v in after.items()
            if v[1] - before.get(k, (0, 0.0))[1] > 0}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device=None, t0: float | None = None) -> dict:
    """Run ``cell`` once and return its result line (a dict). ``device``
    None runs the program on its default, the CUDA card; the tests pass
    ``"cpu"``."""
    import torch

    from volsync_tpu_torch.obs import span_totals

    t0 = _T0 if t0 is None else t0
    on_card = device is None
    workdir = Path(tempfile.mkdtemp(prefix=f"portbench-{cell.name}-"))
    ctx = RunContext(cell=cell, seed=seed, device=device,
                     gen_device="cuda" if on_card else device,
                     workdir=workdir, trace=trace)
    load = spec.load_module("loads", cell.traffic["kind"]).Load(ctx)
    dtrace = DeviceTrace(trace and on_card)

    def mark(name: str):
        if trace and on_card:
            return torch.profiler.record_function(f"portbench.{name}")
        return contextlib.nullcontext()

    try:
        load.setup()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        spans0 = span_totals()
        with dtrace.record():
            load.window(seconds, mark)
            if on_card:
                torch.cuda.synchronize()
        spans = _span_delta(span_totals(), spans0)
        load.collect()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        e2e = load.end_to_end()
        inputs = load.layer_inputs() if trace else {}
        load.release()
        attempted, failed = load.counts()
        compared = load.check()
    finally:
        load.close()
        shutil.rmtree(workdir, ignore_errors=True)
    compared += [("requests_failed", failed, 0),
                 ("requests_done_short", 0 if attempted else 1, 0)]

    metrics = {}
    if trace:
        run = Run(spans=spans, inputs=inputs, trace=dtrace,
                  card=card_info(torch) if on_card else {})
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {
        "correct": all(v <= lim for _, v, lim in compared),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak},
    }
    if trace:
        result["device"]["busy_s"] = dtrace.busy_s or 0.0
        result["device"]["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.top_gaps()}
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    card = card_info(torch)
    print(f"portbench: {result['device']['kind']}, power limit "
          f"{card['power_limit_w']} W, max SM clock {card['max_sm_hz']} Hz; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad[:10]}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
