"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run makes its weights and traffic from
``--seed``, warms every shape the cell uses (counted in ``setup_s``),
measures for ``--seconds`` seconds, then checks what the timed path
produced against the plain float32 reference. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and traced seconds, and a breakdown.
The profiler runs over the mix's traced stretch with ``--trace 1``, and in
every run of a cell that has an end-to-end metric read from the device
trace (``"source": "device_trace"`` in ``BENCHMARK.json``).

Standard error opens with a line on the card and one on the host
(``bench/host.py``: CPU model, the CPUs in force, the card's NUMA node,
the load), and after the window a line says how often Python's collector
ran in it, by generation (``host.Collector``). The last lines on standard
error, and the result's last key ``checks``, give each number compared
beside its limit; the last line on standard output is the result, one
JSON object. Without a card (or with fewer than the cell asks for) the run
prints no result and exits 3; if ``jax``, ``jaxlib``, ``flax``,
``ml_dtypes`` or the JAX package ``repro`` is loaded once the window has
closed, it names them and exits 4.

Kernel builds and caches stay inside the checkout: the program builds its
CUDA kernels under ``build/kernels``; Triton's and PyTorch's extension
caches are pointed at ``build/bench/cache``.
"""

from __future__ import annotations

import os
import sys
import time

T_PROC0 = time.monotonic()
_HERE = os.path.dirname(os.path.abspath(__file__))
# run as a script, this folder heads sys.path; its modules (trace, cell, ...)
# must not shadow the standard library's
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(_HERE).parent
BANNED = ("jax", "jaxlib", "flax", "ml_dtypes", "repro")


@dataclass
class Ctx:
    cell: object
    cfg: object               # the program's ModelConfig
    conf: dict                # the configuration file as run
    traffic: dict
    checks: dict              # bench/checks/<cell>.json
    seed: int
    seconds: float
    trace: bool               # report the per-layer metrics
    device: str
    t_proc0: float
    control: str | None = None    # bench/control.py: also read the control's gaps
    readings: dict | None = None  # every number the check read (compare.readings)
    profile: bool = False     # run the profiler over the mix's traced stretch


def banned_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` that the run may not load, each
    compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             smoke: bool = False, traffic: dict | None = None, checks: dict | None = None,
             t_proc0: float = T_PROC0, control: str | None = None) -> dict:
    """One run of ``cell`` (``bench.cell.resolve``): the result's dict.
    ``smoke`` takes the program's reduced configuration (the CPU tests),
    ``traffic`` and ``checks`` replace the cell's mix and checks, and ``control`` (a precision of
    ``bench.reference.precision``) also reads the control's gaps on the same
    sample, returned under ``readings`` (``bench/control.py``)."""
    import torch

    from bench import compare, host
    from bench.cell import driver, reader
    from bench.model import program_config

    cfg, conf = program_config(cell.config, smoke=smoke)
    ctx = Ctx(cell=cell, cfg=cfg, conf=conf, traffic=traffic or cell.traffic,
              checks=checks or cell.checks, seed=seed,
              seconds=seconds, trace=trace, device=device, t_proc0=t_proc0,
              control=control,
              profile=trace or any(m["source"] == "device_trace" for m in cell.end_to_end))
    drv = driver(ctx.traffic["driver"], cell.root)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = drv.setup(ctx)
    with host.Collector() as collector:
        rec = drv.window(ctx, state)
    print(collector.line(rec.window), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    checks = drv.check(ctx, state, rec)
    del state
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": compare.passed(checks), "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    if control:
        out["readings"] = ctx.readings
    out["checks"] = checks
    return out


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    cache = ROOT / "build" / "bench" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    from bench import host
    from bench.cell import resolve

    cell = resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"card: {_card_line()}; peaks 989 TFLOP/s bf16, 3.35 TB/s", file=sys.stderr)
    print(host.facts(host.bus_id(torch.cuda.get_device_properties(0))), file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"loaded in this process, which the benchmark may not load: {found}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
