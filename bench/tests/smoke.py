"""Helpers of the CPU tests: a cell at the program's reduced size, with a
mix scaled to match, run through the harness on the CPU."""

from __future__ import annotations

import copy
import json
import shutil
import time

from bench.cell import ROOT, load_spec, resolve
from bench.run import run_cell

SEED = 3000000017


def smoke_mix(cell) -> dict:
    mix = copy.deepcopy(cell.traffic)
    if mix["driver"] == "open_loop":
        steady = len(mix["rate"]) == 1
        mix.update(prompt_len=[8, 24], output_len=[4, 12], ramp_s=1.0, trace_at_s=0.5,
                   trace_s=1.0, rate=[[1.0, 20.0]] if steady else [[0.5, 40.0], [1.0, 5.0]])
        cell.config["engine"] = dict(cell.config["engine"], max_batch=4)
    else:
        mix.update(prompt_len=16)
    return mix


def smoke_checks(cell, limit: float | None) -> dict:
    """The cell's checks, each limit ``limit`` (None: the cell's own), with
    fewer starts compared."""
    checks = copy.deepcopy(cell.checks)
    if limit is not None:
        checks["limits"] = dict.fromkeys(checks["limits"], limit)
    if cell.traffic["driver"] != "open_loop":
        checks["sample_requests"] = 4
    return checks


def run_smoke(name: str, *, limit: float | None = 0.05, seconds: float = 2.0,
              trace: bool = False, seed: int = SEED, root=None, control=None) -> dict:
    cell = resolve(name) if root is None else resolve(name, root)
    return run_cell(cell, seed, seconds, trace, device="cpu", smoke=True,
                    traffic=smoke_mix(cell), checks=smoke_checks(cell, limit),
                    t_proc0=time.monotonic(), control=control)


def root_with(tmp_path, name: str, config: str, traffic: str, checks: dict, *,
              metric: str = "ttft_p90_s"):
    """A copy of the benchmark in ``tmp_path`` with one more cell, ``name``,
    of an existing configuration and mix and the ``checks`` given,
    reporting ``metric``: a cell that BENCHMARK.json does not hold (the SSM
    served in the chat mix, for one)."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = load_spec()
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                              "chips": 1, "why": "a test's cell"})
    for m in spec["end_to_end"]:
        if m["name"] == metric:
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "bench" / "checks" / f"{name}.json").write_text(json.dumps(checks))
    return tmp_path
