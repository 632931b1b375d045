"""Resolve a cell of ``BENCHMARK.json`` into the files named after it.

A cell names a configuration (``bench/configs/<config>.json`` through the
configuration's ``file``) and a traffic mix (``bench/traffic/<mix>.json``);
what decides its ``correct`` is ``bench/checks/<cell>.json``: how many
requests it compares and the limit of each number compared, which depend on
the configuration and the mix together.
Its metrics are the end-to-end entries that list it (or list no cells), and
the per-layer entries that list it, or, without a ``workloads`` key, move
one of its end-to-end metrics. Each metric is read by
``bench/metrics/<name>.py``; a driver by ``bench/drivers/<kind>.py``. A
later cell, mix or metric is new files and new entries: nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict          # bench/configs/<config>.json
    traffic: dict         # bench/traffic/<mix>.json
    checks: dict          # bench/checks/<cell>.json: sample_requests, limits
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _applies(metric: dict, cell: str, moves: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves is None or metric["moves"] in moves


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    root = Path(root)
    spec = load_spec(root)
    work = _by_name(spec["workloads"], name, "workload")
    conf = _by_name(spec["configs"], work["config"], "config")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    moves = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"] if _applies(m, name, moves)]
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config_name=conf["name"],
        traffic_name=work["traffic"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (root / "bench" / "traffic" / f"{work['traffic']}.json").read_text()),
        checks=json.loads((root / "bench" / "checks" / f"{name}.json").read_text()),
        end_to_end=e2e,
        per_layer=per,
        root=root,
    )


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """``read(record) -> float | None`` of ``bench/metrics/<metric>.py``."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    return _module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def driver(kind: str, root: Path = ROOT):
    """The module ``bench/drivers/<kind>.py``: ``setup``, ``window``,
    ``check``."""
    return _module(Path(root) / "bench" / "drivers" / f"{kind}.py", "bench_driver_" + kind)
