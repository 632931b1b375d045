"""BENCHMARK.json against the benchmark's contract, each cell resolved from
its files by name, and a cell added as new files alone."""

from __future__ import annotations

import json
import math
import re
import shutil

import pytest

from bench.cell import ROOT, load_spec, reader, resolve

from .smoke import run_smoke

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expand|_dim$|_rank$|per_tok)")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"] and SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in SPEC[group]:
            assert set(e) == keys and NAME.match(e["name"]), e
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


def test_configs_name_no_width_in_reduced():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/") and conf["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_and_reports_enough(name):
    cell = resolve(name)
    assert cell.chips == 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (name, m["name"])
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]))
    assert cell.checks["sample_requests"] > 0 and cell.checks["limits"]
    assert (ROOT / "bench" / "drivers" / f"{cell.traffic['driver']}.py").exists()


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a mix, the cell's checks, an end-to-end metric and a
    per-layer metric added as files of their own, with entries appended to
    BENCHMARK.json: no existing file changes."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    conf = json.loads((ROOT / "bench/configs/mamba2-370m.json").read_text())
    (tmp_path / "bench/configs/mamba2-370m-b.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "bench/traffic/chat.json").read_text())
    mix.update(rate=[[1.0, 3.0]], prompt_len=[32, 512], output_len=[16, 32])
    (tmp_path / "bench/traffic/short-steady.json").write_text(json.dumps(mix))
    (tmp_path / "bench/checks/mamba2-370m-b.short-steady.json").write_text(
        json.dumps({"sample_requests": 8, "limits": {"logit_gap": 0.45}}))
    (tmp_path / "bench/metrics/tokens_per_s.py").write_text(
        "from bench import readings\n\n\ndef read(rec):\n"
        "    return readings.window_tokens(rec) / rec.seconds\n")
    (tmp_path / "bench/metrics/sched.admissions.py").write_text(
        "def read(rec):\n    return float(len(rec.prefills)) if rec.prefills else None\n")
    cell_name = "mamba2-370m-b.short-steady"
    spec["configs"].append({"name": "mamba2-370m-b", "source": conf["source"],
                            "file": "bench/configs/mamba2-370m-b.json", "reduced": conf["reduced"],
                            "why": "a throwaway copy"})
    spec["workloads"].append({"name": cell_name, "config": "mamba2-370m-b",
                              "traffic": "short-steady", "chips": 1, "why": "throwaway"})
    spec["end_to_end"].append({"name": "tokens_per_s", "unit": "tokens/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": [cell_name]})
    spec["per_layer"].append({"name": "sched.admissions", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "scheduler",
                              "moves": "tokens_per_s", "workloads": [cell_name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = resolve(cell_name, tmp_path)
    assert cell.traffic["rate"] == [[1.0, 3.0]] and cell.checks["limits"] == {"logit_gap": 0.45}
    assert [m["name"] for m in cell.per_layer] == ["sched.admissions"]
    out = run_smoke(cell_name, root=tmp_path, trace=True)
    assert out["correct"] and out["metrics"]["sched.admissions"]["value"] > 0
    out = run_smoke(cell_name, root=tmp_path)
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    assert math.isfinite(out["metrics"]["tokens_per_s"]["value"])
