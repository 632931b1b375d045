"""The port's dry-run (``repro_torch.launch.dryrun``) on two cells of a
2x4 mesh, each in a subprocess (its fake process group is global to a
process): the reference test's cell (mamba2-370m, decode_32k, no probe)
and gemma3-1b's train_4k with the cost probe, traced with the probe's
attention and one microbatch so the full-depth trace and the probe count
the same program. ``status`` ok, FLOPs counted, ``argument_size_in_bytes``
exact against the bytes the reference's ``spec_for`` puts on one device,
the model FLOPs the reference's formula. Then the probe's affine
extrapolation against a full-depth count on a 3-layer config."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro.configs import get_shape as ref_shape
from repro.dist.sharding import ShardingRules
from repro.dist.sharding import spec_for as ref_spec_for

ROOT = Path(__file__).resolve().parents[1]
MESH = SimpleNamespace(axis_names=("data", "model"), devices=np.empty((2, 4), np.int8))
N_DEV = 8


def _cli(tmp_path, *args, timeout=600):
    out = tmp_path / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "2x4", "--force",
         "--out", str(out), *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(out.read_text().splitlines()[-1])


def _local_bytes(shape, dtype, axes, rules) -> int:
    """Bytes one device of the 2x4 mesh holds under the reference's
    ``spec_for``."""
    sizes = dict(zip(MESH.axis_names, MESH.devices.shape))
    entries = tuple(ref_spec_for(axes, shape, MESH, rules)) + (None,) * len(shape)
    n = 1
    for d, ax in zip(shape, entries):
        n *= d // sizes[ax] if ax else d
    return n * np.dtype(dtype).itemsize


def _ref_argument_bytes(arch, shape_name, rules=None) -> int:
    cfg, shape = ref_config(arch), ref_shape(shape_name)
    specs = ref_models.param_specs(cfg)
    total = sum(_local_bytes(s.shape, "uint16" if s.dtype == "bfloat16" else s.dtype,
                             s.axes, rules) for s in specs.values())
    if shape.kind == "train":        # float32 moments beside each param, the step
        total += 2 * sum(_local_bytes(s.shape, "float32", s.axes, rules)
                         for s in specs.values()) + 4
    ins, axes = ref_models.input_specs(cfg, shape), ref_models.input_axes(cfg, shape)
    for k, v in ins.items():
        leaves = v.items() if isinstance(v, dict) else [(None, v)]
        for n, leaf in leaves:
            ax = axes[k][n] if n is not None else axes[k]
            dt = "uint16" if leaf.dtype.name == "bfloat16" else leaf.dtype.name
            total += _local_bytes(leaf.shape, dt, ax, rules)
    return total


def _ref_model_flops(arch, shape_name) -> float:
    cfg, shape = ref_config(arch), ref_shape(shape_name)
    n = ref_models.n_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len / N_DEV
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len / N_DEV
    return 2.0 * n * shape.global_batch / N_DEV


def test_dryrun_cli_on_the_reference_tests_cell(tmp_path):
    """mamba2-370m, decode_32k, 2x4, no probe: the cell the reference's
    ``test_dryrun_subprocess_small_mesh`` lowers."""
    rec = _cli(tmp_path, "--arch", "mamba2-370m", "--shape", "decode_32k", "--no-probe")
    assert rec["status"] == "ok" and rec["n_devices"] == N_DEV
    assert rec["roofline"]["flops"] > 0 and rec["roofline"]["hbm_bytes"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _ref_argument_bytes("mamba2-370m", "decode_32k")
    # the step writes the cache in place: the whole cache is output and alias
    assert mem["alias_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] >= mem["alias_size_in_bytes"]
    assert rec["roofline"]["model_flops"] == _ref_model_flops("mamba2-370m", "decode_32k")
    assert isinstance(rec["fits_h100_80gb"], bool)
    assert "cost_probe" not in rec


def test_dryrun_cli_train_cell_with_the_cost_probe(tmp_path):
    """gemma3-1b, train_4k, 2x4, with the probe. Traced with the probe's
    attention (naive) and one microbatch, the full-depth count and the
    probe's extrapolation to 26 layers are one program's: equal."""
    rec = _cli(tmp_path, "--arch", "gemma3-1b", "--shape", "train_4k", "--probe",
               "--impl", "naive", "--microbatches", "1")
    assert rec["status"] == "ok" and rec["num_microbatches"] == 1
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["coll_bytes"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _ref_argument_bytes("gemma3-1b", "train_4k")
    # params, moments and step are updated in place: all aliased outputs
    assert mem["alias_size_in_bytes"] == mem["argument_size_in_bytes"] - _local_bytes(
        (256, 4096), "int32", ("batch", "seq"), None) * 2
    assert roof["model_flops"] == _ref_model_flops("gemma3-1b", "train_4k")
    probe = rec["cost_probe"]
    assert "error" not in probe and probe["full_counts"] == [22, 4]
    assert probe["roofline"]["flops"] == pytest.approx(roof["flops"], rel=1e-9)


_PROBE_3 = r"""
import json, sys
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_step
probe = dryrun.run_cost_probe("gemma3-1b", "train_4k", "2x4", overrides={"num_layers": 3})
mesh = dryrun.dryrun_mesh("2x4")
cfg, shape = get_config("gemma3-1b").replace(num_layers=3), get_shape("train_4k")
bundle = build_step(cfg, shape, mesh, num_microbatches=1, impl=dryrun.probe_impl(shape))
trace, _ = dryrun.trace_step(bundle, mesh)
print(json.dumps({"probe": probe, "full": [trace.flops, trace.hbm_bytes,
                  sum(b for _, b in dryrun.collective_stats(trace).schedule)]}))
"""


def test_cost_probe_equals_a_full_depth_count_on_a_3_layer_config():
    """The probe traces 1, 2 and 6 layers and solves for per-layer-type
    costs; at 3 layers (3 local, 0 global) its FLOPs and collective wire
    bytes equal a trace of the 3-layer config. (Not its HBM bytes: traced
    at 1 to 4 layers they are not exactly affine in depth, their second
    differences 0.08-0.7 GB against 3.2 TB a layer; PERF.md.)"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _PROBE_3], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    probe, (flops, hbm, coll) = out["probe"], out["full"]
    assert probe["full_counts"] == [3, 0]
    assert flops > 0 and probe["roofline"]["flops"] == pytest.approx(flops, rel=1e-9)
    assert coll > 0 and probe["roofline"]["coll_bytes"] == pytest.approx(coll, rel=1e-9)
    assert hbm > 0
