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


def _cli(tmp_path, *args, mesh="2x4", timeout=600):
    out = tmp_path / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", mesh, "--force",
         "--out", str(out), *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(out.read_text().splitlines()[-1])


def _mesh(spec: str):
    """A stand-in for the reference's mesh of shape ``spec`` ("2x4")."""
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty(tuple(map(int, spec.split("x"))), np.int8))


def _local_bytes(shape, dtype, axes, rules, mesh=MESH) -> int:
    """Bytes one device of ``mesh`` (the 2x4 mesh unless given) holds under
    the reference's ``spec_for``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    entries = tuple(ref_spec_for(axes, shape, mesh, rules)) + (None,) * len(shape)
    n = 1
    for d, ax in zip(shape, entries):
        n *= d // sizes[ax] if ax else d
    return n * np.dtype(dtype).itemsize


def _ref_argument_bytes(arch, shape_name, rules=None, mesh=MESH) -> int:
    cfg, shape = ref_config(arch), ref_shape(shape_name)
    specs = ref_models.param_specs(cfg)
    total = sum(_local_bytes(s.shape, "uint16" if s.dtype == "bfloat16" else s.dtype,
                             s.axes, rules, mesh) for s in specs.values())
    if shape.kind == "train":        # float32 moments beside each param, the step
        total += 2 * sum(_local_bytes(s.shape, "float32", s.axes, rules, mesh)
                         for s in specs.values()) + 4
    ins, axes = ref_models.input_specs(cfg, shape), ref_models.input_axes(cfg, shape)
    for k, v in ins.items():
        leaves = v.items() if isinstance(v, dict) else [(None, v)]
        for n, leaf in leaves:
            ax = axes[k][n] if n is not None else axes[k]
            dt = "uint16" if leaf.dtype.name == "bfloat16" else leaf.dtype.name
            total += _local_bytes(leaf.shape, dt, ax, rules, mesh)
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


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_dryrun_long_500k_decode_over_a_sharded_vocabulary(tmp_path, mesh):
    """gemma3-1b, long_500k (batch 1, the CLI's default rules): the decode
    step's greedy token is an argmax over logits whose vocabulary the
    "model" axis shards; it lowers and the step reports ``ok``, as the
    reference's ``jnp.argmax`` lowers."""
    rec = _cli(tmp_path, "--arch", "gemma3-1b", "--shape", "long_500k", "--no-probe",
               mesh=mesh)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 4 and rec["roofline"]["hbm_bytes"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] == _ref_argument_bytes(
        "gemma3-1b", "long_500k", None, _mesh(mesh))


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


def test_step_trace_counts_no_bytes_for_a_meta_tensor():
    """A tensor on the meta device holds no memory on any device (a prefill
    on a mesh makes its cache's global shape there before each device's
    shard): ``StepTrace`` counts none of its bytes, live or moved, and
    counts a CPU tensor's."""
    import torch

    from repro_torch.dist.hlo_analysis import StepTrace

    n = 256 * 1024 * 4                  # one float32 (256, 1024) tensor
    # live: the zeros and the sum; moved: the zeros written, read, the sum written
    for device, want in (("meta", (0, 0)), ("cpu", (2 * n, 3 * n))):
        with StepTrace() as trace:
            out = torch.zeros((256, 1024), device=device) + 1
        assert (trace.peak_bytes, trace.hbm_bytes) == want, device
        assert trace.ops == 2
        del out


def test_step_trace_counts_no_bytes_for_a_metadata_query():
    """A query of a tensor's metadata (``prim.device``, which ``local_map``
    and DTensor make many times a step) moves no bytes: ``StepTrace``
    counts the op and none of its input's bytes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.hlo_analysis import StepTrace

    with FakeTensorMode():
        x = torch.empty(256, 1024)
        with StepTrace() as trace:
            assert torch.ops.prim.device.default(x).type == "cpu"
    assert (trace.ops, trace.hbm_bytes, trace.peak_bytes) == (1, 0, 0)
