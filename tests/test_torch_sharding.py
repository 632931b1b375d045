"""The port's logical-axis placement against the reference's: ``spec_for``
on every parameter of every config at published widths (specs only,
nothing materialised), for every rule set and the meshes pod, multipod,
2x4 and 1x1; the inputs' and caches' axes of every shape with
``build_step``'s default rule choice; ``placements_for``'s local shapes
against the reference's shard-shape arithmetic; ``constrain`` outside a
context. The reference's ``spec_for`` is pure Python: a stand-in mesh with
``axis_names`` and ``devices.shape`` is all it reads, as the port's reads
``mesh_dim_names`` and ``shape``."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.dist.sharding import RULESETS as REF_RULESETS
from repro.dist.sharding import spec_for as ref_spec_for
from repro_torch import models
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.dist.context import constrain, current_mesh_rules, mesh_rules
from repro_torch.dist.sharding import RULESETS, local_shape, placements_for, spec_for
from repro_torch.launch.mesh import mesh_shape
from repro_torch.launch.steps import default_rules

MESHES = ["pod", "multipod", "2x4", "1x1"]


def _meshes(spec):
    """(the port's stand-in mesh, the reference's) of one spec."""
    shape, names = mesh_shape(spec)
    port = SimpleNamespace(mesh_dim_names=names, shape=shape, ndim=len(shape),
                           size=lambda i=None: shape[i] if i is not None else int(np.prod(shape)))
    ref = SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=np.int8))
    return port, ref


def _ref_entries(pspec) -> tuple:
    return tuple(pspec)


def test_archs_shapes_and_rulesets_are_the_references():
    assert sorted(ARCHS) == sorted(REF_ARCHS) and sorted(SHAPES) == sorted(REF_SHAPES)
    assert sorted(RULESETS) == sorted(REF_RULESETS)
    for name in RULESETS:
        port, ref = RULESETS[name](), REF_RULESETS[name]()
        assert port.name == ref.name and dict(port.rules) == dict(ref.rules)


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_for_matches_the_reference_on_every_param(arch, spec):
    pmesh, rmesh = _meshes(spec)
    specs = models.param_specs(get_config(arch))
    ref_specs = ref_models.param_specs(ref_config(arch))
    assert {n: (s.shape, s.axes) for n, s in specs.items()} == {
        n: (tuple(s.shape), tuple(s.axes)) for n, s in ref_specs.items()}
    for rules in RULESETS:
        for n, s in specs.items():
            got = spec_for(s.axes, s.shape, pmesh, RULESETS[rules]())
            want = _ref_entries(ref_spec_for(s.axes, s.shape, rmesh, REF_RULESETS[rules]()))
            assert got == want, (arch, spec, rules, n, got, want)


def _flat_inputs(cfg, shape, mod):
    specs, axes = mod.input_specs(cfg, shape), mod.input_axes(cfg, shape)
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            for n in v:
                out[f"{k}/{n}"] = (tuple(v[n].shape), str(v[n].dtype).split(".")[-1],
                                   tuple(axes[k][n]))
        else:
            out[k] = (tuple(v.shape), str(v.dtype).split(".")[-1], tuple(axes[k]))
    return out


def _ref_default_rules(cfg, shape):
    """The reference ``build_step``'s rule choice, as it reads."""
    if shape.name == "long_500k":
        return "long"
    if shape.kind == "decode" and 0 < cfg.num_kv_heads < cfg.num_heads:
        return "decode_seq"
    return "default"


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_axes_match_the_reference_for_every_shape(arch, spec):
    """``build_step``'s inputs (tokens, labels, frames; a decode step's
    cache) of every shape: the same shapes, dtypes and logical axes as the
    reference's ``input_specs``/``input_axes``, resolved to the same spec
    entries under the same default rules."""
    pmesh, rmesh = _meshes(spec)
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in SHAPES.items():
        got = _flat_inputs(cfg, shape, models)
        want = _flat_inputs(rcfg, REF_SHAPES[name], ref_models)
        assert got == want, (arch, name)
        rules = default_rules(cfg, shape)
        rname = _ref_default_rules(rcfg, REF_SHAPES[name])
        assert (rules.name if rules else "default") == rname
        for n, (shp, _, axes) in got.items():
            assert spec_for(axes, shp, pmesh, rules) == _ref_entries(
                ref_spec_for(axes, shp, rmesh, REF_RULESETS[rname]())), (arch, name, n)
        # the prefill's cache (build_step's "cache" shardings)
        shapes, axes = models.cache_spec(cfg, shape.global_batch, shape.seq_len)
        rshapes, raxes = ref_models.cache_spec(rcfg, shape.global_batch, shape.seq_len)
        assert {n: (tuple(s), tuple(axes[n])) for n, (s, _) in shapes.items()} == {
            n: (tuple(rshapes[n].shape), tuple(raxes[n])) for n in rshapes}


@pytest.mark.parametrize("spec", MESHES)
def test_placements_give_the_references_shard_shapes(spec):
    """Local shapes under ``placements_for`` (one placement per mesh
    dimension) equal the reference's shard-shape arithmetic (each
    sharded dimension divided by its mesh axis's size)."""
    pmesh, rmesh = _meshes(spec)
    sizes = dict(zip(rmesh.axis_names, rmesh.devices.shape))
    for arch in ("gemma3-1b", "olmoe-1b-7b", "zamba2-7b", "deepseek-67b"):
        for rules in RULESETS:
            for n, s in models.param_specs(get_config(arch)).items():
                pspec = ref_spec_for(s.axes, s.shape, rmesh, REF_RULESETS[rules]())
                want = [d // sizes[ax] if ax else d
                        for d, ax in zip(s.shape, tuple(pspec) + (None,) * len(s.shape))]
                entries = spec_for(s.axes, s.shape, pmesh, RULESETS[rules]())
                pl = placements_for(entries, pmesh)
                assert len(pl) == len(pmesh.shape)
                got = list(s.shape)
                for i, p in enumerate(pl):
                    if p.is_shard():
                        got[p.dim] //= pmesh.shape[i]
                assert got == want == list(local_shape(s.shape, entries, pmesh)), n


def test_constrain_is_the_identity_outside_mesh_rules():
    x = torch.arange(12.0).reshape(3, 4)
    assert current_mesh_rules() is None
    assert constrain(x, ("batch", "embed")) is x
    mesh, _ = _meshes("2x4")
    with mesh_rules(mesh, RULESETS["default"]()):
        assert current_mesh_rules()[0] is mesh
        assert constrain(x, ("batch", "embed")) is x      # a plain tensor
        with mesh_rules(None):
            assert current_mesh_rules() == (None, None)   # the innermost wins
        assert current_mesh_rules()[0] is mesh
    assert current_mesh_rules() is None
