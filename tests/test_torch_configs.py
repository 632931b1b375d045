"""The port's per-architecture config modules and the paper's
microbenchmark world equal the reference's."""

from __future__ import annotations

import dataclasses
import importlib

import pytest

MODULES = ("chameleon_34b", "deepseek_67b", "gemma3_1b", "mamba2_370m", "olmoe_1b_7b",
           "qwen15_110b", "qwen2_moe_a27b", "seamless_m4t_large_v2", "starcoder2_3b",
           "zamba2_7b")


@pytest.mark.parametrize("name", MODULES)
def test_config_module_equals_the_reference(name):
    port = importlib.import_module(f"repro_torch.configs.{name}")
    ref = importlib.import_module(f"repro.configs.{name}")
    assert port.__all__ == ref.__all__ == ["CONFIG", "SMOKE"]
    for which in ("CONFIG", "SMOKE"):
        ours, theirs = getattr(port, which), getattr(ref, which)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), (name, which)
    from repro_torch.configs import get_config

    assert get_config(port.CONFIG.name) == port.CONFIG
    assert get_config(port.CONFIG.name, smoke=True) == port.SMOKE


def test_every_architecture_has_a_module():
    from repro_torch.configs import ARCHS

    names = {importlib.import_module(f"repro_torch.configs.{m}").CONFIG.name
             for m in MODULES}
    assert names == set(ARCHS)


@pytest.mark.parametrize("n,f,seed,kw", [
    (3, 4, 0, {}),
    (8, 16, 7, {"tensor_elems": 1000, "dtype": "float16"}),
])
def test_paper_microbench_world_equals_the_reference(n, f, seed, kw):
    from repro.configs import paper_microbench as ref
    from repro_torch.configs import paper_microbench as port

    bundles, app = port.make_world_spec(n, f, seed=seed, **kw)
    ref_bundles, ref_app = ref.make_world_spec(n, f, seed=seed, **kw)
    assert app.content_hash == ref_app.content_hash
    assert app.manifest_json() == ref_app.manifest_json()
    assert len(bundles) == len(ref_bundles) == n
    for (obj, payload), (ref_obj, ref_payload) in zip(bundles, ref_bundles):
        assert obj.content_hash == ref_obj.content_hash
        assert obj.manifest_json() == ref_obj.manifest_json()
        assert payload == ref_payload
    assert len(app.refs) == n * f
