"""The PyTorch port stands alone: it never imports jax, ml_dtypes or the
reference package ``repro``, and its entry points never fall back to the
CPU when no card is present."""

from __future__ import annotations

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"
# the port's scripts outside the package: they import the port alone too
SCRIPTS = sorted(REPO.glob("examples/*_torch.py")) + [REPO / "chip_smoke.py"]
BANNED = ("jax", "ml_dtypes", "repro")


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in BANNED


def _imported_modules(tree: ast.AST):
    """Every module an AST imports: import statements anywhere (lazy ones
    inside functions included) and string arguments of
    ``importlib.import_module`` / ``__import__`` calls."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield node.lineno, arg.value


def test_port_sources_import_no_jax_ml_dtypes_or_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30, "port package not found"
    for module in ("serve/traffic.py", "serve/engine.py", "core/shm_arena.py",
                   "launch/serve.py", "kernels/__init__.py", "models/moe.py",
                   "dist/sharding.py", "dist/context.py", "dist/hlo_analysis.py",
                   "launch/mesh.py", "launch/steps.py", "launch/dryrun.py",
                   "launch/store.py", "configs/paper_microbench.py"):
        assert PORT / module in files, module
    names = {p.name for p in SCRIPTS}
    assert {"quickstart_torch.py", "serve_batched_torch.py", "vignettes_torch.py",
            "train_e2e_torch.py", "chip_smoke.py"} <= names, names
    bad = []
    for path in files + SCRIPTS:
        tree = ast.parse(path.read_text(), filename=str(path))
        for lineno, mod in _imported_modules(tree):
            if _banned(mod):
                bad.append(f"{path.relative_to(REPO)}:{lineno} imports {mod}")
    assert not bad, "\n".join(bad)


def test_guard_scanner_catches_lazy_and_dynamic_imports():
    src = (
        "def f():\n    import jax.numpy as jnp\n"
        "def g():\n    from repro.core import x\n"
        "def h():\n    importlib.import_module('ml_dtypes')\n"
        "from repro_torch import models\n"
    )
    found = [m for _, m in _imported_modules(ast.parse(src)) if _banned(m)]
    assert found == ["jax.numpy", "repro.core", "ml_dtypes"]


_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "ml_dtypes", "repro", "triton")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
"""


def test_port_sources_import_no_triton():
    # every kernel of the port is CUDA C++ bound with ctypes
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(SRC)}:{n} imports {m}"
                for n, m in _imported_modules(tree) if m.split(".")[0] == "triton"]
    assert not bad, "\n".join(bad)


_RMSNORM_WITHOUT_TRITON = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("triton", "jax", "ml_dtypes", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
from repro_torch.kernels.rmsnorm import ops as rn
x = torch.tensor([[1.0, 2.0, 3.0, 4.0], [0.5, -0.5, 0.5, -0.5]])
s = torch.tensor([1.0, 1.0, 2.0, 0.5])
got = rn.rmsnorm(x, s, eps=0.0)
want = x / (x * x).mean(-1, keepdim=True).sqrt() * s
assert torch.allclose(got, want, atol=1e-6), (got, want)
assert rn.launches == 0 and "triton" not in sys.modules
print("ok")
"""


def test_rmsnorm_runs_its_plain_path_with_triton_blocked():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", _RMSNORM_WITHOUT_TRITON], env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.split()[-1] == "ok"


def test_port_imports_with_jax_ml_dtypes_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split()[-1]) > 30


@pytest.fixture()
def no_cuda(monkeypatch):
    """Make the process, and the worker processes it spawns, look
    card-less, whatever machine runs the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from repro_torch import convert, models, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import EpochCache, shm_arena
    from repro_torch.core.shm_ring import ShmRingError
    from repro_torch.launch.serve import publish_model, serve
    from repro_torch.link import Workspace
    from repro_torch.serve import ServeEngine, run_traffic

    cfg = get_config("gemma3-1b", smoke=True)
    specs = models.param_specs(cfg)
    params_np = {n: np.zeros(s.shape, np.float32) for n, s in specs.items()}
    calls = [
        lambda: resolve_device(),
        lambda: models.init_params(cfg, 0),
        lambda: convert.params_from_numpy(params_np, specs),
        lambda: ServeEngine(cfg, {}),
        lambda: serve(cfg, Workspace.open(tmp_path / "ws")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    assert resolve_device("cpu").type == "cpu"     # the CPU only on request

    # the example scripts: --device defaults to the card
    for name in ("quickstart_torch", "serve_batched_torch", "vignettes_torch"):
        spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            script.main([])

    # worker processes of the traffic plane and the fleet: each reports an
    # error naming CUDA, and nothing completes on the CPU
    ws = Workspace.open(tmp_path / "fleet", epoch_cache=EpochCache())
    app = publish_model(ws, cfg, device="cpu")
    try:
        with pytest.raises(ShmRingError, match="torch.cuda.is_available"):
            run_traffic(ws, app, arch="gemma3-1b", workers=2, n_requests=2,
                        prompt_len=8, max_new_tokens=2, timeout=120)
        fleet = ServeEngine.spawn_fleet(ws, app, processes=2, arch="gemma3-1b",
                                        timeout=120)
        assert fleet.failed == 2, fleet.summary()
        for err in fleet.errors:
            assert "torch.cuda.is_available" in err["error"] + err["traceback"]
            assert err["exit_code"] not in (None, 0)
    finally:
        shm_arena.unlink_root_segments(ws.registry)
