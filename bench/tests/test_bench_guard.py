"""The benchmark imports neither JAX nor the JAX package, and its
reference nothing of the program; a run without a card, or without the
program, prints no result."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench.cell import ROOT
from bench.run import banned_modules

BENCH = ROOT / "bench"
BANNED = {"jax", "jaxlib", "flax", "ml_dtypes", "repro"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    found = _imports(path)
    assert not found & BANNED, found & BANNED
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in found


def test_module_names_are_compared_whole():
    assert banned_modules(["repro_torch", "repro_torch.models", "jaxtyping", "numpy"]) == []
    assert banned_modules(["repro.core", "jax.numpy", "ml_dtypes"]) == ["jax", "ml_dtypes", "repro"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "mamba2-370m.replica-start", "--seed", str(2**31 + 9),
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = _run(ROOT)
    assert r.returncode == 3 and r.stdout.strip() == "", (r.returncode, r.stdout, r.stderr[-2000:])


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == "", (r.returncode, r.stdout)


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", "mamba2-370m.replica-start",
                        "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
