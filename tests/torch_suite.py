"""The reference's linker and runtime test suites, run on the port.

``run_reference_suite("test_core_inspector.py", globals())`` reads the
reference's test file, maps its imports from ``repro`` to ``repro_torch``
(and the helpers it takes from ``conftest`` to this module) by rewriting
the parsed syntax tree, and executes it into the calling module, so that
pytest collects every reference case as a case of the port's file. A
string constant that is a module path of the reference
(``"repro.link.strategies"``) is mapped too. Nothing else of the source
changes, and tracebacks point at the reference's own lines.

This module also holds the port-side counterparts of the fixtures and
helpers of ``tests/conftest.py``: ``workspace``, ``linker``,
``build_bundle``, ``build_app``, and a guard of the port's strategy
registry (the conftest's autouse guard snapshots only ``repro``'s). A port
file imports them by name so that its cases use the port's linker.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import (
    ObjectKind,
    PAGE_BYTES,
    SymbolDef,
    SymbolRef,
    align_up,
    make_object,
)
from repro_torch.link import Workspace

TESTS = Path(__file__).resolve().parent
_MODULE_PATH = re.compile(r"repro(\.[A-Za-z_]\w*)*")
_RENAMES = {"conftest": "torch_suite"}


def _map_module(name: str | None) -> str | None:
    if name is None:
        return None
    if name in _RENAMES:
        return _RENAMES[name]
    if name == "repro" or name.startswith("repro."):
        return "repro_torch" + name[len("repro"):]
    return name


class _ToPort(ast.NodeTransformer):
    def visit_Import(self, node):
        for alias in node.names:
            if alias.asname is None and _map_module(alias.name) != alias.name:
                raise NotImplementedError(f"bare import of {alias.name} (it binds its "
                                          "top package's name): use from-imports")
            alias.name = _map_module(alias.name)
        return node

    def visit_ImportFrom(self, node):
        if node.level == 0:
            node.module = _map_module(node.module)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str) and _MODULE_PATH.fullmatch(node.value):
            return ast.copy_location(ast.Constant(_map_module(node.value)), node)
        return node


def port_source(name: str):
    """The reference test file ``tests/<name>`` as a code object whose
    imports and module-path strings name the port."""
    path = TESTS / name
    tree = _ToPort().visit(ast.parse(path.read_text(), filename=str(path)))
    return compile(ast.fix_missing_locations(tree), str(path), "exec")


def run_reference_suite(name: str, namespace: dict) -> None:
    """Execute the reference's ``tests/<name>`` on the port into
    ``namespace`` (a test module's globals)."""
    exec(port_source(name), namespace)


# ----------------------------------------- port-side conftest counterparts
@pytest.fixture(autouse=True)
def _port_strategy_registry_guard():
    """The port's strategy registry is process-global too: snapshot it
    before and restore it after every test."""
    from repro_torch.link.strategies import restore_strategies, snapshot_strategies

    snap = snapshot_strategies()
    yield
    restore_strategies(snap)


@pytest.fixture()
def workspace(tmp_path):
    return Workspace.open(tmp_path / "store")


@pytest.fixture()
def linker(workspace):
    """Legacy-shaped fixture: the engine-room triple, wired by Workspace."""
    return workspace.registry, workspace.manager, workspace.executor


def build_bundle(name: str, tensors: dict[str, np.ndarray], version="1"):
    """Page-aligned bundle from named numpy tensors."""
    payload = bytearray()
    syms = []
    for tname in sorted(tensors):
        arr = np.ascontiguousarray(tensors[tname])
        off = len(payload)
        payload.extend(arr.tobytes())
        payload.extend(b"\x00" * (align_up(len(payload), PAGE_BYTES) - len(payload)))
        syms.append(
            SymbolDef(tname, tuple(arr.shape), str(arr.dtype), off, arr.nbytes)
        )
    return make_object(
        name=name, version=version, kind=ObjectKind.BUNDLE,
        symbols=syms, payload=bytes(payload),
    )


def build_app(name: str, refs: list[SymbolRef], needed: list[str]):
    app, _ = make_object(
        name=name, version="1", kind=ObjectKind.APPLICATION,
        refs=refs, needed=needed,
    )
    return app
