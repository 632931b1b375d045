"""The reference's linker and runtime cases that compare bytes or a JSON
report, run through both packages on the same inputs: the port's output
must equal the reference's, not only pass the case's own checks
(``tests/test_torch_suite_*.py`` run the cases themselves on the port).

Each scenario runs once per package on its own root and returns what the
reference's case compares: kernel-library objects, a relocation table's
JSON and CSV exports, an ABI listing, the management journal's rows and a
preview's records, and the table files a commit writes. A root that the
reference commits with a kernel library also loads on the port with the
same kernel bindings."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import conftest
import torch_suite

KERNELS = {"flash_attention": 0, "rmsnorm": 1}


def _pkg(name: str) -> SimpleNamespace:
    """The names a scenario uses, from the reference (``repro``) or the
    port (``repro_torch``)."""
    if name == "repro":
        from repro.ckpt import make_kernel_lib
        from repro.core import EpochCache, SymbolRef, inspector
        from repro.link import Workspace
        helpers = conftest
    else:
        from repro_torch.ckpt import make_kernel_lib
        from repro_torch.core import EpochCache, SymbolRef, inspector
        from repro_torch.link import Workspace
        helpers = torch_suite
    return SimpleNamespace(make_kernel_lib=make_kernel_lib, EpochCache=EpochCache,
                           SymbolRef=SymbolRef, inspector=inspector, Workspace=Workspace,
                           build_app=helpers.build_app, build_bundle=helpers.build_bundle)


PKGS = ("repro", "repro_torch")


def _both(scenario, tmp_path):
    """``scenario(pkg, root)`` for the reference and for the port."""
    return [scenario(_pkg(p), tmp_path / p) for p in PKGS]


def _kernel_world(pkg, root: Path, weak: bool = True):
    """A weights bundle, two kernel libraries (``kernels:debug`` interposes
    rmsnorm at entry 7) and an app binding tensors and kernels, one of them
    weak and unexported."""
    ws = pkg.Workspace.open(root, epoch_cache=pkg.EpochCache())
    weights = pkg.build_bundle("weights", {"w/a": np.arange(6, dtype=np.float32)})
    refs = [pkg.SymbolRef("w/a", (6,), "float32"),
            pkg.SymbolRef("kernel:flash_attention", (), "kernel"),
            pkg.SymbolRef("kernel:rmsnorm", (), "kernel")]
    if weak:
        refs.append(pkg.SymbolRef("kernel:fused_swiglu", (), "kernel", weak=True))
    with ws.management() as tx:
        tx.publish(*weights)
        tx.publish(*pkg.make_kernel_lib("kernels:prod", "v1", KERNELS))
        tx.publish(*pkg.make_kernel_lib("kernels:debug", "v1", {"rmsnorm": 7}))
        tx.publish(pkg.build_app("app", refs, ["weights", "kernels:prod"]))
    return ws


@pytest.mark.parametrize("entries", [KERNELS, {"rmsnorm": 7}, {}],
                         ids=["prod", "debug", "empty"])
def test_make_kernel_lib_object_equals_the_references(entries):
    """The same entries give the same object: manifest (content hash and
    uuid included) and payload, byte for byte."""
    (a, pa), (b, pb) = (_pkg(p).make_kernel_lib("kernels:prod", "v1", entries) for p in PKGS)
    dump = lambda o: json.dumps(o.manifest_json(), sort_keys=True).encode()
    assert dump(b) == dump(a) and pb == pa
    assert (b.uuid, b.store_name, int(b.kind)) == (a.uuid, a.store_name, int(a.kind))
    assert sorted(b.symbols) == [f"kernel:{k}" for k in sorted(entries)]


@pytest.mark.parametrize("strategy", ["stable", "dynamic", "indexed", "lazy", "stable-mmap"])
def test_reference_root_with_a_kernel_library_loads_on_the_port(tmp_path, strategy):
    """The reference commits the kernel world; the port opens its root and
    loads the app with the same ``img.kernels`` bindings (the weak kernel
    bound to the no-op) and the same tensor."""
    ref = _kernel_world(_pkg("repro"), tmp_path / "store")
    want = ref.load("app", strategy=strategy)
    port = _pkg("repro_torch").Workspace.open(ref.root, epoch_cache=_pkg("repro_torch").EpochCache())
    got = port.load("app", strategy=strategy)
    if strategy == "lazy":
        names = ("kernel:flash_attention", "kernel:rmsnorm", "kernel:fused_swiglu")
        assert [got[n] for n in names] == [want[n] for n in names]
    else:
        assert got.kernels == want.kernels
        assert got.kernels["kernel:rmsnorm"] == "kernels:prod:1"
    np.testing.assert_array_equal(np.asarray(got["w/a"]), np.asarray(want["w/a"]))


def test_interposed_kernel_binding_equals_the_references(tmp_path):
    """``kernels:debug`` interposed ahead of ``kernels:prod`` rebinds rmsnorm
    alike in both packages, and the relocation tables' JSON exports agree."""

    def scenario(pkg, root):
        ws = _kernel_world(pkg, root, weak=False)
        with ws.management() as tx:
            tx.publish(pkg.build_app("app", [pkg.SymbolRef("kernel:rmsnorm", (), "kernel"),
                                             pkg.SymbolRef("w/a", (6,), "float32")],
                                     ["kernels:debug", "weights", "kernels:prod"]))
        img = ws.load("app", strategy="stable")
        return img.kernels, pkg.inspector.to_json(img.table)

    (ref_k, ref_j), (port_k, port_j) = _both(scenario, tmp_path)
    assert port_k == ref_k == {"kernel:rmsnorm": "kernels:debug:7"}
    assert port_j == ref_j


def _inspector_world(pkg, root):
    ws = pkg.Workspace.open(root, epoch_cache=pkg.EpochCache())
    libfoo = pkg.build_bundle("libfoo", {"foo/a": np.ones(4, np.float32),
                                         "foo/b": np.ones(8, np.float32)})
    libbar = pkg.build_bundle("libbar", {"baz": np.ones(2, np.float32)})
    app = pkg.build_app("app1", [pkg.SymbolRef("foo/a", (4,), "float32"),
                                 pkg.SymbolRef("foo/b", (8,), "float32"),
                                 pkg.SymbolRef("baz", (2,), "float32")],
                        ["libfoo", "libbar"])
    with ws.management() as tx:
        tx.publish(*libfoo)
        tx.publish(*libbar)
        tx.publish(app)
    return ws, libfoo[0]


def test_inspector_exports_equal_the_references(tmp_path):
    """``test_core_inspector``'s exports: the table's JSON and CSV and the
    bundle's ABI records, the same text in both packages."""

    def scenario(pkg, root):
        ws, libfoo = _inspector_world(pkg, root)
        img = ws.load("app1", strategy="stable")
        return (pkg.inspector.to_json(img.table), pkg.inspector.to_csv(img.table),
                json.dumps(pkg.inspector.abi_records(libfoo), sort_keys=True))

    ref, port = _both(scenario, tmp_path)
    assert port == ref


def test_table_files_equal_the_references(tmp_path):
    """A commit writes the same relocation tables, file for file and byte
    for byte (tables are keyed by content hashes, which agree)."""

    def scenario(pkg, root):
        ws, _ = _inspector_world(pkg, root)
        ws.load("app1", strategy="stable")
        return {p.name: p.read_bytes() for p in sorted((Path(ws.root) / "tables").iterdir())
                if p.is_file()}

    ref, port = _both(scenario, tmp_path)
    assert port and port == ref


def test_journal_rows_and_preview_equal_the_references(tmp_path):
    """``test_link_journal``'s staged ops: the journal's rows (but their
    wall-clock ``ts``) and the preview's relocation records agree."""

    def scenario(pkg, root):
        ws, _ = _inspector_world(pkg, root)
        with ws.management() as tx:
            tx.publish(*pkg.build_bundle("libfoo", {"foo/a": np.zeros(4, np.float32),
                                                    "foo/b": np.ones(8, np.float32)},
                                         version="2"))
            tx.publish(*pkg.build_bundle("tmp", {"t": np.zeros(2, np.float32)}))
            tx.remove("tmp")
            rows = [{k: v for k, v in e.to_json().items() if k != "ts"}
                    for e in tx.journal_entries()]
            preview = pkg.inspector.preview_records(tx.preview())
        return rows, json.dumps(preview, sort_keys=True, default=str)

    ref, port = _both(scenario, tmp_path)
    assert port == ref
    assert [r["op"] for r in port[0]] == ["publish", "publish", "remove"]
