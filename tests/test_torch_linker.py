"""The port's copy of the linker reads and writes the reference's on-disk
format byte for byte, bfloat16 included (which the port holds as a 2-byte
stand-in, without ml_dtypes).

Arenas are compared slot by slot: the bytes between page-aligned slots of
a freshly allocated arena are uninitialised in both packages."""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import build_app, build_bundle
from repro.core import EpochCache as RefEpochCache
from repro.core import SymbolRef as RefSymbolRef
from repro.core.executor import Executor as RefExecutor
from repro.link import Workspace as RefWorkspace
from repro_torch.ckpt import bundle_from_params
from repro_torch.core import EpochCache, ObjectKind, SymbolRef, make_object
from repro_torch.core.resolver import cast_elements
from repro_torch.link import Workspace

STRATEGIES = ["stable", "stable-mmap", "stable-mmap-cached", "dynamic", "indexed"]
_SUMMARY_KEYS = ("app", "epoch", "world_hash", "source", "relocations",
                 "arena_bytes", "by_type", "providers")


def _tensors():
    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal((3, 8, 16)).astype(np.float32),
        "e": rng.standard_normal((32, 8)).astype(ml_dtypes.bfloat16),
        "b": rng.standard_normal((5,)).astype(np.float64),
        "n": rng.integers(-9, 9, (7,)).astype(np.int32),
        "h": rng.standard_normal((4, 4)).astype(np.float32),
        "g": rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16),
    }


# (name, shape, dtype): DIRECT, SLICE, bf16 DIRECT, bf16->f32 and f32->bf16
# CASTs, f64->f32 CAST, int32 DIRECT, and a weak INIT
_REFS = [
    ("w", (3, 8, 16), "float32"),
    ("w[1]", (8, 16), "float32"),
    ("e", (32, 8), "bfloat16"),
    ("b", (5,), "float32"),
    ("n", (7,), "int32"),
    ("h", (4, 4), "bfloat16"),
    ("g", (4, 8), "float32"),
]


def _ref_app():
    refs = [RefSymbolRef(n, s, d) for n, s, d in _REFS]
    refs.append(RefSymbolRef("missing", (4,), "bfloat16", weak=True))
    return build_app("app", refs, ["lib"])


def _arena(image) -> tuple[int, dict]:
    """(arena size, {slot: bytes}) — everything but inter-slot padding."""
    slots = {n: np.asarray(a).tobytes() for n, a in image.tensors.items()}
    return np.asarray(image.arena).nbytes, slots


@pytest.fixture()
def ref_root(tmp_path):
    ws = RefWorkspace.open(tmp_path / "store", epoch_cache=RefEpochCache())
    with ws.management() as tx:
        tx.publish(*build_bundle("lib", _tensors()))
        tx.publish(_ref_app())
    return ws


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_port_loads_reference_root_byte_identical(ref_root, strategy):
    want = ref_root.load("app", strategy=strategy)
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    got = port.load("app", strategy=strategy)
    assert _arena(got) == _arena(want)
    # bfloat16 symbols come back as the 2-byte stand-in, never as a cast
    assert got.tensors["e"].dtype == np.dtype("<u2")


def test_explain_summaries_equal(ref_root):
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    fresh_ref = RefWorkspace.open(ref_root.root, epoch_cache=RefEpochCache())
    a = fresh_ref.explain("app").summary()
    b = port.explain("app").summary()
    assert {k: a[k] for k in _SUMMARY_KEYS} == {k: b[k] for k in _SUMMARY_KEYS}
    assert b["by_type"].get("CAST", 0) == 3


def test_bf16_cast_relocation_matches_reference_executor(ref_root):
    # values: the CAST rows of the port's arena equal the reference's, and
    # equal an independent conversion of the published values
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    got = port.load("app", strategy="dynamic")
    want = ref_root.load("app", strategy="dynamic")
    t = _tensors()
    f32_from_bf16 = t["e"].astype(np.float32)
    bf16_from_f32 = t["h"].astype(ml_dtypes.bfloat16)
    assert np.array_equal(got.tensors["h"], bf16_from_f32.view(np.uint16))
    assert np.array_equal(got.tensors["g"], t["g"].astype(np.float32))
    assert np.array_equal(got.tensors["g"], np.asarray(want.tensors["g"]))
    assert np.array_equal(got.tensors["b"], t["b"].astype(np.float32))
    assert np.array_equal(np.asarray(want.tensors["h"]).view(np.uint16),
                          got.tensors["h"])
    # and the cast helper itself: bf16 <-> f32 round to nearest even
    raw = f32_from_bf16.view(np.uint8)
    back = cast_elements(raw.ravel(), "float32", "bfloat16")
    assert np.array_equal(back, t["e"].view(np.uint16).ravel())
    up = cast_elements(t["e"].view(np.uint8).ravel(), "bfloat16", "float32")
    assert np.array_equal(up, f32_from_bf16.ravel())


def test_bf16_cast_into_bf16_app_via_lazy_reader(ref_root):
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    lazy = port.load("app", strategy="lazy")
    want = ref_root.load("app", strategy="lazy")
    for name in ("h", "g", "b", "e", "w[1]", "missing"):
        assert np.asarray(lazy[name]).tobytes() == np.asarray(want[name]).tobytes(), name


def test_cast_that_torch_cannot_do_raises():
    with pytest.raises(TypeError, match="torch has no"):
        cast_elements(np.zeros(4, np.uint8), "bfloat16", "float8_e4m3fnuz_x")


def _port_publish(root):
    g = torch.Generator().manual_seed(5)
    params = {
        "x": torch.randn((6, 32), generator=g).to(torch.bfloat16),
        "y": torch.randn((2, 4, 8), generator=g),
    }
    ws = Workspace.open(root, epoch_cache=EpochCache())
    bundle, payload = bundle_from_params("lib", "1", params)
    app, _ = make_object(
        name="app", version="1", kind=ObjectKind.APPLICATION,
        refs=[SymbolRef("x", (6, 32), "bfloat16"),
              SymbolRef("y[1]", (4, 8), "float32"),
              SymbolRef("y", (2, 4, 8), "bfloat16")],
        needed=["lib"],
    )
    with ws.management() as tx:
        tx.publish(bundle, payload)
        tx.publish(app)
    return ws, params


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_reference_loads_port_root_byte_identical(tmp_path, strategy):
    port, params = _port_publish(tmp_path / "store")
    syms = {s.name: s for s in port.world().resolve("lib").symbols.values()}
    assert syms["x"].dtype == "bfloat16"        # not the stand-in's int16
    want = port.load("app", strategy=strategy)
    ref = RefWorkspace.open(port.root, epoch_cache=RefEpochCache())
    got = ref.load("app", strategy=strategy)
    assert _arena(got) == _arena(want)
    x = np.asarray(got.tensors["x"])
    assert x.dtype == ml_dtypes.bfloat16
    assert np.array_equal(x.astype(np.float32), params["x"].float().numpy())
    y_bf16 = np.asarray(got.tensors["y"]).astype(np.float32)
    assert np.array_equal(y_bf16, params["y"].to(torch.bfloat16).float().numpy())


def test_reference_executor_and_port_agree_on_cast_bytes(tmp_path):
    """The same CAST table applied by each package's Executor."""
    port, _ = _port_publish(tmp_path / "store")
    ref = RefWorkspace.open(port.root, epoch_cache=RefEpochCache())
    assert isinstance(ref.executor, RefExecutor)
    a = ref.load("app", strategy="dynamic")
    b = port.load("app", strategy="dynamic")
    assert _arena(a) == _arena(b)
