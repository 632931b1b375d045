"""The port's paged relocation copy and its device-arena epoch loads,
against the reference: the plain version against the JAX kernel (interpret
mode) and its oracle, and arenas built "on a device" (here the CPU, through
the same code path the card takes) against both packages' host images."""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import build_app, build_bundle
from repro.core import EpochCache as RefEpochCache
from repro.core import SymbolRef as RefSymbolRef
from repro.kernels.paged_reloc_copy import paged_reloc_copy as ref_kernel
from repro.kernels.paged_reloc_copy import paged_reloc_copy_ref
from repro.kernels.paged_reloc_copy import ops as ref_ops
from repro.link import Workspace as RefWorkspace
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.core import EpochCache, RelocationTable, RelocType, compile_page_table
from repro_torch.core import np_dtype
from repro_torch.core.errors import AdoptDeadlineError
from repro_torch.kernels.paged_reloc_copy import ops as prc
from repro_torch.link import Workspace
from repro_torch.serve import ServeEngine, faults

TABLE_STRATEGIES = ["stable", "prefetch", "dynamic", "indexed", "auto"]
HOST_ONLY = ["stable-mmap", "stable-mmap-cached", "stable-shm", "stable-remote",
             "lazy"]


def _case(n_pages, n_copies, seed):
    rng = np.random.default_rng(seed)
    blob = rng.integers(-(2**31), 2**31 - 1, (n_pages, 8, 128), dtype=np.int32)
    arena = rng.integers(-(2**31), 2**31 - 1, (n_pages, 8, 128), dtype=np.int32)
    src = rng.integers(0, n_pages, n_copies, dtype=np.int32)
    dst = rng.permutation(n_pages)[:n_copies].astype(np.int32)
    return blob, arena, src, dst


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("n_pages,n_copies", [(4, 2), (64, 64), (128, 37), (16, 0)])
def test_plain_copy_matches_reference_kernel_and_oracle(n_pages, n_copies):
    blob, arena, src, dst = _case(n_pages, n_copies, seed=n_pages)
    args = [jnp.asarray(a) for a in (blob, arena, src, dst)]
    want_k = np.asarray(ref_kernel(*args, interpret=True))
    want_r = np.asarray(paged_reloc_copy_ref(*args))
    before = prc.launches
    got = prc.paged_reloc_copy(torch.from_numpy(blob), torch.from_numpy(arena.copy()),
                               src, dst)
    assert prc.launches == before            # the CPU takes the plain version
    assert np.array_equal(got.numpy(), want_k)
    assert np.array_equal(got.numpy(), want_r)


def test_plain_copy_preserves_untouched_pages():
    blob = torch.zeros((4, 8, 128), dtype=torch.int32)
    arena = torch.full((8, 8, 128), 7, dtype=torch.int32)
    got = prc.paged_reloc_copy(blob, arena, np.array([0]), np.array([3]))
    assert got is arena                       # in place
    assert bool((got[3] == 0).all())
    assert bool((got[[0, 1, 2, 4, 5, 6, 7]] == 7).all())


def test_apply_page_table_and_page_helpers_match_reference():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 255, 3 * 4096 + 100, dtype=np.uint8).tobytes()
    pages = prc.as_pages(raw, 5)
    assert np.array_equal(pages, ref_ops.as_pages(raw, 5))
    assert prc.pages_to_bytes(torch.from_numpy(pages)) == ref_ops.pages_to_bytes(pages)

    class PT:                                   # the fields apply_page_table reads
        src_page = np.array([4, 0, 2], np.int32)
        dst_page = np.array([1, 2, 0], np.int32)

    arena = np.zeros((3, 8, 128), np.int32)
    want = np.asarray(ref_ops.apply_page_table(PT, pages, arena, impl="ref"))
    got = prc.apply_page_table(PT, torch.from_numpy(pages), torch.from_numpy(arena.copy()))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,dst,err", [
    ([0, 9], [0, 1], IndexError),        # src past the blob
    ([0, -1], [0, 1], IndexError),       # negative src
    ([0, 1], [0, 8], IndexError),        # dst past the arena
    ([0, 1], [2, 2], ValueError),        # duplicate dst
    ([0, 1], [2], ValueError),           # lengths differ
])
def test_index_checks_raise_before_any_copy(src, dst, err):
    blob = torch.arange(4 * 1024, dtype=torch.int32).reshape(4, 8, 128)
    arena = torch.zeros((8, 8, 128), dtype=torch.int32)
    with pytest.raises(err):
        prc.paged_reloc_copy(blob, arena, np.array(src), np.array(dst))
    assert not arena.any()


def test_wrapper_rejects_bad_pages_and_devices():
    good = torch.zeros((2, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        prc.paged_reloc_copy(good.float(), good, [0], [0])
    with pytest.raises(ValueError, match="no kernel"):
        prc.paged_reloc_copy(good.to("meta"), good.to("meta"), [0], [0])


# ---------------------------------------------- device arenas, on the CPU
def _tensors():
    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal((3, 8, 16)).astype(np.float32),
        "e": rng.standard_normal((32, 8)).astype(ml_dtypes.bfloat16),
        "h": rng.standard_normal((4, 4)).astype(np.float32),
        "n": rng.integers(-9, 9, (7,)).astype(np.int32),
        "big": rng.standard_normal((3000,)).astype(ml_dtypes.bfloat16),
    }


# DIRECT, SLICE, bf16 DIRECT across pages, an f32 -> bf16 CAST (a host
# row), int32, and a weak INIT with no provider
_REFS = [("w", (3, 8, 16), "float32"), ("w[1]", (8, 16), "float32"),
         ("e", (32, 8), "bfloat16"), ("h", (4, 4), "bfloat16"),
         ("n", (7,), "int32"), ("big", (3000,), "bfloat16")]


@pytest.fixture()
def ref_root(tmp_path):
    ws = RefWorkspace.open(tmp_path / "store", epoch_cache=RefEpochCache())
    refs = [RefSymbolRef(n, s, d) for n, s, d in _REFS]
    refs.append(RefSymbolRef("missing", (4,), "bfloat16", weak=True))
    with ws.management() as tx:
        tx.publish(*build_bundle("lib", _tensors()))
        tx.publish(build_app("app", refs, ["lib"]))
    return ws


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


def _slot_bytes(image) -> dict:
    return {n: _bytes(t) for n, t in image.tensors.items()}


@pytest.mark.parametrize("strategy", TABLE_STRATEGIES)
def test_device_load_equals_host_images_of_both_packages(ref_root, strategy):
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    got = port.load("app", strategy=strategy, device="cpu")
    host = port.load("app", strategy=strategy)
    want = ref_root.load("app", strategy=strategy)
    assert isinstance(got.arena, torch.Tensor) and got.arena.dtype == torch.uint8
    assert got.arena.numel() == np.asarray(want.arena).nbytes
    assert _slot_bytes(got) == _slot_bytes(host) == _slot_bytes(want)
    assert got.tensors["e"].dtype == torch.bfloat16       # no 2-byte stand-in
    assert got.tensors["h"].dtype == torch.bfloat16       # the CAST host row
    assert got.table.meta["host_rows"]                    # ... really was one
    assert got.kernels == host.kernels
    s = got.stats
    assert s.io_s >= s.upload_s + s.kernel_s + s.host_rows_s > 0
    # every tensor is a view of the one arena
    base = got.arena.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in got.tensors.values())


def test_device_load_pads_with_zeros_and_compiles_a_missing_page_table(ref_root):
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    img = port.load("app", strategy="stable")
    table = img.table
    bare = RelocationTable(rows=table.rows, strtab=table.strtab,
                           objects=table.objects, meta=dict(table.meta))
    del bare.meta["host_rows"]                 # as an npz-format table loads
    app = port.world().resolve("app")
    from repro_torch.core import LoadStats

    got = port.executor._apply_table(app, bare, LoadStats(), "cpu")
    assert _slot_bytes(got) == _slot_bytes(img)
    pt = compile_page_table(table)
    assert np.array_equal(pt.src_page, table._pt_src)
    # the bytes between slots are zero, not left over from the allocator
    covered = np.zeros(got.arena.numel(), bool)
    for s in table.slots().values():
        covered[s.offset:s.offset + s.nbytes] = True
    assert not got.arena.numpy()[~covered].any()


def test_device_load_skips_zero_init_rows_and_keeps_a_custom_initializer(ref_root):
    """The weak ``missing`` symbol is an INIT row of a slot: with the zeros
    initializer the device load leaves it out (the arena is zeros already)
    and its bytes still equal the host image's; with another initializer
    the row is applied."""
    from repro_torch.core.device_arena import rows_to_apply

    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    table = port.load("app", strategy="stable").table
    rows = table.meta["host_rows"]
    init = [i for i in rows if int(table.rows["type"][i]) == int(RelocType.INIT)]
    assert init and [table.name_at(table.rows["symbol_name"][i]) for i in init] == ["missing"]
    assert rows_to_apply(port.executor, table, rows) == [i for i in rows if i not in init]
    got = port.load("app", strategy="stable", device="cpu")
    assert _bytes(got.tensors["missing"]) == bytes(8)
    assert _slot_bytes(got) == _slot_bytes(port.load("app", strategy="stable"))

    sevens = lambda name, shape, dtype: np.full(shape, 7, np.dtype(np_dtype(dtype)))
    other = Workspace.open(ref_root.root, epoch_cache=EpochCache(), initializer=sevens)
    assert rows_to_apply(other.executor, table, rows) == list(rows)
    img = other.load("app", strategy="stable", device="cpu")
    assert _bytes(img.tensors["missing"]) == np.full(4, 7, np_dtype("bfloat16")).tobytes()


def test_device_load_after_an_interposition_edit(ref_root):
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    dbg = {"w": np.full((3, 8, 16), 42.0, np.float32)}
    with port.management() as tx:
        from repro_torch.ckpt import bundle_from_params

        tx.publish(*bundle_from_params("dbg", "1", dbg))
        tx.rebind("app", symbol_glob="w", provider_name="dbg")
    got = port.load("app", strategy="stable", device="cpu")
    host = port.load("app", strategy="stable")
    assert bool((got.tensors["w"] == 42.0).all())
    assert np.array_equal(got.tensors["w[1]"].numpy(), _tensors()["w"][1])
    ref = RefWorkspace.open(port.root, epoch_cache=RefEpochCache())
    assert _slot_bytes(got) == _slot_bytes(host) == _slot_bytes(ref.load("app", strategy="stable"))


@pytest.mark.parametrize("strategy", HOST_ONLY)
def test_strategies_without_a_device_arena_raise(ref_root, strategy):
    port = Workspace.open(ref_root.root, epoch_cache=EpochCache())
    with pytest.raises(ValueError, match="Queue A item 13"):
        port.load("app", strategy=strategy, device="cpu")


# ------------------------------------------------------------- the engine
ARCH = "gemma3-1b"
PROMPT, NEW = 20, 5


@pytest.fixture()
def model_root(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve

    ws = Workspace.open(tmp_path / "m", epoch_cache=EpochCache())
    app = launch_serve.publish_model(ws, get_config(ARCH, smoke=True), device="cpu")
    return ws, app


def _commit_v2(ws, seed=1):
    from repro_torch import models
    from repro_torch.ckpt import bundle_from_params
    from repro_torch.configs import get_config

    cfg = get_config(ARCH, smoke=True)
    params = models.init_params(cfg, seed, "cpu")
    bundle, payload = bundle_from_params(
        f"weights:{cfg.name}", "v2", params, specs=models.param_specs(cfg))
    with ws.management() as tx:
        tx.publish(bundle, payload)


def _engine(ws, app):
    from repro_torch.configs import get_config

    return ServeEngine.from_workspace(get_config(ARCH, smoke=True), ws, app,
                                      strategy="stable", cache_len=PROMPT + NEW,
                                      device="cpu")


def _arena_of(engine):
    ptrs = {t.untyped_storage().data_ptr() for t in engine.params.values()}
    assert len(ptrs) == 1
    return ptrs.pop()


def test_engine_params_alias_the_device_arena_and_match_the_reference(model_root):
    from repro.configs import get_config as ref_config

    ws, app = model_root
    eng = _engine(ws, app)
    assert eng.load_stats.strategy == "stable" and eng.load_stats.kernel_s > 0
    image = ws.load(app, strategy="stable", device="cpu")     # a second arena
    assert _arena_of(eng) != image.arena.untyped_storage().data_ptr()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (2, PROMPT), dtype=np.int32)
    got, _ = eng.generate(prompts, NEW)
    ref_ws = RefWorkspace.open(ws.root, epoch_cache=RefEpochCache())
    want = RefServeEngine.from_workspace(ref_config(ARCH, smoke=True), ref_ws, app,
                                         strategy="stable", cache_len=PROMPT + NEW)
    np.testing.assert_array_equal(got, want.generate(prompts, NEW)[0])


def test_engine_lift_checks_the_device_image(model_root):
    from repro_torch.configs import get_config

    ws, app = model_root
    image = ws.load(app, strategy="stable", device="cpu")
    cfg = get_config(ARCH, smoke=True)
    bad = cfg.replace(d_model=cfg.d_model * 2)
    with pytest.raises(TypeError, match="spec"):
        ServeEngine._lift_params(bad, image, torch.device("cpu"))


def test_adopt_epoch_flips_to_a_new_device_arena(model_root):
    ws, app = model_root
    eng = _engine(ws, app)
    old_arena = _arena_of(eng)
    old = {n: t.clone() for n, t in eng.params.items()}
    _commit_v2(ws)
    image = eng.adopt_epoch(ws, app, strategy="stable", deadline_s=30.0)
    assert _arena_of(eng) == image.arena.untyped_storage().data_ptr() != old_arena
    assert eng.load_stats.strategy == "stable"
    host = ws.load(app, strategy="stable")
    for n, t in eng.params.items():
        assert _bytes(t) == _bytes(host.tensors[n]), n
    assert not all(torch.equal(old[n], eng.params[n]) for n in old)


def test_wedged_device_adopt_rolls_back_to_the_served_bytes(model_root):
    ws, app = model_root
    eng = _engine(ws, app)
    old = {n: t.clone() for n, t in eng.params.items()}
    _commit_v2(ws)
    faults.install(faults.FaultPlan(wedge_adopt_s=30.0))
    try:
        with pytest.raises(AdoptDeadlineError) as exc:
            eng.adopt_epoch(ws, app, strategy="stable", deadline_s=0.25)
    finally:
        faults.clear()
    assert exc.value.rolled_back_to == ws.epoch_gen
    assert all(torch.equal(old[n], eng.params[n]) for n in old)
    assert eng.load_stats.strategy == "stable"
