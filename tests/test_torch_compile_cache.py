"""The compile cache's executable half: the port's ``CompileCache`` against
the reference's (keys, sources, when ``lower_fn`` runs), the training
step compiled once per program identity (``train/program.py``), a restart
that loads its world into the compiled step's own arena
(``ws.load(..., into=)``), the launch counters a replay credits, and a
check that every family's step reads nothing back to the host and makes
no tensor from host data (what a CUDA graph capture would refuse).

On the CPU the compiled program is the step run eagerly over the same
buffers; the card's captured graph is held against the eager step in
``tests/test_torch_cuda.py`` (``-m cuda``) and by ``chip_smoke.py``'s
phases 11 and 12."""

from __future__ import annotations

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import CompileCache as RefCompileCache
from repro.core import cache_key as ref_cache_key
from repro_torch import kernels, models
from repro_torch.configs import ARCHS, ShapeConfig, get_config
from repro_torch.core import CompileCache, RelocType, SymbolRef, cache_key
from repro_torch.data import make_batch, to_device
from repro_torch.launch.steps import make_train_fn
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.program import LoweredStep, state_tensors
from torch_suite import build_app, build_bundle

KEY_PARTS = [
    ("gemma3-1b", "train_4k", "1x1", "mb1", "chunked"),
    ("olmoe-1b-7b", "t", "none", "mb2", "kernel", "cuda:0", "0f" * 16),
    ("", "é", "x" * 300),
    (),
]


# ------------------------------------------------------------------ the cache
@pytest.mark.parametrize("parts", KEY_PARTS, ids=lambda p: "|".join(p)[:24] or "empty")
def test_cache_key_is_the_reference_bytes(parts):
    assert cache_key(*parts) == ref_cache_key(*parts)


class _Lowered:
    def __init__(self, calls):
        self.calls = calls

    def compile(self):
        self.calls.append("compile")
        return object()


def test_get_or_compile_sources_match_the_reference_on_a_jitted_function(tmp_path):
    """The same key twice: ``"compiled"`` then ``"memory"``, as the
    reference's cache reports for a tiny ``jax.jit`` lowered on the CPU."""
    ref = RefCompileCache(tmp_path / "ref")
    (tmp_path / "ref").mkdir()
    x = jnp.ones((4,), jnp.float32)
    key = ref_cache_key("tiny", "f32")
    want = [ref.get_or_compile(key, lambda: jax.jit(lambda a: a * 2).lower(x))[1].source
            for _ in range(2)]
    port, calls = CompileCache(tmp_path / "port"), []
    got = [port.get_or_compile(cache_key("tiny", "f32"), lambda: _Lowered(calls))[1]
           for _ in range(2)]
    assert [s.source for s in got] == want == ["compiled", "memory"]
    assert calls == ["compile"]
    assert got[0].lower_s >= 0 and got[0].compile_s >= 0
    assert got[1].lower_s == got[1].compile_s == got[1].deserialize_s == 0.0
    # memory-only: nothing is serialized where the reference would write
    assert not port.path(got[0].key).exists()
    assert port.path(got[0].key).parent == tmp_path / "port"


def test_a_memory_hit_never_calls_lower_fn(tmp_path):
    cache, calls = CompileCache(tmp_path), []
    first, _ = cache.get_or_compile("k", lambda: _Lowered(calls))

    def refuse():
        raise AssertionError("lower_fn called on a hit")

    again, stats = cache.get_or_compile("k", refuse)
    assert again is first and stats.source == "memory" and calls == ["compile"]
    assert cache.get("k") is first and cache.get("other") is None


# ------------------------------------------------------- loads into an arena
def _world(tmp_path):
    from repro_torch.link import Workspace

    ws = Workspace.open(tmp_path / "ws")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 700)).astype(np.float32)
    b = rng.integers(-9, 9, (1500,), dtype=np.int32)
    with ws.management() as tx:
        tx.publish(*build_bundle("w", {"s/a": a, "s/b": b}))
        tx.publish(build_app("app", [SymbolRef("s/a", (3, 700), "float32"),
                                     SymbolRef("s/b", (1500,), "int32"),
                                     SymbolRef("opt/z", (9,), "float32", weak=True)],
                             ["w"]))
        tx.publish(build_app("other", [SymbolRef("s/b", (1500,), "int32"),
                                       SymbolRef("s/a", (3, 700), "float32")], ["w"]))
    return ws


def test_a_load_into_an_arena_overwrites_it_in_place(tmp_path):
    ws = _world(tmp_path)
    first = ws.load("app", strategy="stable", device="cpu")
    ptrs = {n: t.data_ptr() for n, t in first.tensors.items()}
    views = dict(first.tensors)
    with torch.no_grad():
        first.arena.fill_(0x5A)               # a trained state's bytes
    host = ws.load("app", strategy="stable")
    again = ws.load("app", strategy="stable", into=first)
    assert again.arena.data_ptr() == first.arena.data_ptr()
    assert {n: t.data_ptr() for n, t in again.tensors.items()} == ptrs
    for n, a in host.tensors.items():         # INIT opt/z zeroed again
        assert np.array_equal(views[n].numpy(), a), n
    # padding is zero, as in a fresh device arena
    slots = first.table.slots().values()
    used = np.zeros(first.arena.numel(), bool)
    for s in slots:
        used[s.offset:s.offset + s.nbytes] = True
    assert not again.arena.numpy()[~used].any()


def test_a_load_into_an_arena_of_another_layout_raises(tmp_path):
    ws = _world(tmp_path)
    first = ws.load("app", strategy="stable", device="cpu")
    with pytest.raises(ValueError, match="slot layout"):
        ws.load("other", strategy="stable", into=first)
    short = dataclasses.replace(first, arena=first.arena[:4096])
    with pytest.raises(ValueError, match="pages"):
        ws.load("app", strategy="stable", into=short)
    with pytest.raises(ValueError, match="builds no device arena"):
        ws.load("app", strategy="stable-mmap", into=first)


# ------------------------------------------------------------ the trainer
def _slot_bytes(arena: np.ndarray, table) -> dict:
    return {n: bytes(arena[s.offset:s.offset + s.nbytes])
            for n, s in table.slots().items()}


class _Recording(Trainer):
    """At each start: every param's and moment's address, the arena's bytes
    as loaded beside a host load of the same world, the slot layout and
    the opt/* relocation types."""

    def _startup(self):
        out = super()._startup()
        params, opt = out[0], out[1]
        table = self.image.table
        self.starts.append({
            "ptrs": [t.data_ptr() for t in state_tensors(params, opt)],
            "arena_ptr": self.image.arena.data_ptr(),
            "arena": _slot_bytes(self.image.arena.numpy(), table),
            "host": _slot_bytes(self.ws.load(self.app_name, strategy="stable").arena,
                                table),
            "slots": table.slots(),
            "opt_types": sorted({int(r["type"]) for r in table.rows
                                 if table.name_at(r["symbol_name"]).startswith("opt/")}),
            "program": out[2],
        })
        return out


def test_a_restart_hits_the_cache_and_loads_into_the_programs_arena(tmp_path):
    """A failure at step 4: the second start's program is the first's (a
    memory hit), every param and moment is the same view of the same
    arena, which holds exactly the checkpointed world's bytes (a fresh
    host load), though opt/* resolved INIT at the first start and DIRECT
    at the restart: one slot layout, one key."""
    cfg = get_config("gemma3-1b", smoke=True)
    tr = _Recording(tmp_path / "reg", cfg, ShapeConfig("t", 16, 4, "train"),
                    TrainConfig(steps=6, checkpoint_every=3, fail_at_step=4,
                                opt=OptConfig(peak_lr=1e-3, warmup_steps=2,
                                              decay_steps=6)),
                    device="cpu")
    tr.starts = []
    tr.publish()
    res = tr.run()
    assert res.restarts == 1 and res.losses[3] == res.losses[4]
    first, again = tr.starts
    assert [s["compile_source"] for s in res.startup_stats] == ["compiled", "memory"]
    assert [s["compiled_as"] for s in res.startup_stats] == ["eager", "eager"]
    assert res.startup_stats[1]["lower_s"] == res.startup_stats[1]["compile_s"] == 0.0
    assert again["program"] is first["program"] is tr.program
    assert again["ptrs"] == first["ptrs"] and again["arena_ptr"] == first["arena_ptr"]
    lo, hi = first["arena_ptr"], first["arena_ptr"] + tr.image.arena.numel()
    assert all(lo <= p < hi for p in first["ptrs"])     # views of the arena
    assert [s["opt_types"] for s in tr.starts] == [[int(RelocType.INIT)],
                                                   [int(RelocType.DIRECT)]]
    assert again["slots"] == first["slots"]
    assert again["arena"] == again["host"] and first["arena"] == first["host"]
    assert len(tr.compile_cache.memory) == 1


def test_a_dropped_trainer_frees_its_compiled_step(tmp_path):
    """Nothing outlives a finished run but what the caller keeps: on the
    card the program holds the graph's memory pool, which the next
    trainer's capture needs back."""
    cfg = get_config("gemma3-1b", smoke=True)
    tr = Trainer(tmp_path / "reg", cfg, ShapeConfig("t", 16, 4, "train"),
                 TrainConfig(steps=2, checkpoint_every=10), device="cpu")
    tr.publish()
    tr.run()
    program = weakref.ref(tr.program)
    del tr
    gc.collect()
    assert program() is None


def test_the_compiled_step_trains_only_its_own_state(tmp_path):
    cfg = get_config("gemma3-1b", smoke=True)
    params = {n: t.requires_grad_() for n, t in models.init_params(cfg, 0, "cpu").items()}
    opt = init_opt_state(params)
    batch = to_device(make_batch(vocab_size=cfg.vocab_size, global_batch=2, seq_len=8,
                                 step=0), "cpu")
    program = LoweredStep(make_train_fn(cfg, OptConfig()), params, opt, batch,
                          device="cpu").compile()
    assert program.compiled_as == "eager" and program.batch["tokens"] is not batch["tokens"]
    other = dict(params)
    with pytest.raises(ValueError, match="its own state"):
        program(other, opt, batch)
    _, _, metrics = program(params, opt, batch)
    assert int(opt["step"]) == 1 and torch.isfinite(metrics["loss"])


# ---------------------------------------------------------- launch counters
def test_counters_snapshot_set_and_credit():
    saved = kernels.counter_snapshot()
    try:
        kernels.zero_launch_counts()
        assert set(kernels.counter_snapshot().values()) == {0}
        delta = {("rmsnorm", "launches", None): 209,
                 ("rmsnorm", "backward_launches", None): 105,
                 ("rmsnorm", "backward_launches_by_route", "tma"): 105}
        for _ in range(3):
            kernels.credit_launches(delta)
        got = kernels.launch_counts()
        assert (got["rmsnorm"], got["rmsnorm_backward"]) == (627, 315)
        from repro_torch.kernels.rmsnorm import ops as rn

        assert rn.backward_launches_by_route == {"tma": 315, "two_pass": 0}
    finally:
        kernels.set_counters(saved)
    assert kernels.counter_snapshot() == saved


# ------------------------------------------------------ capture-safe steps
_HOST_OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero",
             "aten.masked_select", "aten._pin_memory", "aten._unique", "aten.unique")


class _HostOps(TorchDispatchMode):
    """Records each op that reads a value back to the host, has a
    data-dependent shape, or makes a tensor from host data."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(_HOST_OPS):
            self.seen.add(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_familys_training_step_is_capturable_on_the_host_side(arch):
    """One training step (forward, remat recompute, backward, AdamW) of each
    family's smoke config runs no op a CUDA graph capture refuses: no
    value read back (``.item()``), no data-dependent shape, no tensor made
    from host data (which goes up with a synchronised copy)."""
    cfg = get_config(arch, smoke=True)
    params = {n: t.requires_grad_() for n, t in models.init_params(cfg, 0, "cpu").items()}
    opt = init_opt_state(params)
    batch = to_device(make_batch(vocab_size=cfg.vocab_size, global_batch=2, seq_len=16,
                                 step=0, with_frames=cfg.d_model if cfg.is_encdec else 0),
                      "cpu")
    step = make_train_fn(cfg, OptConfig())
    with _HostOps() as mode:
        _, _, metrics = step(params, opt, batch)
    assert mode.seen == set(), mode.seen
    assert torch.isfinite(metrics["loss"])
