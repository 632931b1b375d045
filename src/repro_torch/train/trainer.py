"""The trainer: stable-linked job startup + fault-tolerant loop, the
port of the reference's ``train/trainer.py``.

Lifecycle (maps 1:1 onto the paper's Figure 4):

1. management time — register the application (its SymbolRefs come from the
   model's param specs), the initial weight bundle, and an empty optimizer
   bundle; ``end_mgmt`` materializes relocation tables.
2. epoch — every (re)start loads params AND optimizer state through the
   relocation table (``ws.load(strategy="stable", device=...)``), which
   builds one arena on the device with one ``paged_reloc_copy`` launch;
   the params and moments ARE views of that arena (the params made
   trainable leaves, nothing copied), and the step trains them in place.
   The step comes from the compile cache (``ws.compile_cache``), keyed by
   the program's identity only: arch, shape, mesh, microbatches, impl,
   the device and the arena's slot layout (the compiled step owns
   addresses, so the layout is part of what it is). The first start
   compiles it (``train/program.py``: on the card a CUDA graph of the
   step, captured once; on the CPU the same step run eagerly over the
   same buffers); a restart looks the key up before its load, hits, and
   loads its world INTO the program's arena (``ws.load(..., into=)``), so
   the cached program trains the restart's state with no recompile.
   Optimizer symbols are WEAK references: they resolve to RelocType.INIT
   (zeros — the correct Adam init) before the first checkpoint and to
   DIRECT bindings afterwards, so restart-resume and cold-start are the
   same code path (and the same slot layout, hence the same key).
3. checkpoints are management-time events (``ckpt.Checkpointer``, async):
   they publish new bundles and re-materialize, so recovery after a failure
   is an epoch-path (fast) startup from the newest world. The resume step
   is read from the restored ``opt/step`` tensor — no sidecar metadata.

Fault tolerance: injectable failure (tests), per-step deadline -> straggler
counter; a RuntimeError in the loop is a node failure, and the job restarts
from the newest checkpoint.

The mesh (``mesh=``, a ``DeviceMesh`` from ``launch/mesh.py``): without
one, the step is ``make_train_fn`` on the arena's views. With one, the
step is ``build_step``'s, as the reference's ``_startup`` builds it, and
every leaf is a DTensor at the mesh's shardings:

* on a mesh whose every axis has size 1, the arena's views are wrapped
  (``DTensor.from_local`` at the step's own placements, no copy), so the
  step trains the arena in place and places nothing itself;
* on a larger mesh, every rank does a ``stable`` load of the whole state
  and keeps its shard (``distribute_tensor``), as the reference's
  ``device_put`` does; at a restart the program's shards take the
  load's values (``StepProgram.load_state``); a load that reads only a
  rank's pages is ROADMAP item 13;
* rank 0 alone opens the store at construction and does management (the
  first publish and each checkpoint's publish); every rank waits at a
  barrier before each load, and the others open the store then, on the
  newest committed world (a store two ranks create at once could lose
  rank 0's state); ``TrainResult.checkpoint_saves`` counts rank 0's;
* a checkpoint gathers each leaf (``full_tensor``, a collective every rank
  joins) and rank 0 publishes it.

Departures from the reference: the compiled step is a captured CUDA
graph, which has no serialized form, so the cache is memory-only (the
reference's own fallback where executables cannot be serialized):
``compile_source`` reads ``"compiled"`` at the first start and
``"memory"`` at a restart, never ``"disk"``; each start also records
``compiled_as`` (``"cuda_graph"`` or ``"eager"``), ``lower_s`` and
``compile_s``; the workspace bakes no host arenas
(``bake_arenas=False``: no start reads one); a RuntimeError that recurs past
``MAX_RESTARTS`` restarts is raised instead of retried for ever;
``TrainResult`` also carries each step's wall
time; the trainer keeps
its live state (``params``, ``opt_state``, ``image``) after ``run``.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch import models
from repro_torch.ckpt import Checkpointer, bundle_from_params
from repro_torch.core import ObjectKind, SymbolRef, cache_key, make_object
from repro_torch.core.device_arena import slot_layout_digest
from repro_torch.core.relocation import build_arena_layout
from repro_torch.data import Prefetcher, SyntheticTokens, make_batch, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_step, make_train_fn, place_state
from repro_torch.link import Workspace
from repro_torch.optim import OptConfig

from .program import LoweredStep


# a RuntimeError that recurs after this many restarts is raised
MAX_RESTARTS = 3


@dataclass
class TrainConfig:
    steps: int = 20
    checkpoint_every: int = 10
    microbatches: int = 1
    seed: int = 0
    impl: str = "chunked"
    step_deadline_s: float = 0.0       # 0 = no straggler detection
    fail_at_step: int = -1             # failure injection (tests)
    opt: OptConfig = field(default_factory=OptConfig)


@dataclass
class TrainResult:
    losses: list
    steps_done: int
    restarts: int
    stragglers: int
    startup_stats: list
    checkpoint_saves: int
    step_s: list                       # wall seconds of each step run


def _opt_refs(cfg) -> list[SymbolRef]:
    refs = []
    for name, s in models.param_specs(cfg).items():
        refs.append(SymbolRef(f"opt/m/{name}", tuple(s.shape), "float32", weak=True))
        refs.append(SymbolRef(f"opt/v/{name}", tuple(s.shape), "float32", weak=True))
    refs.append(SymbolRef("opt/step", (1,), "int32", weak=True))
    return refs


class Trainer:
    def __init__(self, registry_root, cfg, shape, tcfg: TrainConfig, *,
                 device="cuda", mesh=None):
        self.device = resolve_device(device)     # raises without a card
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot train on {device!r}")
            if self.device.type == "cuda":       # this rank's card
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.registry_root = registry_root
        # on a mesh only rank 0 opens the store here; the others open it
        # at each start, after rank 0's commit (``_startup``)
        self.ws = self.registry = self.manager = self.executor = None
        self.compile_cache = None
        if self.rank == 0:
            self._open()
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.app_name = f"train:{cfg.name}:{shape.name}"
        self.weights_name = f"weights:{cfg.name}"
        self.opt_name = f"opt:{cfg.name}"
        self.ckpt = Checkpointer(self.manager, self.weights_name, self.opt_name)
        self.image = self.params = self.opt_state = self.program = None

    # ------------------------------------------------------------- publish
    @property
    def rank(self) -> int:
        """This process's rank on the mesh's group (0 without a mesh)."""
        return 0 if self.mesh is None else torch.distributed.get_rank()

    def _open(self) -> None:
        # every start is a device load through the page table, which never
        # reads a baked host arena: baking one would write a second copy of
        # the whole state at every checkpoint
        self.ws = Workspace.open(self.registry_root, bake_arenas=False)
        # engine-room views of the workspace (Checkpointer + tests use them)
        self.registry = self.ws.registry
        self.manager = self.ws.manager
        self.executor = self.ws.executor
        # a rank that reopens the store at each start keeps its compiled step
        if self.compile_cache is None:
            self.compile_cache = self.ws.compile_cache
        self.ws.compile_cache = self.compile_cache

    def publish(self, params_np: Optional[dict] = None) -> None:
        """Initial management time: app + bundles, one transaction.
        ``params_np`` (numpy arrays or tensors, e.g. the reference's init)
        defaults to ``models.init_params`` from the seed, on the device.
        On a mesh only rank 0 publishes (the others' call is a no-op)."""
        if self.rank != 0:
            return
        specs = models.param_specs(self.cfg)
        if params_np is None:
            params_np = models.init_params(self.cfg, self.tcfg.seed, self.device)
        wobj, wpl = bundle_from_params(
            self.weights_name, "init", params_np, specs=specs, meta={"step": 0}
        )
        oobj, opl = bundle_from_params(self.opt_name, "init", {}, meta={})
        app, _ = make_object(
            name=self.app_name,
            version="1",
            kind=ObjectKind.APPLICATION,
            refs=list(models.manifest_refs(self.cfg)) + _opt_refs(self.cfg),
            needed=[self.weights_name, self.opt_name],
            meta={"arch": self.cfg.name, "shape": self.shape.name},
        )
        with self.ws.management() as tx:
            tx.publish(wobj, wpl)
            tx.publish(oobj, opl)
            tx.publish(app)

    # --------------------------------------------------------------- start
    def _program_key(self) -> str:
        """The compiled step's key: the reference's parts (arch, shape, mesh
        shape, microbatches, impl), the device, and a digest of the arena's
        slot layout, made from the app's refs before any load."""
        app = self.ws.manager.world().resolve(self.app_name)
        slots, _ = build_arena_layout(app.refs)
        mesh = "none" if self.mesh is None else "x".join(map(str, self.mesh.shape))
        return cache_key(self.cfg.name, self.shape.name, mesh,
                         f"mb{self.tcfg.microbatches}", self.tcfg.impl,
                         str(self.device), slot_layout_digest(slots))

    def _state_of(self, image) -> tuple:
        """(params, opt_state): views of the image's slots."""
        names = list(models.param_specs(self.cfg))
        params = {n: image.tensors[n] for n in names}
        opt_state = {"m": {n: image.tensors[f"opt/m/{n}"] for n in names},
                     "v": {n: image.tensors[f"opt/v/{n}"] for n in names},
                     "step": image.tensors["opt/step"].view(())}
        return params, opt_state

    def _lower(self, image, step0: int):
        """The step lowered over the image's state (module docstring)."""
        params, opt_state = self._state_of(image)
        for n, t in params.items():
            if t.is_inference():
                raise RuntimeError(f"{n}: an inference-mode tensor cannot be trained")
        if self.mesh is None:
            params = {n: t.requires_grad_() for n, t in params.items()}
            step_fn = make_train_fn(
                self.cfg, self.tcfg.opt, num_microbatches=self.tcfg.microbatches,
                impl=self.tcfg.impl,
            )
        else:
            bundle = build_step(
                self.cfg, self.shape, self.mesh, opt_cfg=self.tcfg.opt,
                num_microbatches=self.tcfg.microbatches, impl=self.tcfg.impl,
            )
            params, opt_state = place_state(params, opt_state, bundle.shardings,
                                            self.mesh)
            step_fn = bundle.jitted
        batch = make_batch(
            vocab_size=self.cfg.vocab_size, global_batch=self.shape.global_batch,
            seq_len=self.shape.seq_len, step=step0, seed=self.tcfg.seed,
            with_frames=self.cfg.d_model if self.cfg.is_encdec else 0,
        )
        sharded = self.mesh is not None and self.mesh.size() > 1
        return LoweredStep(step_fn, params, opt_state, to_device(batch, self.device),
                           device=self.device, image=None if sharded else image)

    def _startup(self):
        """Epoch-path startup: the compiled step looked up by program
        identity, one table-driven load into a device arena (the program's
        own on a hit), and the step compiled on a miss."""
        t0 = time.perf_counter()
        if self.mesh is not None:
            torch.distributed.barrier()  # rank 0's publish is committed
            if self.rank != 0:
                self._open()             # the newest committed world
        key = self._program_key()
        program = self.compile_cache.get(key)
        into = None if program is None else program.image
        image = self.ws.load(self.app_name, strategy="stable", device=self.device,
                             into=into)
        step0 = int(image.tensors["opt/step"].view(()))
        program, cstats = self.compile_cache.get_or_compile(
            key, lambda: self._lower(image, step0))
        if cstats.source == "memory" and program.image is None:
            # each rank's shards: the program's take the load's values
            program.load_state(*self._state_of(image))
        st = image.stats
        if program.image is None:
            image = None                 # each rank keeps copies of its shards
        startup = {
            "strategy": st.strategy,
            "load_s": st.startup_s,
            "upload_s": st.upload_s,
            "kernel_s": st.kernel_s,
            "host_rows_s": st.host_rows_s,
            "compile_source": cstats.source,
            "compiled_as": program.compiled_as,
            "lower_s": cstats.lower_s,
            "compile_s": cstats.compile_s,
            "total_s": time.perf_counter() - t0,
            "resume_step": step0,
        }
        self.image, self.program = image, program
        self.params, self.opt_state = program.params, program.opt_state
        return program.params, program.opt_state, program, step0, startup

    def _checkpoint(self, step: int, params: dict, opt_state: dict) -> None:
        """Save a checkpoint: directly without a mesh; on one, every rank
        gathers each leaf and rank 0 publishes."""
        if self.mesh is None:
            self.ckpt.save(step, params, opt_state)
            return
        full = lambda d: {n: t.full_tensor() for n, t in d.items()}
        host_p = full(params)
        host_o = {"m": full(opt_state["m"]), "v": full(opt_state["v"]),
                  "step": opt_state["step"].full_tensor()}
        if self.rank == 0:
            self.ckpt.save(step, host_p, host_o)

    # ----------------------------------------------------------------- run
    def run(self) -> TrainResult:
        tcfg = self.tcfg
        losses: list[float] = []
        step_s: list[float] = []
        restarts = 0
        stragglers = 0
        startup_stats = []
        failed_once = tcfg.fail_at_step < 0
        done = False
        wait_s = None                    # the checkpoint wait before a restart

        while not done:
            # drop the last start's references (a cached program keeps its
            # own state, into which the next start loads)
            params = opt_state = batch = metrics = None
            self.image = self.params = self.opt_state = self.program = None
            params, opt_state, step_fn, step, startup = self._startup()
            if wait_s is not None:
                startup["ckpt_wait_s"] = wait_s
            startup_stats.append(startup)
            data = SyntheticTokens(
                vocab_size=self.cfg.vocab_size,
                global_batch=self.shape.global_batch,
                seq_len=self.shape.seq_len,
                seed=tcfg.seed,
                start_step=step,
                with_frames=self.cfg.d_model if self.cfg.is_encdec else 0,
            )
            it = Prefetcher(data, depth=2,
                            transform=functools.partial(to_device, device=self.device))
            try:
                for batch in it:
                    if step >= tcfg.steps:
                        done = True
                        break
                    if step == tcfg.fail_at_step and not failed_once:
                        failed_once = True
                        raise RuntimeError("injected node failure")
                    t0 = time.perf_counter()
                    params, opt_state, metrics = step_fn(params, opt_state, batch)
                    losses.append(float(metrics["loss"]))
                    step_s.append(time.perf_counter() - t0)
                    if tcfg.step_deadline_s and step_s[-1] > tcfg.step_deadline_s:
                        stragglers += 1
                    step += 1
                    if step % tcfg.checkpoint_every == 0:
                        self._checkpoint(step, params, opt_state)
                else:
                    done = True
            except RuntimeError:
                restarts += 1
                if restarts > MAX_RESTARTS:
                    raise
                t0 = time.perf_counter()
                self.ckpt.wait()   # recovery: epoch path from newest world
                wait_s = time.perf_counter() - t0
                continue
            finally:
                it.close()
        self.ckpt.wait()
        return TrainResult(
            losses=losses,
            steps_done=step,
            restarts=restarts,
            stragglers=stragglers,
            startup_stats=startup_stats,
            checkpoint_saves=self.ckpt.saves,
            step_s=step_s,
        )
