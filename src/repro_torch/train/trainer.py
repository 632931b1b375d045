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
   Optimizer symbols are WEAK references: they resolve to RelocType.INIT
   (zeros — the correct Adam init) before the first checkpoint and to
   DIRECT bindings afterwards, so restart-resume and cold-start are the
   same code path.
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
  (``DTensor.from_local``, replicated, no copy), so the step still trains
  the arena in place;
* on a larger mesh, every rank does a ``stable`` load of the whole state
  and keeps its shard (``distribute_tensor``), as the reference's
  ``device_put`` does; a load that reads only a rank's pages is ROADMAP
  item 13;
* rank 0 alone opens the store at construction and does management (the
  first publish and each checkpoint's publish); every rank waits at a
  barrier before each load, and the others open the store then, on the
  newest committed world (a store two ranks create at once could lose
  rank 0's state); ``TrainResult.checkpoint_saves`` counts rank 0's;
* a checkpoint gathers each leaf (``full_tensor``, a collective every rank
  joins) and rank 0 publishes it.

Departures from the reference: no AOT executable cache (the step runs
eagerly: ``compile_source`` reads ``"eager"``; caching a captured CUDA
graph of the step is ROADMAP Queue B2 item 3); the workspace bakes no host arenas
(``bake_arenas=False``: no start reads one); a RuntimeError that recurs past
``MAX_RESTARTS`` restarts is raised instead of retried for ever;
``TrainResult`` also carries each step's wall
time; the trainer keeps
its live state (``params``, ``opt_state``, ``image``) after ``run``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch import models
from repro_torch.ckpt import Checkpointer, bundle_from_params
from repro_torch.core import ObjectKind, SymbolRef, make_object
from repro_torch.data import Prefetcher, SyntheticTokens, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_step, make_train_fn
from repro_torch.link import Workspace
from repro_torch.optim import OptConfig


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
        if self.rank == 0:
            self._open()
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.app_name = f"train:{cfg.name}:{shape.name}"
        self.weights_name = f"weights:{cfg.name}"
        self.opt_name = f"opt:{cfg.name}"
        self.ckpt = Checkpointer(self.manager, self.weights_name, self.opt_name)
        self.image = self.params = self.opt_state = None

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
    def _startup(self):
        """Epoch-path startup: one table-driven load into a device arena;
        the state is views of it."""
        t0 = time.perf_counter()
        if self.mesh is not None:
            torch.distributed.barrier()  # rank 0's publish is committed
            if self.rank != 0:
                self._open()             # the newest committed world
        image = self.ws.load(self.app_name, strategy="stable", device=self.device)
        params, m_state, v_state = {}, {}, {}
        for n in models.param_specs(self.cfg):
            t = image.tensors[n]
            if t.is_inference():
                raise RuntimeError(f"{n}: an inference-mode tensor cannot be trained")
            params[n] = t
            m_state[n] = image.tensors[f"opt/m/{n}"]
            v_state[n] = image.tensors[f"opt/v/{n}"]
        step_t = image.tensors["opt/step"].view(())
        step0 = int(step_t)
        opt_state = {"m": m_state, "v": v_state, "step": step_t}
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
            params, opt_state = self._place(params, opt_state, bundle.shardings)
            step_fn = bundle.jitted
        st = image.stats
        if self.mesh is not None and self.mesh.size() > 1:
            image = None                 # each rank keeps copies of its shards
        startup = {
            "strategy": st.strategy,
            "load_s": st.startup_s,
            "upload_s": st.upload_s,
            "kernel_s": st.kernel_s,
            "host_rows_s": st.host_rows_s,
            "compile_source": "eager",
            "total_s": time.perf_counter() - t0,
            "resume_step": step0,
        }
        self.image, self.params, self.opt_state = image, params, opt_state
        return params, opt_state, step_fn, step0, startup

    def _place(self, params: dict, opt_state: dict, shardings: dict):
        """The loaded state as DTensors at the step's shardings: views of
        the arena on a mesh of one device, each rank's shards otherwise.
        Params become leaves that require grad."""
        from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

        mesh = self.mesh
        if mesh.size() == 1:
            repl = [Replicate()] * mesh.ndim
            wrap = lambda t, _: DTensor.from_local(t.detach(), mesh, repl,
                                                    run_check=False)
        else:
            wrap = lambda t, pl: distribute_tensor(t.detach(), mesh, pl,
                                                   src_data_rank=None)
        p_sh, o_sh = shardings["params"], shardings["opt"]
        params = {n: wrap(t, p_sh[n]).requires_grad_() for n, t in params.items()}
        opt_state = {
            "m": {n: wrap(t, o_sh["m"][n]) for n, t in opt_state["m"].items()},
            "v": {n: wrap(t, o_sh["v"][n]) for n, t in opt_state["v"].items()},
            "step": wrap(opt_state["step"], o_sh["step"]),
        }
        return params, opt_state

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
            # drop the last arena before loading the next one
            params = opt_state = batch = metrics = None
            self.image = self.params = self.opt_state = None
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
                            transform=lambda b: to_device(b, self.device))
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
