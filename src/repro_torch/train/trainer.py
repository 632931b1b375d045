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

Departures from the reference: no mesh (the multi-device slice is not
ported yet) and no AOT executable cache (the step runs eagerly:
``compile_source`` reads ``"eager"``); the workspace bakes no host arenas
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

from repro_torch import models
from repro_torch.ckpt import Checkpointer, bundle_from_params
from repro_torch.core import ObjectKind, SymbolRef, make_object
from repro_torch.data import Prefetcher, SyntheticTokens, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_fn
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
                 device="cuda"):
        self.device = resolve_device(device)     # raises without a card
        # every start is a device load through the page table, which never
        # reads a baked host arena: baking one would write a second copy of
        # the whole state at every checkpoint
        self.ws = Workspace.open(registry_root, bake_arenas=False)
        # engine-room views of the workspace (Checkpointer + tests use them)
        self.registry = self.ws.registry
        self.manager = self.ws.manager
        self.executor = self.ws.executor
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.app_name = f"train:{cfg.name}:{shape.name}"
        self.weights_name = f"weights:{cfg.name}"
        self.opt_name = f"opt:{cfg.name}"
        self.ckpt = Checkpointer(self.manager, self.weights_name, self.opt_name)
        self.image = self.params = self.opt_state = None

    # ------------------------------------------------------------- publish
    def publish(self, params_np: Optional[dict] = None) -> None:
        """Initial management time: app + bundles, one transaction.
        ``params_np`` (numpy arrays or tensors, e.g. the reference's init)
        defaults to ``models.init_params`` from the seed, on the device."""
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
        image = self.ws.load(self.app_name, strategy="stable", device=self.device)
        params, m_state, v_state = {}, {}, {}
        for n in models.param_specs(self.cfg):
            t = image.tensors[n]
            if t.is_inference():
                raise RuntimeError(f"{n}: an inference-mode tensor cannot be trained")
            params[n] = t.requires_grad_()
            m_state[n] = image.tensors[f"opt/m/{n}"]
            v_state[n] = image.tensors[f"opt/v/{n}"]
        step_t = image.tensors["opt/step"].view(())
        step0 = int(step_t)
        opt_state = {"m": m_state, "v": v_state, "step": step_t}
        step_fn = make_train_fn(
            self.cfg, self.tcfg.opt, num_microbatches=self.tcfg.microbatches,
            impl=self.tcfg.impl,
        )
        st = image.stats
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
                        self.ckpt.save(step, params, opt_state)
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
