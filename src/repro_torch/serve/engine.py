"""Batched serving engine: prefill + greedy decode over a KV cache.

Startup follows the stable-linking epoch path: ``from_workspace`` loads
the app through ``repro_torch.link``. A table-driven strategy (``stable``,
``prefetch``, ``dynamic``, ``indexed``) builds the arena on the engine's
device with the ``paged_reloc_copy`` kernel, and the params ARE views of
that arena (no copy). The other strategies (default ``stable-mmap-cached``:
one shared read-only arena mapping per process) load on the host, and
``repro_torch.convert`` copies the tensors to the device. ``adopt_epoch``
and ``abort_adopt`` reload the same way.

``generate`` keeps every token on the device and reads them once, after
the last step. Timings synchronise the card (``torch.cuda.synchronize``)
so they cover the device work, not only its enqueue. ``serve_loop`` is
continuous batching (``serve/scheduler.py``).

``spawn_fleet`` is the cross-process variant: it spawns N worker
processes that load the same app (default ``stable-shm``: the machine
holds one physical copy of the baked arena; at most one worker fills the
shm segment, every other attaches), optionally serving from it on
``device`` (``core/shm_arena.py``). The traffic plane, which drives a
Poisson load into such workers over shm rings, is ``serve/traffic.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import convert, models
from repro_torch.core.errors import AdoptDeadlineError
from repro_torch.device import resolve_device
from repro_torch.link import strategy_takes_device

from . import faults
from .scheduler import check_token_ids, stub_frames


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


@dataclass
class FleetReport:
    """What one ``ServeEngine.spawn_fleet`` actually did, per worker."""

    processes: int
    strategy: str
    wall_s: float = 0.0
    workers: list = field(default_factory=list)   # one result dict each
    restarts: int = 0                # supervised workers respawned after death
    rerouted_requests: int = 0       # in-flight requests re-routed off a corpse

    @property
    def fills(self) -> int:
        """Workers that had to publish (fill) the shm segment — the
        exclusive-create protocol bounds this at 1 per segment, 0 when the
        segment was already warm. Failed workers never count as fills."""
        return sum(
            1
            for w in self.workers
            if not w.get("failed") and not w.get("shm_attached")
        )

    @property
    def attaches(self) -> int:
        return len(self.workers) - self.fills - self.failed

    @property
    def failed(self) -> int:
        """Workers that crashed (structured error records from
        ``run_fleet``: exit code + traceback excerpt, surfaced the moment
        the process dies instead of riding out the join timeout)."""
        return sum(1 for w in self.workers if w.get("failed"))

    @property
    def errors(self) -> list:
        """The failed workers' error records, ready for a log line."""
        return [
            {
                "pid": w.get("pid"),
                "exit_code": w.get("exit_code"),
                "error": w.get("error"),
                "traceback": w.get("traceback", ""),
            }
            for w in self.workers
            if w.get("failed")
        ]

    @property
    def segments(self) -> set:
        return {w.get("segment") for w in self.workers}

    def summary(self) -> dict:
        return {
            "processes": self.processes,
            "strategy": self.strategy,
            "wall_s": self.wall_s,
            "fills": self.fills,
            "attaches": self.attaches,
            "failed": self.failed,
            "errors": self.errors,
            "segments": sorted(s for s in self.segments if s),
            "pids": [w.get("pid") for w in self.workers],
            # honest even at zero: a fleet that never needed the supervisor
            # reports restarts=0, not a missing key
            "restarts": self.restarts,
            "rerouted_requests": self.rerouted_requests,
        }


class ServeEngine:
    def __init__(self, cfg, params, *, impl: str = "kernel", cache_len: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.impl = impl
        self.cache_len = cache_len
        self.device = resolve_device(device)
        # set by from_workspace: the LoadStats of the epoch load that
        # produced self.params (None for hand-built params)
        self.load_stats = None

    @classmethod
    def from_workspace(
        cls,
        cfg,
        ws,
        app_name: str,
        *,
        strategy: str = "stable-mmap-cached",
        impl: str = "kernel",
        cache_len: int = 0,
        device="cuda",
    ) -> "ServeEngine":
        """Spin up a replica through the stable-linking epoch path.

        Loads ``app_name`` from the workspace with ``strategy`` — on
        ``device`` when the strategy builds device arenas, else on the host
        and then copied there — and returns the wired engine;
        ``engine.load_stats`` carries the load's ``LoadStats``."""
        dev = resolve_device(device)
        image = cls._load(ws, app_name, strategy, dev)
        params = cls._lift_params(cfg, image, dev)
        engine = cls(cfg, params, impl=impl, cache_len=cache_len, device=dev)
        engine.load_stats = image.stats
        return engine

    @staticmethod
    def _load(ws, app_name, strategy, device):
        """``ws.load`` with ``device`` wherever ``strategy`` takes one."""
        on_device = strategy_takes_device(strategy, mode=ws.mode)
        return ws.load(app_name, strategy=strategy,
                       device=device if on_device else None)

    @staticmethod
    def _lift_params(cfg, image, device):
        specs = models.param_specs(cfg)
        if isinstance(image.arena, torch.Tensor):
            return convert.params_from_device_image(image, specs, device)
        return convert.params_from_image(image, specs, device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reload(self, ws, app_name, strategy):
        """The wedgeable half of an epoch reload: load + lift. Returns
        (image, params) without touching ``self``, so a reload abandoned
        at its deadline can never clobber the engine after a rollback."""
        faults.on_adopt_reload()
        image = self._load(ws, app_name, strategy, self.device)
        params = self._lift_params(self.cfg, image, self.device)
        self._sync()    # the new params are complete before anyone sees them
        return image, params

    def adopt_epoch(
        self,
        ws,
        app_name: str,
        *,
        strategy: str = "stable-mmap-cached",
        deadline_s: float = 0.0,
    ):
        """Flip this engine onto a newly committed generation (blue/green).

        Called at a request boundary: ``ws.refresh()`` adopts the sibling
        commit, the app is reloaded from the new generation, and
        ``self.params`` is swapped. Returns the reloaded image.

        ``deadline_s > 0`` bounds how long a flip may wedge: the reload runs
        on a daemon thread and, past the deadline, ``abort_adopt`` rolls the
        store back and re-adopts the previous weights, and this call raises
        :class:`AdoptDeadlineError` with ``rolled_back_to`` set."""
        ws.refresh()
        if deadline_s and deadline_s > 0:
            box: dict = {}

            def _run():
                try:
                    box["result"] = self._reload(ws, app_name, strategy)
                except BaseException as e:   # surfaced below, not swallowed
                    box["error"] = e

            t = threading.Thread(
                target=_run, name="adopt-epoch-reload", daemon=True
            )
            t.start()
            t.join(deadline_s)
            if t.is_alive():
                gen = self.abort_adopt(ws, app_name, strategy=strategy)
                raise AdoptDeadlineError(
                    f"adopt_epoch for {app_name!r} exceeded its "
                    f"{deadline_s:.3f}s deadline; rolled back to "
                    f"generation {gen}",
                    rolled_back_to=gen,
                )
            if "error" in box:
                raise box["error"]
            image, params = box["result"]
        else:
            image, params = self._reload(ws, app_name, strategy)
        self.params = params
        self.load_stats = image.stats
        return image

    def abort_adopt(
        self,
        ws,
        app_name: str,
        *,
        strategy: str = "stable-mmap-cached",
    ) -> int:
        """Abandon a wedged flip: roll the *store* back, then re-adopt.

        ``ws.rollback_epoch()`` re-publishes the newest retained world as a
        new generation; this engine reloads through the normal path,
        bypassing the ``faults.on_adopt_reload`` hook (a wedge-on-adopt plan
        must not wedge the rescue), and returns the new generation."""
        gen = ws.rollback_epoch()
        ws.refresh()
        image = self._load(ws, app_name, strategy, self.device)
        self.params = self._lift_params(self.cfg, image, self.device)
        self.load_stats = image.stats
        return gen

    @classmethod
    def spawn_fleet(
        cls,
        ws,
        app_name: str,
        *,
        processes: int = 2,
        strategy: str = "stable-shm",
        arch: str | None = None,
        max_new: int = 0,
        timeout: float = 180.0,
        store_url: str | None = None,
        device="cuda",
        smoke: bool = True,
    ) -> FleetReport:
        """Spawn a true multi-process serving fleet over one workspace.

        Each of the ``processes`` workers is a real OS process (spawn
        context: a CUDA context is never inherited) that opens the
        workspace at ``ws.root`` and loads ``app_name`` with ``strategy``
        (default ``stable-shm``): the first worker on the machine publishes
        the baked arena into a named shm segment, every other replica
        attaches to that one physical copy. With ``arch`` set, each worker
        also builds a ``ServeEngine`` on ``device`` from
        ``get_config(arch, smoke=smoke)`` and greedy-decodes ``max_new``
        tokens. Returns a ``FleetReport`` (fills/attaches per the
        one-fill-per-machine contract, per-worker load stats and tensor
        digests for byte-identity checks).

        ``store_url`` hands every worker a served arena store to fetch
        missing bakes from (``strategy="stable-remote"``), such as one
        that ``repro_torch.launch.store`` serves.
        """
        from repro_torch.core.shm_arena import run_fleet

        t0 = time.perf_counter()
        workers = run_fleet(
            ws.root,
            app_name,
            processes=processes,
            strategy=strategy,
            arch=arch,
            max_new=max_new,
            timeout=timeout,
            store_url=store_url,
            device=device,
            smoke=smoke,
        )
        return FleetReport(
            processes=processes,
            strategy=strategy,
            wall_s=time.perf_counter() - t0,
            workers=workers,
        )

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int):
        """prompts: (B, S) int -> ((B, max_new_tokens) greedy continuations,
        ServeStats). Tokens stay on the device until the last step. A
        token id outside the vocabulary raises ``ValueError`` before any
        launch. An encoder-decoder encodes the stubbed frames
        (``scheduler.stub_frames``), one per prompt position."""
        cfg = self.cfg
        check_token_ids(prompts, cfg.vocab_size, "prompts")
        stats = ServeStats()
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(self.device)
        batch = {"tokens": tokens}
        if cfg.is_encdec:
            batch["frames"] = stub_frames(cfg, *tokens.shape, self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = models.prefill(
            cfg, self.params, batch, impl=self.impl,
            cache_len=self.cache_len or None,
        )
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        self._sync()
        stats.prefill_s = time.perf_counter() - t0

        out = [tok]
        t1 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits, cache = models.decode_step(cfg, self.params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            out.append(tok)
        self._sync()
        stats.decode_s = time.perf_counter() - t1
        stats.tokens_out = tokens.shape[0] * max_new_tokens
        return torch.cat(out, dim=1).cpu().numpy(), stats

    def serve_loop(
        self,
        source,
        sink,
        *,
        max_batch: int = 4,
        max_queue: int = 16,
        max_new_cap: int = 0,
        epoch_watch=None,
        on_epoch=None,
        temperature: float = 0.0,
        top_k: int = 0,
        sampling_seed: int = 0,
        on_delta=None,
        priority_aging_s: float = 0.05,
    ):
        """Continuous batching: admit requests into open decode slots.

        Unlike ``generate`` (a static batch that starts and finishes
        together), this runs a fixed pool of ``max_batch`` slots, each
        holding one request's cache row, admitted and retired
        independently at every decode step. ``source()`` yields
        ``scheduler.Request | None | scheduler.STOP``; finished
        ``scheduler.Completion``s go to ``sink``. Requires a positive
        ``cache_len`` (slot K/V rows need decode headroom past the
        prompt). Returns a ``scheduler.ServeLoopReport``; the arguments are
        ``scheduler.run_serve_loop``'s.
        """
        from . import scheduler

        if self.cache_len <= 0 and self.cfg.family not in ("ssm",):
            raise ValueError(
                "serve_loop needs an engine built with cache_len > "
                "prompt_len + max_new_tokens (slot K/V rows need decode "
                "headroom)"
            )
        return scheduler.run_serve_loop(
            self,
            source,
            sink,
            max_batch=max_batch,
            max_queue=max_queue,
            max_new_cap=max_new_cap,
            epoch_watch=epoch_watch,
            on_epoch=on_epoch,
            temperature=temperature,
            top_k=top_k,
            sampling_seed=sampling_seed,
            on_delta=on_delta,
            priority_aging_s=priority_aging_s,
        )
