"""Batched serving engine: prefill + greedy decode over a KV cache.

Startup follows the stable-linking epoch path: ``from_workspace`` loads
the app through ``repro_torch.link`` (default strategy
``stable-mmap-cached``: one shared read-only arena mapping per process),
then copies the tensors to the device through ``repro_torch.convert``.

``generate`` keeps every token on the device and reads them once, after
the last step. Timings synchronise the card (``torch.cuda.synchronize``)
so they cover the device work, not only its enqueue.

Not ported yet (ROADMAP Queue A items 6-7): ``serve_loop`` and the slot
scheduler, the traffic plane, and ``spawn_fleet``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import convert, models
from repro_torch.core.errors import AdoptDeadlineError
from repro_torch.device import resolve_device

from . import faults


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


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

        Loads ``app_name`` from the workspace with ``strategy``, copies the
        tensors to ``device`` and returns the wired engine;
        ``engine.load_stats`` carries the load's ``LoadStats``."""
        dev = resolve_device(device)
        image = ws.load(app_name, strategy=strategy)
        params = cls._lift_params(cfg, image, dev)
        engine = cls(cfg, params, impl=impl, cache_len=cache_len, device=dev)
        engine.load_stats = image.stats
        return engine

    @staticmethod
    def _lift_params(cfg, image, device):
        return convert.params_from_image(image, models.param_specs(cfg), device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reload(self, ws, app_name, strategy):
        """The wedgeable half of an epoch reload: load + lift. Returns
        (image, params) without touching ``self``, so a reload abandoned
        at its deadline can never clobber the engine after a rollback."""
        faults.on_adopt_reload()
        image = ws.load(app_name, strategy=strategy)
        return image, self._lift_params(self.cfg, image, self.device)

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
        image = ws.load(app_name, strategy=strategy)
        self.params = self._lift_params(self.cfg, image, self.device)
        self.load_stats = image.stats
        return gen

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int):
        """prompts: (B, S) int -> ((B, max_new_tokens) greedy continuations,
        ServeStats). Tokens stay on the device until the last step."""
        cfg = self.cfg
        stats = ServeStats()
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = models.prefill(
            cfg, self.params, {"tokens": tokens}, impl=self.impl,
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
