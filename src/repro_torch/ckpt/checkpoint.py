"""Training checkpoints as management-time events — the port of the
reference's ``ckpt/checkpoint.py``.

A checkpoint save is exactly a management time (§3 Integration): the trainer
calls ``begin_mgmt``, publishes the new weight/optimizer bundles with
``update_obj``, and ``end_mgmt`` re-materializes the relocation tables of
every application that references them. A restart after failure then takes
the *epoch* path: table-driven loading, no symbol resolution — the paper's
startup win applied to fault recovery.

Writes are asynchronous: tensors are snapshotted to host memory on the
caller's thread (so an in-place optimizer update that follows can never
race the copy; bfloat16 keeps its bits through ``ckpt/bundle.py``'s 2-byte
stand-in), and bundle building, registry insertion and ``end_mgmt`` run on
a background thread; ``wait()`` joins before the next save (overlapping
checkpoint IO with compute) and raises what the thread raised.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core import Manager, Mode

from .bundle import bundle_from_params


class CheckpointError(Exception):
    """A background publish failed (not a RuntimeError, so a trainer does
    not take it for a node failure and restart)."""


def _flatten_opt(opt_state) -> dict:
    """{"m", "v", "step"} -> the optimizer's symbols: ``opt/m/<param>``,
    ``opt/v/<param>`` and ``opt/step`` of shape (1,)."""
    out = {}
    for mv in ("m", "v"):
        for name, t in opt_state[mv].items():
            out[f"opt/{mv}/{name}"] = t
    out["opt/step"] = opt_state["step"].reshape(1)
    return out


def _unflatten_opt(tensors: dict) -> dict:
    """The optimizer's symbols (tensors or numpy arrays) -> {"m", "v",
    "step"}, the step 0-d."""
    m, v = {}, {}
    for name, t in tensors.items():
        if name.startswith("opt/m/"):
            m[name[len("opt/m/"):]] = t
        elif name.startswith("opt/v/"):
            v[name[len("opt/v/"):]] = t
    return {"m": m, "v": v, "step": tensors["opt/step"].reshape(())}


def _snapshot(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that no later in-place update reaches."""
    return t.detach().to("cpu", copy=True)


@dataclass
class Checkpointer:
    manager: Manager
    weights_name: str
    opt_name: str
    keep_opt: bool = True
    keep_last: bool = False          # keep the last snapshot in last_snapshot
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)
    last_step: int = -1
    saves: int = 0
    save_seconds: float = 0.0        # publishing, on the background thread
    snapshot_seconds: float = 0.0    # the host copy, on the caller's thread
    last_snapshot: Optional[tuple] = field(default=None, repr=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(f"checkpoint publish failed: {err!r}") from err

    def save(self, step: int, params, opt_state=None) -> None:
        """Snapshot on the caller's thread; publish on a background thread."""
        self.wait()
        t0 = time.perf_counter()
        host_params = {n: _snapshot(t) for n, t in params.items()}
        host_opt = (
            {n: _snapshot(t) for n, t in _flatten_opt(opt_state).items()}
            if (opt_state is not None and self.keep_opt)
            else None
        )
        self.snapshot_seconds += time.perf_counter() - t0
        self.last_snapshot = (host_params, host_opt) if self.keep_last else None

        def publish():
            try:
                t0 = time.perf_counter()
                own_mgmt = self.manager.mode != Mode.MANAGEMENT
                if own_mgmt:
                    self.manager.begin_mgmt()
                obj, pl = bundle_from_params(
                    self.weights_name, f"step{step}", host_params,
                    meta={"step": step},
                )
                self.manager.update_obj(obj, pl)
                if host_opt is not None:
                    oobj, opl = bundle_from_params(
                        self.opt_name, f"step{step}", host_opt, meta={"step": step}
                    )
                    self.manager.update_obj(oobj, opl)
                if own_mgmt:
                    self.manager.end_mgmt()  # re-materializes relocation tables
                self.last_step = step
                self.saves += 1
                self.save_seconds += time.perf_counter() - t0
            except BaseException as e:   # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=publish, daemon=True)
        self._thread.start()


def restore_train_state(executor, app_name: str, *, strategy: str = "stable",
                        device=None):
    """Epoch-path restore: table-driven load of weights (+opt if present),
    on the host or, with ``device``, in a device arena.

    Returns (params dict, opt {"m", "v", "step"} or None, step)."""
    image = executor.load(app_name, strategy=strategy, device=device)
    params = {
        n: t for n, t in image.tensors.items() if not n.startswith("opt/")
    }
    opt_tensors = {
        n: t for n, t in image.tensors.items() if n.startswith("opt/")
    }
    step = -1
    for o in image.table.objects:
        obj = executor.registry.get(o["content_hash"])
        if "step" in obj.meta:
            step = max(step, int(obj.meta["step"]))
    opt = _unflatten_opt(opt_tensors) if opt_tensors else None
    return params, opt, step
