"""Production meshes, the port of the reference's ``launch/mesh.py`` on
``torch.distributed.device_mesh``.

Defined as FUNCTIONS (never module-level constants), as in the reference:
a ``DeviceMesh`` needs a process group of its size, which the caller sets
up first (``torch.distributed.init_process_group``: one rank per device,
or the dry-run's fake group of the mesh's size).

Single pod: (data=16, model=16) = 256 devices. Multi-pod:
(pod=2, data=16, model=16) = 512 devices; the ``pod`` axis carries only
data parallelism, so the sole cross-pod collective is the gradient
all-reduce. ``local``: (data=1, model=1), the production axis names on
one device.

``device_type`` is ``"cuda"`` by default; ``"cpu"`` for the tests (gloo)
and the dry-run (the fake group).
"""

from __future__ import annotations

import os
import socket

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _mesh(shape: tuple, axes: tuple, device_type: str):
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of {n} "
            "ranks, and none is initialized: call "
            "torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of {n} "
            f"ranks; the initialized one has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(device_type: str = "cuda"):
    """1-device mesh with the production axis names (smoke runs, one card)."""
    return _mesh((1, 1), ("data", "model"), device_type)


def mesh_shape(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of a mesh spec, without building it."""
    if spec == "pod":
        return (16, 16), ("data", "model")
    if spec == "multipod":
        return (2, 16, 16), ("pod", "data", "model")
    if spec == "local":
        return (1, 1), ("data", "model")
    dims = tuple(int(x) for x in spec.split("x"))
    return dims, ("pod", "data", "model")[-len(dims):]


def mesh_from_spec(spec: str, device_type: str = "cuda"):
    """"pod" -> 16x16; "multipod" -> 2x16x16; "local" -> 1x1;
    "AxB[xC]" -> custom (tests)."""
    if spec == "pod":
        return make_production_mesh(multi_pod=False, device_type=device_type)
    if spec == "multipod":
        return make_production_mesh(multi_pod=True, device_type=device_type)
    if spec == "local":
        return make_local_mesh(device_type)
    shape, axes = mesh_shape(spec)
    return _mesh(shape, axes, device_type)


def mesh_size(spec: str) -> int:
    n = 1
    for d in mesh_shape(spec)[0]:
        n *= d
    return n


def ensure_process_group(spec: str, device_type: str = "cuda") -> None:
    """Initialize the process group a launcher's mesh needs, if none is:
    one rank on a free localhost port for a 1-device mesh; for a larger
    one, the rank, world size and address a launcher such as ``torchrun``
    put in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or an error naming them. On CUDA the group is NCCL
    on this process's card (``LOCAL_RANK``, 0 for one rank), gloo on the
    CPU."""
    if dist.is_initialized():
        return
    n = mesh_size(spec)
    kw = {"backend": "gloo"}
    if device_type == "cuda":            # this process's card, before NCCL starts
        import torch

        card = int(os.environ.get("LOCAL_RANK", 0)) if n > 1 else 0
        torch.cuda.set_device(card)
        kw = {"backend": "nccl", "device_id": torch.device("cuda", card)}
    if n == 1:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(init_method=f"tcp://localhost:{port}", world_size=1,
                                rank=0, **kw)
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"mesh {spec!r} needs {n} ranks: start one process per device with "
            f"RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set (missing: "
            f"{', '.join(missing)})")
    dist.init_process_group(init_method="env://", **kw)
