"""Build the port's CUDA C++ kernels from the sources in the checkout.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers: seconds to
build) and loaded with ``ctypes``. Libraries go to ``<repo>/build/kernels``
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an unchanged source is built once per checkout. ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import time; the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}   # source name -> seconds nvcc took


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built from source on the machine with the card"
    )


def _target(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    h = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(), digest_size=8)
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()}.so"


def _start(source: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".partial-", suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, time.perf_counter()


def _finish(source: str, proc: subprocess.Popen, tmp: str, t0: float) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, _target(source))  # atomic: a racing load sees all or nothing
    build_seconds[source] = time.perf_counter() - t0
    return log


def build_all(sources) -> dict[str, str]:
    """Compile every source that has no library yet, all ``nvcc`` runs in
    parallel; returns ``{source: nvcc log}`` for the ones built (the log
    holds ``-Xptxas -v``'s registers and shared memory per kernel)."""
    with _lock:
        started = {s: _start(s) for s in sources if not _target(s).exists()}
        return {s: _finish(s, *job) for s, job in started.items()}


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        build_all([source])
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = _libs[source] = ctypes.CDLL(str(_target(source)))
    return lib
