"""The host a run lands on, and Python's collector inside the measured
window.

A cell whose step the host paces (the chat cell's decode step, a replica
start) moves with the host: which CPUs issue its kernels, what else runs
there, and the collector's pauses inside the serving loop. ``facts`` gives
one line of standard error with the CPU model, the CPUs the process may run
on, the card's NUMA node and local CPUs where the host exposes them, and
``/proc/loadavg``, so that a noisy host can be told from a noisy program.
``Collector`` counts the collections that start in the window, by
generation, with their seconds.

Every path is an argument, so the tests read no real ``/proc`` or ``/sys``.
"""

from __future__ import annotations

import gc
import os
import time
from pathlib import Path

PCI_DEVICES = Path("/sys/bus/pci/devices")
PROC = Path("/proc")


def parse_cpulist(text: str) -> set:
    """The CPUs of a kernel CPU list (``"0-15,32-47"``, ``"3"``, ``""``)."""
    cpus = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def format_cpulist(cpus) -> str:
    """``parse_cpulist``'s inverse: runs of CPUs as ranges."""
    runs = []
    for c in sorted(cpus):
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(str(lo) if lo == hi else f"{lo}-{hi}" for lo, hi in runs)


def bus_id(props) -> str | None:
    """The card's PCI address as sysfs names it (``0000:19:00.0``), from
    ``torch.cuda.get_device_properties``; None where torch gives none."""
    try:
        return f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
    except AttributeError:
        return None


def card_numa(bus: str | None, devices: Path = PCI_DEVICES) -> tuple:
    """``(node, local CPUs, None)`` of the card at sysfs address ``bus``, or
    ``(None, None, why)`` where the host does not expose them."""
    if bus is None:
        return None, None, "no PCI address"
    dev = Path(devices) / bus
    try:
        node = int((dev / "numa_node").read_text())
        local = parse_cpulist((dev / "local_cpulist").read_text())
    except (OSError, ValueError) as e:
        return None, None, f"{dev} not readable ({e.__class__.__name__})"
    return node, local, None


def _read(path: Path) -> str | None:
    try:
        return Path(path).read_text()
    except OSError:
        return None


def cpu_model(proc: Path = PROC) -> str:
    """The first CPU's model name, or its vendor, family and model number
    where the host hides the name (``unknown``)."""
    first = {}
    for line in (_read(Path(proc) / "cpuinfo") or "").splitlines():
        if not line.strip():
            break
        key, _, value = line.partition(":")
        first[key.strip()] = value.strip()
    name = first.get("model name", "unknown")
    if name != "unknown" or "vendor_id" not in first:
        return name
    return (f"{first['vendor_id']} family {first.get('cpu family', '?')} "
            f"model {first.get('model', '?')} at {first.get('cpu MHz', '?')} MHz")


def facts(bus: str | None, *, proc: Path = PROC, devices: Path = PCI_DEVICES,
          affinity=None) -> str:
    """One line: the CPU model, the CPUs this process may run on, the card's
    NUMA node and local CPUs (or why they are unknown), and the load."""
    cpus = os.sched_getaffinity(0) if affinity is None else affinity
    node, local, why = card_numa(bus, devices)
    card = (f"NUMA node {node}, local CPUs {format_cpulist(local)}" if why is None
            else f"NUMA node unknown: {why}")
    load = (_read(Path(proc) / "loadavg") or "not readable").strip()
    return (f"host: cpu {cpu_model(proc)}; affinity {format_cpulist(cpus)} ({len(cpus)} CPUs); "
            f"card {card}; loadavg {load}")


class Collector:
    """Python's collections during the measured window: a ``gc.callbacks``
    entry, while in use as a ``with`` block, stamps each collection's start
    and stop on the run's clock; ``counts`` keeps those that start inside a
    window. It changes nothing of what the collector does."""

    GENERATIONS = (0, 1, 2)

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.events = []                  # (phase, generation, t)

    def __call__(self, phase: str, info: dict) -> None:
        self.events.append((phase, info["generation"], self.clock()))

    def __enter__(self) -> "Collector":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)

    def counts(self, window: tuple) -> dict:
        """``{generation: (collections, seconds)}`` of those that start in
        ``[open, close)``, and ``"longest_s"``, the longest of them."""
        out = {g: (0, 0.0) for g in self.GENERATIONS}
        longest, started = 0.0, {}
        for phase, gen, t in self.events:
            if phase == "start":
                started[gen] = t
            elif gen in started:
                t0 = started.pop(gen)
                if window[0] <= t0 < window[1]:
                    n, s = out[gen]
                    out[gen] = (n + 1, s + t - t0)
                    longest = max(longest, t - t0)
        out["longest_s"] = longest
        return out

    def line(self, window: tuple) -> str:
        c = self.counts(window)
        gens = ", ".join(f"gen{g} {c[g][0]} in {c[g][1]:.6f} s" for g in self.GENERATIONS)
        return f"collector in the window: {gens}; longest {c['longest_s']:.6f} s"
