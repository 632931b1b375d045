"""Kernels written by hand for Hopper in CUDA C++ (``csrc/``, built by
``build``), each beside its plain PyTorch version: ``flash_attention``,
``rmsnorm`` and ``paged_reloc_copy`` replace every Pallas kernel of the
reference, and ``decode_attention`` (a decode step's attention against the
KV cache) replaces an einsum the reference left to XLA; ``chip_smoke.py``
builds and runs all four on an H100. ``paged_reloc_copy`` builds the arena
on the card at every table-driven epoch load (``core/device_arena.py``);
``rmsnorm`` also has a backward kernel, which training runs.

Each wrapper counts its own kernel launches (plain-version calls do not
count); ``launch_counts`` reads the counters of this process and
``zero_launch_counts`` sets them to 0. A replayed CUDA graph runs no
Python, so no wrapper counts its launches: the program that captured it
(``train/program.py``) takes the counters' snapshot around the capture
(``counter_snapshot``), puts them back (``set_counters``) and adds the
capture's difference at every replay (``credit_launches``)."""

_COUNTERS = (                    # (kernel module, counter, route or None)
    ("flash_attention", "launches", None),
    ("flash_attention", "launches_non_causal", None),
    ("flash_attention", "launches_by_route", "wgmma"),
    ("flash_attention", "launches_by_route", "simt"),
    ("rmsnorm", "launches", None),
    ("rmsnorm", "backward_launches", None),
    ("rmsnorm", "backward_launches_by_route", "tma"),
    ("rmsnorm", "backward_launches_by_route", "two_pass"),
    ("paged_reloc_copy", "launches", None),
    ("decode_attention", "launches", None),
)


def launch_counts() -> dict:
    """This process's kernel launches: one count per kernel (rmsnorm's
    backward apart from its forward), and flash attention's launches per
    route."""
    from .decode_attention import ops as da
    from .flash_attention import ops as fa
    from .paged_reloc_copy import ops as prc
    from .rmsnorm import ops as rn

    return {"flash_attention": fa.launches, "rmsnorm": rn.launches,
            "rmsnorm_backward": rn.backward_launches,
            "paged_reloc_copy": prc.launches,
            "decode_attention": da.launches,
            "flash_routes": dict(fa.launches_by_route)}


def zero_launch_counts() -> None:
    """Set every launch counter of this process to 0."""
    set_counters(dict.fromkeys(_COUNTERS, 0))


def _ops(kernel: str):
    from .decode_attention import ops as da
    from .flash_attention import ops as fa
    from .paged_reloc_copy import ops as prc
    from .rmsnorm import ops as rn

    return {"flash_attention": fa, "rmsnorm": rn, "paged_reloc_copy": prc,
            "decode_attention": da}[kernel]


def counter_snapshot() -> dict:
    """Every launch counter of this process, ``{(kernel, counter, route):
    count}`` (route None for a counter that is not per route)."""
    out = {}
    for key in _COUNTERS:
        value = getattr(_ops(key[0]), key[1])
        out[key] = value if key[2] is None else value[key[2]]
    return out


def set_counters(counts: dict) -> None:
    """Set the counters named in ``counts`` (``counter_snapshot``'s keys)."""
    for (kernel, name, route), n in counts.items():
        mod = _ops(kernel)
        if route is None:
            setattr(mod, name, n)
        else:
            getattr(mod, name)[route] = n


def credit_launches(delta: dict) -> None:
    """Add ``delta`` (counts by ``counter_snapshot``'s keys) to the counters:
    the launches of one replay of a captured graph."""
    now = counter_snapshot()
    set_counters({k: now[k] + n for k, n in delta.items() if n})
