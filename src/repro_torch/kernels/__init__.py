"""Kernels written by hand for Hopper in CUDA C++ (``csrc/``, built by
``build``), each beside its plain PyTorch version: ``flash_attention``,
``rmsnorm`` and ``paged_reloc_copy``. Together they replace every Pallas
kernel of the reference; ``chip_smoke.py`` builds and runs all three on an
H100. ``paged_reloc_copy`` builds the arena on the card at every
table-driven epoch load (``core/device_arena.py``); ``rmsnorm`` also has a
backward kernel, which training runs.

Each wrapper counts its own kernel launches (plain-version calls do not
count); ``launch_counts`` reads the counters of this process and
``zero_launch_counts`` sets them to 0."""


def launch_counts() -> dict:
    """This process's kernel launches: one count per kernel (rmsnorm's
    backward apart from its forward), and flash attention's launches per
    route."""
    from .flash_attention import ops as fa
    from .paged_reloc_copy import ops as prc
    from .rmsnorm import ops as rn

    return {"flash_attention": fa.launches, "rmsnorm": rn.launches,
            "rmsnorm_backward": rn.backward_launches,
            "paged_reloc_copy": prc.launches,
            "flash_routes": dict(fa.launches_by_route)}


def zero_launch_counts() -> None:
    """Set every launch counter of this process to 0."""
    from .flash_attention import ops as fa
    from .paged_reloc_copy import ops as prc
    from .rmsnorm import ops as rn

    fa.launches = fa.launches_non_causal = prc.launches = 0
    rn.launches = rn.backward_launches = 0
    for route in fa.launches_by_route:
        fa.launches_by_route[route] = 0
    for route in rn.backward_launches_by_route:
        rn.backward_launches_by_route[route] = 0
