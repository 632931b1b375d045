"""repro_torch — the PyTorch/CUDA port of the stable-linking serving stack.

It sits beside the JAX package ``repro`` (the reference) and imports
nothing of it, nor ``jax`` or ``ml_dtypes``: it carries its own copy of
the host-side linker (``core``, ``link``), the configs, the dense
transformer, the serving engine and launcher, and two kernels written by
hand for Hopper (``kernels.flash_attention`` in CUDA C++, ``kernels.rmsnorm``
in Triton). Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU; a missing card raises, it never falls back.

Submodules are imported on demand: ``import repro_torch`` alone loads
nothing heavy.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
