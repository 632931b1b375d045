"""Kernels written by hand for Hopper in CUDA C++ (``csrc/``, built by
``build``), each beside its plain PyTorch version: ``flash_attention``,
``rmsnorm`` and ``paged_reloc_copy``. Together they replace every Pallas
kernel of the reference; ``chip_smoke.py`` builds and runs all three on an
H100. ``paged_reloc_copy`` builds the arena on the card at every
table-driven epoch load (``core/device_arena.py``)."""
