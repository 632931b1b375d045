"""Kernels written by hand for Hopper, each beside its plain PyTorch
version: ``flash_attention`` (CUDA C++, built by ``build``) and ``rmsnorm``
(Triton). Both have run on an H100 (``chip_smoke.py``). The reference's
third Pallas kernel, ``paged_reloc_copy``, is not ported yet: the linker's
page tables are applied by a numpy gather on the host."""
