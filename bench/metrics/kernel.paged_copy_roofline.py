"""kernel.paged_copy_roofline (kernels, csrc/paged_reloc_copy.cu): the traced
starts' copies, 2 x payload bytes / 3.35 TB/s, over page_copy_kernel's
device time, in %."""

from bench import readings


def read(rec):
    return readings.page_copy_share(rec)
