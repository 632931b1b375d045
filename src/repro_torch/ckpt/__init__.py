from .bundle import (
    bundle_from_params,
    fragment_name,
    image_to_params,
    make_kernel_lib,
    params_from_image,
)
from .checkpoint import CheckpointError, Checkpointer, restore_train_state

__all__ = ["CheckpointError", "Checkpointer", "bundle_from_params", "fragment_name", "image_to_params",
           "make_kernel_lib", "params_from_image", "restore_train_state"]
