from .bundle import bundle_from_params, fragment_name, image_to_params, params_from_image

__all__ = ["bundle_from_params", "fragment_name", "image_to_params", "params_from_image"]
