"""The trainers' in-step augmentations (reference:
omnidata_tools/torch/data/augmentation.py), the port's counterpart of the
JAX package's ``augment.image_augs``."""
from .image_augs import (
    augment_batch,
    augment_rgb,
    gaussian_blur,
    motion_blur,
    resize_crop,
    sharpness,
)

__all__ = ["augment_batch", "augment_rgb", "gaussian_blur", "motion_blur",
           "resize_crop", "sharpness"]
