"""The trainers' in-step augmentations (reference:
omnidata_tools/torch/data/augmentation.py) and the refocus augmentation
(data/refocus_augmentation.py), the port's counterparts of the JAX
package's ``augment.image_augs`` and ``augment.refocus``."""
from .image_augs import (
    augment_batch,
    augment_rgb,
    gaussian_blur,
    motion_blur,
    resize_crop,
    sharpness,
)
from .refocus import (
    composite_blur_stack,
    compute_circle_of_confusion_no_magnification,
    compute_quantile_membership,
    compute_quantiles,
    get_blur_stack,
    refocus_augmentation,
    refocus_draws,
    refocus_image,
    separable_gaussian,
)

__all__ = ["augment_batch", "augment_rgb", "gaussian_blur", "motion_blur",
           "resize_crop", "sharpness", "composite_blur_stack",
           "compute_circle_of_confusion_no_magnification",
           "compute_quantile_membership", "compute_quantiles", "get_blur_stack",
           "refocus_augmentation", "refocus_draws", "refocus_image",
           "separable_gaussian"]
