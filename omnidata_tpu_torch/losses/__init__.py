"""The trainers' losses (reference: omnidata_tools/torch/losses), the
port's counterparts of the JAX package's ``losses``."""
from .masked import clip, masked_cosine_angular_loss, masked_l1_loss, masked_mse_loss
from .midas import (
    compute_scale_and_shift,
    gradient_matching_term,
    inverse_depth_regularizer,
    masked_shift_and_scale,
    midas_loss,
    ssi_mae,
)
from .virtual_normal import (
    VNLParams,
    sample_triplets,
    transfer_xyz,
    virtual_normal_loss,
    vnl_from_indices,
)

__all__ = [
    "clip", "masked_cosine_angular_loss", "masked_l1_loss", "masked_mse_loss",
    "compute_scale_and_shift", "gradient_matching_term",
    "inverse_depth_regularizer", "masked_shift_and_scale", "midas_loss",
    "ssi_mae", "VNLParams", "sample_triplets", "transfer_xyz",
    "virtual_normal_loss", "vnl_from_indices",
]
