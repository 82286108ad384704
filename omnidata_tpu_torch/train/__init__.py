"""Training: optax-equal optimizers and the train state, the depth and
normal steps, checkpoints, callbacks, the drivers' shared loop and the
evaluation metrics."""
from .callbacks import save_crash_dump, save_validation_images
from .depth import SSI_ONLY_STEPS, depth_loss_fn, make_depth_eval_step, make_depth_train_step
from .metrics import depth_metrics, normal_metrics
from .normal import make_normal_eval_step, make_normal_train_step, normal_loss_fn
from .state import (
    Optimizer,
    TrainState,
    create_train_state,
    depth_optimizer,
    normal_optimizer,
    trainable_parameters,
)

__all__ = [
    "save_crash_dump", "save_validation_images", "SSI_ONLY_STEPS",
    "depth_loss_fn", "depth_metrics", "normal_metrics", "make_depth_eval_step", "make_depth_train_step",
    "make_normal_eval_step", "make_normal_train_step", "normal_loss_fn",
    "Optimizer", "TrainState", "create_train_state", "depth_optimizer",
    "normal_optimizer", "trainable_parameters",
]
