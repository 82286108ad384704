"""Training: optax-equal optimizers and the train state, the depth and
normal steps, the (data, model) grid and its multi-process scaffolding,
checkpoints, callbacks, the drivers' shared loop and the evaluation
metrics."""
from .callbacks import save_crash_dump, save_validation_images
from .depth import SSI_ONLY_STEPS, depth_loss_fn, make_depth_eval_step, make_depth_train_step
from .metrics import depth_metrics, normal_metrics
from .multihost import barrier, local_batch_to_global, process_local_batch_size, stripe
from .multihost import initialize as initialize_multihost
from .normal import make_normal_eval_step, make_normal_train_step, normal_loss_fn
from .parallel import batch_sharding, make_mesh, param_sharding, replicated
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
    "normal_optimizer", "trainable_parameters", "make_mesh", "param_sharding",
    "batch_sharding", "replicated", "initialize_multihost", "stripe",
    "local_batch_to_global", "barrier", "process_local_batch_size",
]
