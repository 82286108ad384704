"""DPT-hybrid monocular depth training (reference: omnidata_tools/torch/
train_depth.py + config/depth.yml), the port's counterpart of the root
``train_depth.py``.

    python -m omnidata_tpu_torch.train_depth --config_file config/depth.yml \\
        [--max_steps N] [--checkpoint_dir D] [--resume] [--pretrained CKPT] \\
        [--device cuda|cpu]
    torchrun --nproc_per_node N -m omnidata_tpu_torch.train_depth ...

Loss: MiDaS SSI-MAE (+ 0.1 gradient matching + 10 VNL after 15k steps);
Adam lr 1e-5, grad-clip 10 (optax's formulas); rgb normalized to [-1,1];
fixed image_size resize; batches mix components 1/k with a threaded
prefetch pool; top-k checkpoints on the validation loss. One process on
one device, ``--device cuda`` by default (raises without a card); under
torchrun one process per device, the global batch split over
``data_parallel`` ranks and the ViT's matmuls over ``model_parallel``
(``train/parallel``), checkpoints in the single-device format.
"""
from __future__ import annotations

import numpy as np
import torch

from .losses import VNLParams
from .models import DPTHybrid
from .models.registry import init_weights
from .train import create_train_state, depth_optimizer, make_depth_eval_step, make_depth_train_step
from .train.parallel import broadcast_module, shard_module
from .train.driver import (
    COMMON_KEYS,
    build_datasets,
    load_config,
    load_pretrained,
    parallel_setup,
    parse_args,
    run_training,
    to_device,
)


def main(argv=None):
    args = parse_args(argv, "config/depth.yml")
    cfg = load_config(args.config_file, COMMON_KEYS)
    mesh, device = parallel_setup(cfg, args.device)
    image_size = int(cfg.get("image_size", 384))
    datasets, val_datasets = build_datasets(
        cfg, tasks=("rgb", "depth_zbuffer", "mask_valid"), image_size=image_size)
    if not datasets:
        raise SystemExit("no data_paths configured / found in config")

    net = DPTHybrid(num_channels=1)
    init_weights(net, torch.Generator().manual_seed(0))
    pretrained = args.pretrained or (
        cfg.get("pretrained_weights_path") if cfg.get("pretrained") else None)
    if pretrained:
        load_pretrained(net, pretrained)
        if mesh.rank == 0:
            print(f"warm-started from {pretrained}")
    net = net.to(device)
    broadcast_module(net)
    state = create_train_state(shard_module(net, mesh),
                               depth_optimizer(lr=float(cfg.get("lr", 1e-5))), mesh)

    def apply_fn(net, rgb):
        return net(rgb)[:, 0]

    vnl_params = VNLParams(1.0, 1.0, (image_size, image_size))
    augment = bool(cfg.get("augment", True))  # reference always augments train

    def prepare(batch, train: bool):
        rgb = batch["rgb"].astype(np.float32)
        if not (train and augment):
            rgb = rgb * 2.0 - 1.0  # [-1,1]; the augment path normalizes in-step
        return to_device({"rgb": rgb, "depth": batch["depth_zbuffer"].astype(np.float32),
                          "mask_valid": batch["mask_valid"] > 0.5}, device)

    run_training(
        cfg, args, state, datasets, val_datasets, prepare=prepare,
        step_fn=make_depth_train_step(apply_fn, vnl_params, augment=augment,
                                      image_size=image_size),
        eval_fn=make_depth_eval_step(apply_fn, vnl_params),
        loss_key="val_depth_loss", default_ckpt_dir="./checkpoints/depth", device=device)


if __name__ == "__main__":
    main()
