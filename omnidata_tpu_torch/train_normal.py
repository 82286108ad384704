"""Surface-normal training (reference: omnidata_tools/torch/train_normal.py
+ config/normal.yml), the port's counterpart of the root ``train_normal.py``.

    python -m omnidata_tpu_torch.train_normal --config_file config/normal.yml \\
        [--max_steps N] [--checkpoint_dir D] [--resume] [--pretrained CKPT] \\
        [--device cuda|cpu]

Model: UNet (v1, ``model: unet``, the default; ``unet_downsample``, and
``remat`` on by default as in the JAX driver) or DPT-hybrid (``model:
dpt``); loss = cosine-angular + 10 * L1 over the dilated valid mask; Adam
amsgrad lr 1e-4 wd 2e-6, grad-clip 10 (optax's formulas); batches mix
components 1/k with a threaded prefetch pool. One device, ``--device cuda``
by default (raises without a card).
"""
from __future__ import annotations

import numpy as np
import torch

from .models import DPTHybrid, UNet
from .models.registry import init_weights
from .train import (
    create_train_state,
    make_normal_eval_step,
    make_normal_train_step,
    normal_optimizer,
)
from .train.driver import (
    COMMON_KEYS,
    build_datasets,
    load_config,
    load_pretrained,
    parse_args,
    resolve_device,
    run_training,
    to_device,
)

KNOWN_KEYS = COMMON_KEYS | {"model", "remat", "unet_downsample"}


def main(argv=None):
    args = parse_args(argv, "config/normal.yml")
    cfg = load_config(args.config_file, KNOWN_KEYS)
    device = resolve_device(args.device)
    image_size = int(cfg.get("image_size", 512))
    datasets, val_datasets = build_datasets(
        cfg, tasks=("rgb", "normal", "mask_valid"), image_size=image_size)
    if not datasets:
        raise SystemExit("no data_paths configured / found in config")

    if cfg.get("model", "unet") == "dpt":
        net = DPTHybrid(num_channels=3)
    else:
        # remat by default, as the JAX driver (models/unet.py UNet.remat)
        net = UNet(out_channels=3, downsample=int(cfg.get("unet_downsample", 6)),
                   remat=bool(cfg.get("remat", True)))
    init_weights(net, torch.Generator().manual_seed(0))
    pretrained = args.pretrained or (
        cfg.get("pretrained_weights_path") if cfg.get("pretrained") else None)
    if pretrained:
        load_pretrained(net, pretrained)
        print(f"warm-started from {pretrained}")
    tx = normal_optimizer(lr=float(cfg.get("lr", 1e-4)),
                          weight_decay=float(cfg.get("weight_decay", 2e-6)))
    state = create_train_state(net.to(device), tx)

    def apply_fn(net, rgb):
        return net(rgb)

    augment = bool(cfg.get("augment", True))  # reference augments train rgb

    def prepare(batch, train: bool):
        return to_device({"rgb": batch["rgb"].astype(np.float32),
                          "normal": batch["normal"].astype(np.float32),
                          "mask_valid": batch["mask_valid"] > 0.5}, device)

    eval_step = make_normal_eval_step(apply_fn)
    run_training(
        cfg, args, state, datasets, val_datasets, prepare=prepare,
        step_fn=make_normal_train_step(apply_fn, augment=augment, image_size=image_size),
        eval_fn=lambda net, b, generator: eval_step(net, b),
        loss_key="val_normal_loss", default_ckpt_dir="./checkpoints/normal", device=device)


if __name__ == "__main__":
    main()
