"""Multi-task training driver (reference: paper_code/train_multi_task_*.py
over MultiTaskModel/MTAN/PADNet/CrossStitch with GradNorm loss balancing,
losses/loss_balancing.py), the port's counterpart of the root
``train_multitask.py``.

    python -m omnidata_tpu_torch.train_multitask --data_path <annotated dir> \\
        [--arch multitask|mtan|padnet|crossstitch] [--max_steps N] \\
        [--balance_every N] [--device cuda|cpu]

Tasks: depth_zbuffer (masked L1 on [0,1] depth) + normal (cosine-angular +
L1 on the prediction clipped to [0, 1]). Adam lr 1e-4 after a global-norm
clip at 10 (optax's formulas, ``train.state.Optimizer``). Every
``balance_every`` steps the loss weights are rebalanced by GradNorm from
the per-task gradient norms taken after that step's update, on the same
batch, against the first step's losses. Weights are seeded (Flax's
initialisers, ``torch.Generator`` seed 0); batches come shuffled with
random flips from the dataset's own seeded generator. One device,
``--device cuda`` by default (raises without a card).

The normal loss can go below zero (its cosine term is -cos). A task whose
loss then has the other sign than at the first step has a negative
training rate, which GradNorm raises to the power 1.5, and the weights
come out NaN, as in the JAX driver; here such an update is reported on a
line of its own and skipped, and the weights stay as they were.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

TASKS = {"depth_zbuffer": 1, "normal": 3}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--arch", default="multitask",
                   choices=["multitask", "mtan", "padnet", "crossstitch"])
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--balance_every", type=int, default=100)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def build_model(arch: str, seed: int = 0) -> torch.nn.Module:
    """The architecture over TASKS with seeded Flax-style initial weights."""
    from .models.multitask import ARCHS
    from .models.registry import init_weights

    net = ARCHS[arch](tasks=TASKS)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net


def losses_fn(net: torch.nn.Module, batch: dict) -> dict:
    """batch: rgb (B,3,H,W) [0,1] float, depth_zbuffer (B,1,H,W), normal
    (B,3,H,W) [0,1], mask_valid (B,1,H,W) bool -> {task: loss}."""
    from .losses import clip, masked_cosine_angular_loss, masked_l1_loss

    out = net(batch["rgb"])
    mask = batch["mask_valid"]
    ld = masked_l1_loss(out["depth_zbuffer"], batch["depth_zbuffer"], mask)
    pred_n = clip(out["normal"], 0.0, 1.0)
    m3 = mask.repeat_interleave(3, 1)
    ln = (masked_cosine_angular_loss(pred_n, batch["normal"], m3)
          + masked_l1_loss(pred_n, batch["normal"], m3))
    return {"depth_zbuffer": ld, "normal": ln}


def train_step(state, batch: dict, weights: dict) -> dict:
    """One update of state in place on sum_t weights[t] * loss_t -> the
    detached per-task losses."""
    ls = losses_fn(state.net, batch)
    total = weights["depth_zbuffer"] * ls["depth_zbuffer"] + weights["normal"] * ls["normal"]
    total.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in ls.items()}


def per_task_grad_norms(state, batch: dict) -> dict:
    """{task: global L2 norm of d loss_t / d params} from one forward; a
    parameter the task's loss does not reach contributes zero."""
    params = state.params
    ls = losses_fn(state.net, batch)
    out = {}
    for i, t in enumerate(TASKS):
        grads = torch.autograd.grad(ls[t], params, retain_graph=i + 1 < len(TASKS),
                                    allow_unused=True)
        sq = [torch.sum(g * g) for g in grads if g is not None]
        out[t] = torch.sqrt(torch.stack(sq).sum())
    return out


def to_batch(nb: dict, device: torch.device) -> dict:
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

    return {"rgb": put(nb["rgb"].astype(np.float32)),
            "depth_zbuffer": put(nb["depth_zbuffer"].astype(np.float32)),
            "normal": put(nb["normal"].astype(np.float32)),
            "mask_valid": put(nb["mask_valid"] > 0.5)}


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .annotator.cli import resolve_device
    from .data.dataset import OmnidataDataset, Options
    from .models.multitask import grad_norm_weights
    from .train.state import Optimizer, create_train_state

    device = resolve_device(args.device)
    S = args.image_size
    ds = OmnidataDataset(Options(data_path=args.data_path,
                                 tasks=("rgb", "depth_zbuffer", "normal", "mask_valid"),
                                 image_size=S, random_flip=True))
    if len(ds) == 0:
        raise SystemExit("no complete samples found")

    # optax.chain(clip_by_global_norm(10), adam(lr))
    state = create_train_state(build_model(args.arch).to(device),
                               Optimizer(lr=args.lr, grad_clip=10.0))
    weights = {t: 1.0 for t in TASKS}
    initial = None
    step, t0 = 0, time.time()
    while step < args.max_steps:
        for nb in ds.batches(args.batch_size):
            batch = to_batch(nb, device)
            ls = train_step(state, batch, weights)
            step += 1
            if initial is None:
                initial = {k: float(v) for k, v in ls.items()}
            if step % args.balance_every == 0:
                gn = per_task_grad_norms(state, batch)
                losses = {k: float(v) for k, v in ls.items()}
                new = grad_norm_weights(losses, {k: float(v) for k, v in gn.items()},
                                        initial_losses=initial)
                if all(math.isfinite(v) for v in new.values()):
                    weights = new
                else:  # a loss whose sign differs from its first step's
                    print(f"GradNorm at step {step}: weights {new} are not finite "
                          f"(losses {losses}, first {initial}); keeping {weights}")
                print(f"step {step}: losses={losses} weights={weights} "
                      f"({(time.time() - t0) / step:.2f}s/step)")
            if step >= args.max_steps:
                break
    print(f"done: {step} steps")
    return state


if __name__ == "__main__":
    main()
