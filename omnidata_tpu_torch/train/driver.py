"""Shared train-driver plumbing for ``train_depth`` / ``train_normal``, the
port's counterpart of the JAX package's ``train/driver.py`` and of the loop
its two drivers share:

- component dataset construction honoring the reference config schema
  (config/depth.yml: data_paths + train_datasets / val_datasets toggles +
  taskonomy_variant subset ladder)
- resume from the 'last' checkpoint (reference Lightning resume /
  ModelCheckpoint save_last, train_normal.py:371-374): params, optimizer
  state and step, bit for bit
- warm start from a published checkpoint (reference pretrained_weights_path,
  train_normal.py:78-87 prefix-stripped torch load) or one of the port's
- the training loop: mixed-component batches, the step, logs every
  log_step, validation + images + top-k checkpoint every val_step, 'last'
  every ckpt_step and at the end, a crash dump on error

One process, one device. What the JAX drivers spread over a device mesh
(``data_parallel`` or ``model_parallel`` above 1) and the packed sample
cache are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time

import numpy as np
import torch

from ..annotator.cli import resolve_device
from ..utils.config import load_file

COMMON_KEYS = {
    "augment", "batch_size", "cache_dir", "checkpoint_dir", "ckpt_step",
    "data_parallel", "data_paths", "image_size", "log_backend", "log_dir",
    "log_step", "lr", "max_steps", "model_parallel", "num_workers",
    "packed_cache", "pretrained", "pretrained_weights_path", "save_top_k",
    "taskonomy_variant", "train_datasets", "val_data_paths", "val_datasets",
    "val_fraction", "val_step", "weight_decay",
}


def parse_args(argv, default_config: str):
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", default=default_config)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="restore params+optimizer+step from <ckpt_dir>/last")
    p.add_argument("--pretrained", default=None,
                   help="warm-start params from a published torch .ckpt/.pth "
                        "or a checkpoint directory of these trainers")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def load_config(path: str, known: set) -> dict:
    """The YAML config (``utils.config``, no PyYAML), checked for keys this
    port cannot honour yet."""
    cfg = load_file(path) or {}
    unknown = sorted(set(cfg) - known)
    if unknown:
        print(f"[config] WARNING: ignoring unknown keys {unknown} "
              f"(known: {sorted(known)})")
    for key in ("data_parallel", "model_parallel"):
        if cfg.get(key) not in (None, 1):
            raise NotImplementedError(
                f"{key}: {cfg[key]}: these trainers run on one device; data and "
                "tensor parallelism are not ported yet (ROADMAP.md queue 1)")
    if cfg.get("packed_cache"):
        raise NotImplementedError("packed_cache: the packed sample cache is not "
                                  "ported yet (ROADMAP.md queue 1, the data item)")
    return cfg


def build_datasets(cfg: dict, tasks: tuple, image_size: int):
    """-> (train_datasets, val_datasets) lists of OmnidataDataset.

    Schema (reference config/depth.yml):
      data_paths: {component: path}            # missing paths skipped
      train_datasets: {component: bool}        # default True
      val_datasets: {component: bool}          # default True
      taskonomy_variant: debug|tiny|medium|full|fullplus  # building ladder
      val_data_paths: {component: path}        # explicit val roots (ours)
      val_fraction: float                      # holdout when no explicit val

    Validation comes from explicit val_data_paths when given, else from a
    per-component (building, point)-grouped holdout of each val-enabled
    component.
    """
    from ..data.dataset import OmnidataDataset, Options
    from ..data.splits import SUBSETS, subset_ladder

    variant = cfg.get("taskonomy_variant")
    train_on = cfg.get("train_datasets") or {}
    val_on = cfg.get("val_datasets") or {}
    cache_dir = cfg.get("cache_dir")

    def make(path, train):
        return OmnidataDataset(Options(
            data_path=path, tasks=tasks, image_size=image_size,
            random_flip=train, cache_dir=cache_dir,
        ))

    per_comp = []  # (component, dataset) for every present component
    for comp, path in (cfg.get("data_paths") or {}).items():
        if not path or not os.path.isdir(path):
            continue
        if not (train_on.get(comp, True) or val_on.get(comp, True)):
            continue
        ds = make(path, train=True)
        if comp == "taskonomy" and variant:
            if variant not in SUBSETS:
                raise SystemExit(
                    f"unknown taskonomy_variant {variant!r} (one of {SUBSETS})")
            ds = ds.filter_buildings(subset_ladder(ds.buildings())[variant])
        if len(ds):
            per_comp.append((comp, ds))

    explicit_val = []
    for comp, path in (cfg.get("val_data_paths") or {}).items():
        if path and os.path.isdir(path) and val_on.get(comp, True):
            explicit_val.append(make(path, train=False))

    def as_val(ds):
        """Validation view of a dataset: deterministic (no random flip),
        like the reference's train=False val transforms."""
        ds = copy.copy(ds)
        ds.o = dataclasses.replace(ds.o, random_flip=False)
        return ds

    trains, vals = [], []
    if explicit_val:
        trains = [ds for comp, ds in per_comp if train_on.get(comp, True)]
        vals = explicit_val
    else:
        frac = float(cfg.get("val_fraction", 0.05))
        for comp, ds in per_comp:
            if not val_on.get(comp, True):  # train-only component
                trains.append(ds)
                continue
            if not train_on.get(comp, True):  # val-only: ALL samples validate
                vals.append(as_val(ds))
                continue
            tr, va = ds.holdout(frac)
            if len(tr) == 0 or len(va) == 0:  # too small to split
                trains.append(ds)
                continue
            trains.append(tr)
            vals.append(as_val(va))
    return trains, vals


def load_pretrained(net: torch.nn.Module, path: str) -> None:
    """--pretrained: the params of a checkpoint directory written by these
    trainers, or a published torch .ckpt/.pth
    (``models.registry.load_checkpoint``)."""
    from ..models.registry import load_checkpoint

    load_checkpoint(net, path)


def state_tree(state) -> dict:
    """The checkpointed tree: params + optimizer state + step, so --resume
    continues bit for bit."""
    return {"step": torch.tensor(state.step, dtype=torch.int64),
            "params": state.net.state_dict(), "opt_state": state.opt_state}


def try_resume(ckpt, state):
    """Restore 'last' into the train state in place, each tensor copied
    into its live counterpart on its device. -> (state, resumed: bool)."""
    if not os.path.isdir(os.path.join(ckpt.directory, "last")):
        return state, False
    tree = ckpt.restore("last")
    state.net.load_state_dict(tree["params"], strict=True)
    saved = tree["opt_state"]
    if set(saved) != set(state.opt_state):
        raise ValueError(f"checkpoint optimizer state {sorted(saved)} does not "
                         f"match this optimizer's {sorted(state.opt_state)}")
    with torch.no_grad():
        for k, live in state.opt_state.items():
            if isinstance(live, list):
                if len(saved[k]) != len(live):
                    raise ValueError(f"checkpoint {k}: {len(saved[k])} tensors, "
                                     f"this model trains {len(live)}")
                for dst, src in zip(live, saved[k]):
                    dst.copy_(src)
            else:
                state.opt_state[k] = saved[k].clone()
    state.step = int(tree["step"])
    return state, True


def run_training(cfg: dict, args, state, datasets, val_datasets, *, prepare,
                 step_fn, eval_fn, loss_key: str, default_ckpt_dir: str,
                 device: torch.device) -> None:
    """The drivers' shared loop. prepare(numpy batch, train) -> device
    batch; step_fn(state, batch, generator) -> metrics; eval_fn(net, batch,
    generator) -> (metrics, pred)."""
    from ..data.loader import MixedLoader
    from ..utils.experiment import ExperimentLogger
    from .callbacks import save_crash_dump
    from .checkpoints import CheckpointManager
    from .loop import dump_val_images, run_validation

    batch_size = int(cfg.get("batch_size", 8))
    max_steps = args.max_steps or int(cfg.get("max_steps", 100000))
    ckpt_dir = args.checkpoint_dir or cfg.get("checkpoint_dir", default_ckpt_dir)
    ckpt = CheckpointManager(ckpt_dir, save_top_k=int(cfg.get("save_top_k", 3)))
    if args.resume:
        state, resumed = try_resume(ckpt, state)
        if resumed:
            print(f"resumed from {ckpt_dir}/last at step {state.step}")
    # the JAX drivers seed their key afresh at every start, resume included
    generator = torch.Generator(device=device).manual_seed(0)
    explog = ExperimentLogger(cfg.get("log_dir", ckpt_dir), config=cfg,
                              backend=cfg.get("log_backend", "auto"))

    def validate(step):
        val_loss, sample = run_validation(
            val_datasets, batch_size, lambda nb: prepare(nb, False),
            lambda b: eval_fn(state.net, b, generator), loss_key)
        if val_loss is None:
            return
        print(f"step {step}: {loss_key} {val_loss:.4f}")
        explog.log(step, {loss_key: val_loss})
        dump_val_images(ckpt_dir, step, sample)
        ckpt.save(state_tree(state), step, metric=val_loss)

    log_step = int(cfg.get("log_step", 100))
    val_step = int(cfg.get("val_step", 3000))  # reference log_step: 3000
    ckpt_step = int(cfg.get("ckpt_step", 1000))
    loader = MixedLoader(datasets, batch_size, num_workers=int(cfg.get("num_workers", 8)))
    t0 = time.time()
    done = 0
    for batch in loader.batches(steps=max_steps - state.step, seed=state.step):
        b = prepare(batch, True)
        try:
            metrics = step_fn(state, b, generator)
        except Exception as e:  # crash dump (train_*.py:341-348)
            d = save_crash_dump(ckpt_dir, state.net.state_dict(), b, e)
            print(f"saved crash dump to {d}")
            raise
        done += 1
        step = state.step
        if step % log_step == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step}: {m} ({(time.time() - t0) / done:.2f}s/step)")
            explog.log(step, dict(m, sec_per_step=(time.time() - t0) / done))
        if step % val_step == 0:
            validate(step)
        if step % ckpt_step == 0:
            ckpt.save(state_tree(state), step, metric=None)
    ckpt.save(state_tree(state), state.step, metric=None)
    explog.finish()
    print(f"done: {state.step} steps in {time.time() - t0:.1f}s")


def to_device(batch: dict, device: torch.device) -> dict:
    """The trainers' numpy batch -> float32 tensors (bool mask) on device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}
