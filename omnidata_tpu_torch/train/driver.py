"""Shared train-driver plumbing for ``train_depth`` / ``train_normal``, the
port's counterpart of the JAX package's ``train/driver.py`` and of the loop
its two drivers share:

- component dataset construction honoring the reference config schema
  (config/depth.yml: data_paths + train_datasets / val_datasets toggles +
  taskonomy_variant subset ladder), optionally through the packed sample
  cache (``packed_cache``)
- the process group and the (data, model) grid: one process per device
  under torchrun (``multihost.initialize``), ``data_parallel`` and
  ``model_parallel`` as the JAX drivers read them, each rank on
  cuda:LOCAL_RANK; without a process group, one process on one device
- resume from the 'last' checkpoint (reference Lightning resume /
  ModelCheckpoint save_last, train_normal.py:371-374): params, optimizer
  state, step, and where the run stood in its data plan and its
  generator's draws, so a resumed run takes the steps the uninterrupted
  run would have taken, bit for bit at the same world size (the JAX
  drivers start a new plan from the step and a fresh key instead); every
  rank restores the unsharded checkpoint and takes its shard, so any
  world size resumes
- warm start from a published checkpoint (reference pretrained_weights_path,
  train_normal.py:78-87 prefix-stripped torch load) or one of the port's
- the training loop: mixed-component batches (each data rank decodes its
  rows of the one global plan), the step, logs every log_step, validation
  + images + top-k checkpoint every val_step, 'last' every ckpt_step and at
  the end, a crash dump on error. Validation is replicated over the data
  axis: every rank evaluates the whole val batch through the sharded
  model. Rank 0 gathers the state and alone writes checkpoints,
  ``scores.json``, validation PNGs and logs, in the single-device format.
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
from . import multihost
from .parallel import gather_state_dict, gather_tensor, make_mesh, shard_tensor

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
    port does not know."""
    cfg = load_file(path) or {}
    unknown = sorted(set(cfg) - known)
    if unknown and multihost.rank() == 0:
        print(f"[config] WARNING: ignoring unknown keys {unknown} "
              f"(known: {sorted(known)})")
    return cfg


def parallel_setup(cfg: dict, device_name: str):
    """-> (mesh, device): torchrun's process group, if any
    (``multihost.initialize``: NCCL on a card, gloo on the CPU); the grid
    from data_parallel / model_parallel (data_parallel absent takes the
    remaining ranks; a grid that is not the world size raises ValueError);
    this rank's device, cuda:LOCAL_RANK (modulo the cards present) in a
    group, else ``device_name`` as it is."""
    multihost.initialize(device_name)
    n_data = cfg.get("data_parallel")
    mesh = make_mesh(int(n_data) if n_data else None, int(cfg.get("model_parallel", 1)))
    device = resolve_device(device_name)
    if device.type == "cuda" and multihost.world_size() > 1:
        device = torch.device("cuda", multihost.local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return mesh, device


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

    pack_dir = cfg.get("packed_cache")
    if pack_dir:
        # decode-once sample cache (data/packed_cache.py): a sample becomes
        # memmap row reads plus the joint crop/flip. Packs are keyed on each
        # dataset's resolved index, so train and val never alias.
        from ..data.packed_cache import PackedDataset

        workers = int(cfg.get("num_workers", 8))

        def packed(dsets):
            return [PackedDataset.build(d, pack_dir, workers) for d in dsets]

        # rank 0 writes the packs; the other ranks then open them
        if multihost.rank() == 0:
            trains, vals = packed(trains), packed(vals)
        multihost.barrier("packed")
        if multihost.rank() != 0:
            trains, vals = packed(trains), packed(vals)
    return trains, vals


def load_pretrained(net: torch.nn.Module, path: str) -> None:
    """--pretrained: the params of a checkpoint directory written by these
    trainers, or a published torch .ckpt/.pth
    (``models.registry.load_checkpoint``)."""
    from ..models.registry import load_checkpoint

    load_checkpoint(net, path)


def state_tree(state, generator: torch.Generator | None = None, plan_seed: int = 0) -> dict:
    """The checkpointed tree: params + optimizer state + step, and with a
    generator the run's place in its draws ("run": the seed of its data
    plan, the generator's device type and state), so --resume continues
    bit for bit. Unsharded, in the single-device format: the model-split
    tensors are gathered (collective over the model group: every rank
    calls it)."""
    mesh = state.mesh
    if mesh is None or mesh.model_group is None:
        params, opt = state.net.state_dict(), state.opt_state
    else:
        params = gather_state_dict(state.net, mesh)
        opt = {k: [gather_tensor(n, t, mesh) for n, t in zip(state.names, v)]
               if isinstance(v, list) else v for k, v in state.opt_state.items()}
    tree = {"step": torch.tensor(state.step, dtype=torch.int64),
            "params": params, "opt_state": opt}
    if generator is not None:
        tree["run"] = {"plan_seed": plan_seed, "rng_device": generator.device.type,
                       "rng": generator.get_state()}
    return tree


def try_resume(ckpt, state, generator: torch.Generator | None = None):
    """Restore 'last' into the train state in place, each tensor copied
    into its live counterpart on its device (this rank's shard of it, when
    sharded), and the generator's state when the checkpoint holds one of
    its device type. -> (state, plan seed: the seed of the data plan the
    checkpointed run followed, or None when nothing was restored; a
    checkpoint without one gives the step, as the JAX drivers seed)."""
    if not os.path.isdir(os.path.join(ckpt.directory, "last")):
        return state, None
    tree = ckpt.restore("last")
    mesh = state.mesh
    n_model, index = (mesh.n_model, mesh.model_index) if mesh is not None else (1, 0)
    state.net.load_state_dict({k: shard_tensor(k, v, n_model, index)
                               for k, v in tree["params"].items()}, strict=True)
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
                for name, dst, src in zip(state.names, live, saved[k]):
                    dst.copy_(shard_tensor(name, src, n_model, index))
            else:
                state.opt_state[k] = saved[k].clone()
    state.step = int(tree["step"])
    run = tree.get("run")
    if run is None:
        return state, state.step
    if generator is not None and run["rng_device"] == generator.device.type:
        generator.set_state(run["rng"])
    return state, int(run["plan_seed"])


def run_training(cfg: dict, args, state, datasets, val_datasets, *, prepare,
                 step_fn, eval_fn, loss_key: str, default_ckpt_dir: str,
                 device: torch.device) -> None:
    """The drivers' shared loop. prepare(numpy batch, train) -> device
    batch; step_fn(state, batch, generator) -> metrics; eval_fn(net, batch,
    generator) -> (metrics, pred). Sharded (``state.mesh``), every rank
    runs it; rank 0 alone prints, logs and writes."""
    from ..data.loader import MixedLoader
    from ..utils.experiment import ExperimentLogger
    from .callbacks import save_crash_dump
    from .checkpoints import CheckpointManager
    from .loop import dump_val_images, run_validation

    lead = multihost.rank() == 0
    say = print if lead else (lambda *a, **k: None)
    batch_size = int(cfg.get("batch_size", 8))
    max_steps = args.max_steps or int(cfg.get("max_steps", 100000))
    ckpt_dir = args.checkpoint_dir or cfg.get("checkpoint_dir", default_ckpt_dir)
    ckpt = CheckpointManager(ckpt_dir, save_top_k=int(cfg.get("save_top_k", 3)))
    # every rank seeds alike, so the triplets and augmentation draws agree
    generator = torch.Generator(device=device).manual_seed(0)
    plan_seed = state.step
    if args.resume:
        state, seed = try_resume(ckpt, state, generator)
        if seed is not None:
            plan_seed = seed
            say(f"resumed from {ckpt_dir}/last at step {state.step}")
        multihost.barrier("restored")  # before rank 0 rotates 'last'
    explog = ExperimentLogger(cfg.get("log_dir", ckpt_dir), config=cfg,
                              backend=cfg.get("log_backend", "auto")) if lead else None

    def save(step, metric=None):
        tree = state_tree(state, generator, plan_seed)  # collective when model-sharded
        if lead:
            ckpt.save(tree, step, metric=metric)

    def validate(step):
        val_loss, sample = run_validation(
            val_datasets, batch_size, lambda nb: prepare(nb, False),
            lambda b: eval_fn(state.net, b, generator), loss_key)
        if val_loss is None:
            return
        say(f"step {step}: {loss_key} {val_loss:.4f}")
        if lead:
            explog.log(step, {loss_key: val_loss})
            dump_val_images(ckpt_dir, step, sample)
        save(step, metric=val_loss)

    log_step = int(cfg.get("log_step", 100))
    val_step = int(cfg.get("val_step", 3000))  # reference log_step: 3000
    ckpt_step = int(cfg.get("ckpt_step", 1000))
    loader = MixedLoader(datasets, batch_size, num_workers=int(cfg.get("num_workers", 8)))
    mesh = state.mesh
    shard = (mesh.data_index, mesh.n_data) if mesh is not None else (0, 1)
    t0 = time.time()
    done = 0
    for batch in loader.batches(steps=max_steps - state.step, seed=plan_seed, shard=shard,
                                skip=state.step - plan_seed):
        b = prepare(batch, True)
        try:
            metrics = step_fn(state, b, generator)
        except Exception as e:  # crash dump (train_*.py:341-348)
            where = ckpt_dir if lead else os.path.join(ckpt_dir, f"rank{multihost.rank()}")
            d = save_crash_dump(where, state.net.state_dict(), b, e)
            print(f"saved crash dump to {d}")
            raise
        done += 1
        step = state.step
        if step % log_step == 0 and lead:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step}: {m} ({(time.time() - t0) / done:.2f}s/step)")
            explog.log(step, dict(m, sec_per_step=(time.time() - t0) / done))
        if step % val_step == 0:
            validate(step)
        if step % ckpt_step == 0:
            save(step)
    save(state.step)
    if lead:
        explog.finish()
    multihost.barrier("saved")
    say(f"done: {state.step} steps in {time.time() - t0:.1f}s")


def to_device(batch: dict, device: torch.device) -> dict:
    """The trainers' numpy batch -> float32 tensors (bool mask) on device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}
