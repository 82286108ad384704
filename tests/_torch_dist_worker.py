"""Worker processes of the port's multi-process tests (no JAX here): the
tests start one process per rank, as torchrun does, with RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT and LOCAL_RANK set, and the worker joins a gloo
group on the CPU through ``multihost.initialize("cpu")``.

    python tests/_torch_dist_worker.py MODE JOB OUT

MODE ``steps``: for each grid of JOB's ``grids`` (n_data·n_model = world
size) and each case of its ``cases``, one sharded training step
(``run_case``); rank 0 writes the global metrics and the gathered
parameters to OUT. MODE ``shares``: each batch-global loss's shares
(``loss_shares``) on a (world, 1) grid, summed, and their gradients.
MODE ``multihost``: the multihost API at this world size; rank 0 writes
what every rank saw. MODE ``driver``: ``train_depth.main`` with the tiny
DPT on each argv of JOB's ``runs`` in turn.
"""
from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from omnidata_tpu_torch.graft_entry import TINY_DPT  # noqa: E402  (JAX's dryrun DPT)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(mode: str, world: int, job, out: Path, timeout: int = 300):
    """Start `world` ranks of this script on JOB (saved next to OUT) and
    wait; a rank that fails raises with its output. -> OUT's contents
    (both files are removed: they hold hundreds of MB of tensors)."""
    job_path = out.with_suffix(".job.pt")
    torch.save(job, job_path)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, str(job_path), str(out)], env=env,
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    job_path.unlink()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-3000:]}"
    result = torch.load(out, weights_only=False)
    out.unlink()
    return result


# ---------------- one training step ----------------

def make_net(case):
    from omnidata_tpu_torch.models import DPTHybrid, UNet

    if case["kind"] == "depth":
        net = DPTHybrid(num_channels=1, **TINY_DPT)
    else:
        net = UNet(out_channels=3, downsample=2)
    net.load_state_dict(case["state_dict"])
    return net


class _Seen:
    """An optimizer that records what the step gives it: the gradients
    (the data group's sum, when sharded) and the clip's global norm, of
    them all and of the model-split tensors alone ("norm_split"; and
    "norm_split_unreduced", one rank's shards without the model group's
    sum)."""

    def __init__(self, tx):
        self.tx, self.seen, self.names = tx, {}, None

    def init(self, params):
        return self.tx.init(params)

    def step(self, params, grads, state, split=None, model_group=None):
        from omnidata_tpu_torch.train.parallel import split_dim

        norm = self.tx.global_norm
        self.seen["grads"] = [g.detach().clone() for g in grads]
        self.seen["norm"] = float(norm(grads, split, model_group))
        sub = [g for n, g in zip(self.names, grads) if split_dim(n) is not None]
        if sub:
            self.seen["norm_split"] = float(norm(sub, [True] * len(sub), model_group)
                                            if model_group is not None else norm(sub))
            self.seen["norm_split_unreduced"] = float(norm(sub))
        self.tx.step(params, grads, state, split, model_group)


def run_case(case: dict, mesh=None) -> dict:
    """One step of case on this rank's rows of its global batch, sharded
    over mesh (None: one process on the whole batch), from fresh moments or
    from case's unsharded ``opt_state`` (count, mu and nu by name). ->
    {"metrics": global metrics as floats, "params": the unsharded trainable
    parameters, "start": the unsharded parameters before, "grads": the
    unsharded gradients the optimizer was given, and ``_Seen``'s norms}."""
    from omnidata_tpu_torch import train as T
    from omnidata_tpu_torch.losses import VNLParams
    from omnidata_tpu_torch.train.parallel import (gather_state_dict, gather_tensor,
                                                   shard_module, shard_tensor)

    net = make_net(case)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    if mesh is not None:
        shard_module(net, mesh)
    clip = case.get("grad_clip", 10.0)
    tx = (T.depth_optimizer(lr=case["lr"], grad_clip=clip) if case["kind"] == "depth"
          else T.normal_optimizer(lr=case["lr"], grad_clip=clip))
    seen = _Seen(tx)
    state = T.create_train_state(net, seen, mesh)
    seen.names = state.names
    state.step = case["step"]
    n_model, index = (mesh.n_model, mesh.model_index) if mesh is not None else (1, 0)
    if "opt_state" in case:
        warm = case["opt_state"]
        state.opt_state["count"] = torch.tensor(warm["count"], dtype=torch.int32)
        for k in ("mu", "nu"):
            state.opt_state[k] = [shard_tensor(n, warm[k][n], n_model, index).clone()
                                  for n in state.names]
    (i, n) = (mesh.data_index, mesh.n_data) if mesh is not None else (0, 1)
    batch = {k: torch.from_numpy(np.array(np.split(v, n)[i])) for k, v in case["batch"].items()}
    gen = torch.Generator().manual_seed(0)
    H = case["batch"]["rgb"].shape[-1]
    if case["kind"] == "depth":
        step = T.make_depth_train_step(lambda m, x: m(x)[:, 0], VNLParams(1.0, 1.0, (H, H)),
                                       augment=case["augment"], image_size=H)
        metrics = step(state, batch, gen, triplets=case.get("triplets"))
    else:
        step = T.make_normal_train_step(lambda m, x: m(x), augment=case["augment"],
                                        image_size=H)
        metrics = step(state, batch, gen)
    full = gather_state_dict(net, mesh) if mesh is not None else net.state_dict()
    grads = {name: (gather_tensor(name, g, mesh) if mesh is not None else g)
             for name, g in zip(state.names, seen.seen["grads"])}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: full[k].clone() for k in state.names}, "start": start,
            "grads": grads, **{k: v for k, v in seen.seen.items() if k != "grads"}}


def grad_errors(got: dict, want: dict) -> dict:
    """name -> |got - want| / |want| in L2 of each gradient, and "all" of
    them as one vector; a gradient that is exactly zero in want must be
    exactly zero in got (0, else inf)."""
    out = {}
    for k, w in want.items():
        d, n = float((got[k] - w).norm()), float(w.norm())
        out[k] = d / n if n else (0.0 if d == 0 else float("inf"))
    d = sum(float((got[k] - w).norm()) ** 2 for k, w in want.items()) ** 0.5
    out["all"] = d / sum(float(w.norm()) ** 2 for w in want.values()) ** 0.5
    return out


# ---------------- modes ----------------

def mode_steps(job, out):
    """Each grid's step of each case; rank 0 holds the gradients to the
    one-process ones in JOB's ``want_grads`` file (13M floats a depth
    case, so they are compared here and not written back)."""
    from omnidata_tpu_torch.train import multihost
    from omnidata_tpu_torch.train.parallel import make_mesh

    want = torch.load(job["want_grads"], mmap=True) if multihost.rank() == 0 else None
    results = {}
    for n_data, n_model in job["grids"]:
        mesh = make_mesh(n_data, n_model)
        for name, case in job["cases"].items():
            res = run_case(case, mesh)
            res.pop("start")
            grads = res.pop("grads")
            if want is not None:
                res["grad_rel"] = grad_errors(grads, want[name])
            results[(n_data, n_model, name)] = res
    return results


def loss_shares(inputs: dict, group=None) -> dict:
    """name -> (value, d value / d pred) of each batch-global loss on these
    rows of the batch (inputs: pred, gt (B,1,H,W), mask (B,1,H,W) bool,
    triplets (3,N)), as this rank's share over group (None: one process)."""
    from omnidata_tpu_torch import losses as L

    H = inputs["pred"].shape[-1]
    params = L.VNLParams(1.0, 1.0, (H, H))
    fns = {
        "masked_l1": lambda p, g, m: L.masked_l1_loss(p, g, m, group),
        "masked_cosine": lambda p, g, m: L.masked_cosine_angular_loss(
            p.expand(-1, 3, -1, -1), g.expand(-1, 3, -1, -1) * 0.9, m, group),
        "ssi_mae": lambda p, g, m: L.ssi_mae(p, g, m, group),
        "reg_image_based": lambda p, g, m: L.inverse_depth_regularizer(p, g, m, group=group),
        "reg_batch_based": lambda p, g, m: L.inverse_depth_regularizer(
            p, g, m, reduction="batch-based", group=group),
        "vnl": lambda p, g, m: L.vnl_from_indices(p, g, inputs["triplets"], params, group=group),
        "vnl_no_select": lambda p, g, m: L.vnl_from_indices(
            p, g, inputs["triplets"], params, select=False, group=group),
    }
    out = {}
    for name, fn in fns.items():
        pred = inputs["pred"].clone().requires_grad_(True)
        value = fn(pred, inputs["gt"], inputs["mask"])
        out[name] = (value.detach(), torch.autograd.grad(value, pred)[0])
    return out


def mode_shares(job, out):
    """Each rank's shares over the data group of a (world, 1) grid: their
    sums, and the gradients of the shares gathered in batch order."""
    from omnidata_tpu_torch.train.parallel import make_mesh
    from omnidata_tpu_torch.utils.collectives import all_gather_cat, all_sum

    mesh = make_mesh()
    i, n = mesh.data_index, mesh.n_data
    rows = {k: (torch.tensor_split(v, n)[i] if k != "triplets" else v)
            for k, v in job["inputs"].items()}
    return {name: (float(all_sum(v, mesh.data_group)), all_gather_cat(g, mesh.data_group))
            for name, (v, g) in loss_shares(rows, mesh.data_group).items()}


def mode_multihost(job, out):
    import torch.distributed as dist

    from omnidata_tpu_torch.train import multihost
    from omnidata_tpu_torch.train.parallel import make_mesh

    rank, world = multihost.rank(), multihost.world_size()
    mesh = make_mesh()
    local = {"rgb": torch.arange(2 * 3, dtype=torch.float32).reshape(2, 3) + 100 * rank,
             "mask": torch.full((2, 1), rank, dtype=torch.int64)}
    g = multihost.local_batch_to_global(mesh, local)
    multihost.barrier("test")
    try:
        multihost.process_local_batch_size(7)
        uneven = None
    except ValueError as e:
        uneven = type(e).__name__
    return {"rank": rank, "world": world, "backend": dist.get_backend(),
            "stripe": multihost.stripe(list(range(7))),
            "local_batch": multihost.process_local_batch_size(8), "uneven": uneven,
            "global_shape": tuple(g["rgb"].shape),
            "global_rgb": g["rgb"].full_tensor(),
            "placements": [str(p) for p in g["rgb"].placements]}


def mode_driver(job, out):
    """``train_depth.main`` on each argv of JOB's ``runs`` in turn, with
    the tiny DPT -> the 'last' checkpoint each run leaves in its
    checkpoint directory."""
    from omnidata_tpu_torch import train_depth
    from omnidata_tpu_torch.models import DPTHybrid
    from omnidata_tpu_torch.train.checkpoints import load_tree

    train_depth.DPTHybrid = functools.partial(DPTHybrid, **TINY_DPT)
    lasts = []
    for argv, ckpt in job["runs"]:
        train_depth.main(argv)
        lasts.append(load_tree(os.path.join(ckpt, "last")))
    return lasts


def main(mode: str, job_path: str, out: str) -> None:
    torch.set_num_threads(1)
    from omnidata_tpu_torch.train import multihost

    if not multihost.initialize("cpu"):
        raise RuntimeError("no process group from the environment")
    job = torch.load(job_path, weights_only=False)
    result = {"steps": mode_steps, "shares": mode_shares, "multihost": mode_multihost,
              "driver": mode_driver}[mode](job, out)
    gathered = [None] * multihost.world_size()
    import torch.distributed as dist

    dist.all_gather_object(gathered, result if mode == "multihost" else None)
    if multihost.rank() == 0:
        torch.save(gathered if mode == "multihost" else result, out)
    multihost.barrier("written")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
