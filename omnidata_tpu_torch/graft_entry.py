"""Driver entry points, the port's counterpart of the root
``__graft_entry__.py``:

- ``entry()``: the flagship forward (DPT-hybrid-384 surface normals, the
  published widths, 384²) and its example arguments, on the card unless
  the caller asks for the CPU.
- ``dryrun_multichip(n)``: one full depth training step (DPT with the MiDaS
  and VNL losses, Adam, the clip at 10) over an n-rank (data, model) grid
  with data parallelism and the Megatron splits of the ViT
  (``train/parallel``), then a sharded annotation of n views.

    python -m omnidata_tpu_torch.graft_entry [N] [--device cuda|cpu]

Both run on the card unless the caller asks for the CPU; a card that is
not there raises. ``dryrun_multichip`` runs under a process group of n
ranks when one is initialised (torchrun); otherwise it starts its own: n
processes in an NCCL group, one card a rank, or with ``device="cpu"`` in a
gloo group on the CPU (none for n = 1). On the card n ranks need n cards,
and the annotation renders on n cards (``make_annotate_mesh``).
"""
from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .annotator.cli import resolve_device

# JAX's dryrun default: the full 12-block dim-768 step is the same sharding
# structure, block for block, and far slower on CPU processes
TINY_DPT = dict(vit_blocks=2, hooks=(0, 1), vit_dim=128, vit_heads=4, features=32)
DRYRUN_RES = 32
ANNOTATE_RES = 64


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): fn(net, x) is DPT-hybrid-384's normals forward
    on seeded weights; x is one 384² image (zeros), NCHW."""
    from .models import DPTHybrid
    from .models.registry import init_weights

    dev = torch.device(device)
    net = DPTHybrid(num_channels=3)
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    x = torch.zeros((1, 3, 384, 384), device=dev)

    def fn(net, x):
        with torch.no_grad():
            return net(x)

    return fn, (net, x)


def _grid(n: int) -> tuple:
    """(n_data, n_model): model_parallel 2 when n is even and at least 4."""
    n_model = 2 if (n % 2 == 0 and n >= 4) else 1
    return n // n_model, n_model


def _dryrun_rank(n: int, model_kw: dict, device: torch.device) -> dict:
    """This rank's part of the dryrun -> what rank 0 prints."""
    from .losses import VNLParams
    from .models import DPTHybrid
    from .models.registry import init_weights
    from .train import create_train_state, depth_optimizer, make_depth_train_step, multihost
    from .train.parallel import make_mesh, shard_module

    n_data, n_model = _grid(n)
    mesh = make_mesh(n_data, n_model)
    net = DPTHybrid(num_channels=1, **model_kw)
    init_weights(net, torch.Generator().manual_seed(0))
    state = create_train_state(shard_module(net.to(device), mesh), depth_optimizer(), mesh)
    H = DRYRUN_RES
    batch = {"rgb": torch.zeros((1, 3, H, H), device=device),  # one image a data rank
             "depth": torch.full((1, 1, H, H), 0.5, device=device),
             "mask_valid": torch.ones((1, 1, H, H), dtype=torch.bool, device=device)}
    step = make_depth_train_step(lambda m, x: m(x)[:, 0], VNLParams(1.0, 1.0, (H, H)))
    metrics = step(state, batch, torch.Generator(device=device).manual_seed(0))
    loss = float(metrics["loss"])
    if loss != loss:
        raise AssertionError("NaN loss in dryrun")
    out = {"train": f"dryrun_multichip OK: mesh={mesh.shape} batch={n_data} loss={loss:.4f}"}
    if multihost.rank() == 0:
        out["annotate"] = _sharded_annotation(n, device)
    multihost.barrier("annotated")
    return out


def _sharded_annotation(n: int, device: torch.device) -> str:
    """JAX's dryrun scene (room + sphere) annotated from n cameras, split
    over n devices: n cards, or n slots on the CPU when device is the
    CPU."""
    from .annotator import annotate_views_sharded, make_annotate_mesh
    from .core import Camera, look_at_rotation
    from .mesh import from_arrays, room, uv_sphere

    r = room(size=6.0, height=3.0)
    s = uv_sphere(radius=0.6, center=(0.5, 0.2, 1.2), n_lat=12, n_lon=24)
    vs = np.concatenate([np.asarray(r.vertices.cpu()), np.asarray(s.vertices.cpu())])
    fs = np.concatenate([np.asarray(r.faces[: r.num_faces].cpu()),
                         np.asarray(s.faces[: s.num_faces].cpu()) + r.vertices.shape[0]])
    scene = from_arrays(vs, fs, device=device)
    rng = np.random.RandomState(0)
    locs = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(1.0, 2.0, n)], -1)
    tgts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(0.5, 2.0, n)], -1)
    locs, tgts = (torch.tensor(a, dtype=torch.float32, device=scene.vertices.device)
                  for a in (locs, tgts))
    cams = Camera(locs, look_at_rotation(locs, tgts), torch.full((n,), 1.2, device=locs.device),
                  ANNOTATE_RES)
    amesh = make_annotate_mesh(n) if device.type == "cuda" else [device] * n
    out = annotate_views_sharded(cams, scene, device_mesh=amesh, tile=32, chunk=64,
                                 modalities=("depth_zbuffer", "normal", "mask_valid"))
    dz = out["depth_zbuffer"].cpu().to(torch.int32)
    if tuple(dz.shape) != (n, ANNOTATE_RES, ANNOTATE_RES) or not bool((dz < 65535).any()):
        raise AssertionError(f"sharded annotation: {tuple(dz.shape)}")
    return (f"dryrun_multichip annotate OK: {n}-way sharded render, "
            f"{int((dz < 65535).sum())} valid px")


def _spawned(rank: int, n: int, port: int, device_type: str, model_kw: dict,
             results) -> None:
    """One rank of the group dryrun_multichip starts: NCCL with one card a
    rank, or gloo on the CPU."""
    torch.set_num_threads(1)
    device = torch.device("cpu")
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=n)
    try:
        out = _dryrun_rank(n, model_kw, device)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda", **model_kw) -> None:
    """One sharded depth step and a sharded annotation over n_devices
    ranks, on n cards (device "cuda", the default) or CPU processes
    (device "cpu"); prints JAX's two OK lines. model_kw: DPTHybrid
    overrides of the tiny default (vit_blocks=12, hooks=(8, 11),
    vit_dim=768, vit_heads=12, features=256 for the full model)."""
    from .train import multihost

    model_kw = {**TINY_DPT, **model_kw}
    dev = resolve_device(str(device))
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on the card runs one rank a card, "
                         f"and {torch.cuda.device_count()} are present (device='cpu' runs "
                         "the ranks on the CPU)")
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) under a process group "
                             f"of {dist.get_world_size()}")
        if dev.type == "cuda":
            dev = torch.device("cuda", multihost.local_rank())
            torch.cuda.set_device(dev)
        out = _dryrun_rank(n_devices, model_kw, dev)
    elif n_devices == 1:
        out = _dryrun_rank(1, model_kw, torch.device("cuda", 0) if dev.type == "cuda" else dev)
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        results = ctx.SimpleQueue()
        # joined before the queue is read: rank 0's result is a few hundred
        # bytes, which the pipe holds without a reader
        mp.start_processes(_spawned, args=(n_devices, port, dev.type, model_kw, results),
                           nprocs=n_devices, start_method="spawn")
        out = results.get()
    if "annotate" in out:
        print(out["train"])
        print(out["annotate"], flush=True)


if __name__ == "__main__":
    import argparse

    from .train import multihost

    ap = argparse.ArgumentParser(description="one sharded depth step and a sharded "
                                 "annotation over N ranks")
    ap.add_argument("n", nargs="?", type=int, help="ranks (default: the world size)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a "
                    "card) or cpu")
    args = ap.parse_args()
    resolve_device(args.device)
    multihost.initialize(args.device)
    try:
        dryrun_multichip(args.n or multihost.world_size(), device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
