"""Multi-device annotation in one process: the camera batch split over local
devices, every device running the batched pipeline (``annotate_views``) on
its slice against its own copy of the mesh. No collectives: views are
independent, as in the reference's process pool over views.

The counterpart of ``omnidata_tpu.annotator.distributed``, whose
``shard_map`` is one controller driving n local devices; here one host
thread per device issues that device's launches, so they overlap (the
launches release the GIL while the devices run).
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.cameras import Camera
from ..mesh.mesh import TriangleMesh
from .pipeline import DEVICE_MODALITIES, annotate_views


def make_annotate_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first n_devices CUDA devices (all of them by default)."""
    n_avail = torch.cuda.device_count()
    n = n_avail if n_devices is None else n_devices
    if n_avail == 0:
        raise RuntimeError("make_annotate_mesh: no CUDA device")
    if not 1 <= n <= n_avail:
        raise ValueError(f"make_annotate_mesh: {n} devices asked for, "
                         f"{n_avail} present")
    return [torch.device("cuda", i) for i in range(n)]


def _mesh_on(mesh: TriangleMesh | None, device: torch.device):
    if mesh is None:
        return None
    return mesh._replace(**{k: v.to(device) for k, v in mesh._asdict().items()
                            if isinstance(v, torch.Tensor)})


def annotate_views_sharded(
    cameras: Camera,
    mesh_geom: TriangleMesh,
    curvature_mesh: TriangleMesh | None = None,
    device_mesh: list | None = None,
    tile: int = 64,
    cap: int = 1024,
    chunk: int = 128,
    modalities: tuple = DEVICE_MODALITIES,
) -> dict[str, torch.Tensor]:
    """Annotate B views (location (B,3), R (B,3,3), fov (B,)) split over the
    devices of device_mesh (a list of devices or device names; default
    ``make_annotate_mesh()``): device i annotates views [i*B/n, (i+1)*B/n)
    with ``annotate_views``. B must be divisible by n. The mesh is copied to
    each device once per call. -> {modality: (B, H, W, ...)} on the first
    device, in camera order. cap is accepted for the JAX signature; the
    raster kernels need none."""
    del cap
    devices = [torch.device(d) for d in (device_mesh or make_annotate_mesh())]
    n = len(devices)
    B = cameras.location.shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by {n} devices")
    per = B // n

    def run(i: int) -> dict[str, torch.Tensor]:
        dev = devices[i]
        sl = slice(i * per, (i + 1) * per)
        cams = Camera(cameras.location[sl].to(dev), cameras.R[sl].to(dev),
                      cameras.fov[sl].to(dev), cameras.resolution)
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            return annotate_views(cams, _mesh_on(mesh_geom, dev),
                                  _mesh_on(curvature_mesh, dev), tile=tile,
                                  chunk=chunk, modalities=modalities)

    with ThreadPoolExecutor(max_workers=n) as pool:
        outs = list(pool.map(run, range(n)))
    return {k: torch.cat([o[k].to(devices[0]) for o in outs])
            for k in outs[0]}

