"""The annotator's cells: the CLI's batched pipeline on one scene.

Set-up does what the CLI does once it has read a mesh file
(``cli.prepare_device_mesh``): the mesh on the card (``mesh.from_arrays``)
and its curvature colours baked (``bake_curvature_colors`` at
MIN_CURVATURE_RADIUS). The scene's arrays come from the benchmark's own
generator (``gen.scene``), cached under ``benchmark/cache``; the cameras
of the traffic's ``camera_seed`` (``gen.cameras``), cut into a pool of
``pool_batches`` batches of ``views_per_batch`` in the order they were
drawn; the window takes the batches in turn, in an order drawn from
``--seed``.

The window is a closed loop with one client, the CLI's own pipeline
(``cli.render_batches`` with ``cli.annotate_kwargs``): it pulls the next
camera batch as soon as the previous one is enqueued, and every batch's
labels come back to the host. A view is done when its labels have reached
the loop; the views done inside the window are what ``views_per_s`` counts.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np

from ..gen import cameras as gen_cameras
from ..gen import scene as gen_scene

CACHE = Path(__file__).resolve().parent.parent / "cache"
U16 = ("depth_zbuffer", "depth_euclidean", "edge_occlusion", "edge_texture",
       "keypoints2d")
CHANNELS = {"normal": 3, "rgb": 3, "principal_curvature": 3}


def scene_arrays(params: dict):
    """The scene's (vertices, faces, colours), generated once per checkout
    and kept in the benchmark's cache."""
    key = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]
    path = CACHE / f"scene-{key}.npz"
    if path.exists():
        z = np.load(path)
        return z["v"], z["f"], z["c"]
    v, f, c = gen_scene.build(params)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = CACHE / f"scene-{key}.tmp{os.getpid()}.npz"
    np.savez(tmp, v=v, f=f, c=c)
    os.replace(tmp, path)
    return v, f, c


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch

        from omnidata_tpu_torch.annotator import cli
        from omnidata_tpu_torch.annotator.settings import Settings
        from omnidata_tpu_torch.core.cameras import Camera
        from omnidata_tpu_torch.cues.curvature import bake_curvature_colors
        from omnidata_tpu_torch.mesh.mesh import from_arrays

        self.cli, self.torch = cli, torch
        self.device = torch.device(device)
        a = config["annotator"]
        self.res, self.tile, self.K = a["resolution"], a["tile"], a["views_per_batch"]
        self.settings = Settings(RESOLUTION=self.res, RASTER_TILE=self.tile,
                                 RASTER_CHUNK=a["chunk"],
                                 VIEWS_PER_DISPATCH=self.K,
                                 MIN_CURVATURE_RADIUS=a["min_curvature_radius"])
        self.mods = tuple(traffic["modalities"])
        self.kw = cli.annotate_kwargs(self.settings, self.mods)
        self.prefixes = cli.device_prefixes((), self.mods, self.settings, self.device)
        self.seed = seed
        t = [time.perf_counter()]
        self.arrays = scene_arrays(config["scene"])
        v, f, c = self.arrays
        t.append(time.perf_counter())
        self.mesh = from_arrays(v, f, vertex_colors=c, device=self.device)
        t.append(time.perf_counter())
        self.curv = bake_curvature_colors(
            self.mesh, min_radius=self.settings.MIN_CURVATURE_RADIUS)
        t.append(time.perf_counter())
        self.setup_parts = {"scene_arrays_s": t[1] - t[0], "from_arrays_s": t[2] - t[1],
                            "bake_s": t[3] - t[2]}
        self.n_pool = int(traffic["pool_batches"])
        # one set of batches for every seed, which orders them: the seed moves
        # no work into or out of the pool, nor a view from one batch to another
        cams = gen_cameras.sample(self.n_pool * self.K, int(traffic["camera_seed"]))
        batch_order = np.random.RandomState(seed % 2**32).permutation(self.n_pool)
        order = (batch_order[:, None] * self.K + np.arange(self.K)).reshape(-1)
        self.cams = tuple(x[order] for x in cams)
        locs, Rs, fovs = (torch.as_tensor(x, device=self.device) for x in self.cams)
        K = self.K
        self.pool = [Camera(locs[b * K:(b + 1) * K], Rs[b * K:(b + 1) * K],
                            fovs[b * K:(b + 1) * K], self.res)
                     for b in range(self.n_pool)]
        rng = np.random.RandomState((seed + 1) % 2**32)
        self.sample_vi = rng.randint(0, K, self.n_pool)  # one kept view a batch
        self.kept: dict = {}
        self.malformed = 0

    # ---- the loop --------------------------------------------------------

    def _check_shape(self, arrs) -> bool:
        for m in self.mods:
            a = arrs.get(m)
            want = (self.K, self.res, self.res) + ((CHANNELS[m],) if m in CHANNELS else ())
            dt = np.uint16 if m in U16 else np.uint8
            if a is None or a.shape != want or a.dtype != dt:
                return False
        return True

    def run(self, seconds: float, tracer=None, window: bool = True) -> dict:
        """One closed loop over the pool for ``seconds`` -> the loop's record.
        window=False is the warm-up: nothing is kept for the comparison."""
        cli, K = self.cli, self.K
        pulls: list = []
        done: list = []  # (pulled, arrived) of each batch that came back whole
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def cams():
            seq = 0
            while time.perf_counter() < t_end:
                if tracer is not None:
                    tracer.tick(t0, seq % self.n_pool)
                pulls.append(time.perf_counter())
                yield self.pool[seq % self.n_pool]
                seq += 1

        completed: list = []
        launches0 = self._launches()
        try:
            batches = cli.render_batches(cams(), self.mesh, self.curv, self.kw,
                                         self.mods, self.settings, self.prefixes)
            for seq, (arrs, _maps) in enumerate(batches):
                t = time.perf_counter()
                if not self._check_shape(arrs):
                    self.malformed += 1
                    continue
                done.append((pulls[seq], t))
                if t <= t_end:
                    completed.append(seq % self.n_pool)
                if window and seq < self.n_pool and t <= t_end:
                    vi = int(self.sample_vi[seq])
                    self.kept[seq] = {m: np.array(arrs[m][vi]) for m in self.mods}
        finally:
            if tracer is not None:
                tracer.stop()
        n_pulled = len(pulls)
        launches = {k: (v - launches0[k]) / max(n_pulled, 1)
                    for k, v in self._launches().items()}
        in_window = [(p, a) for p, a in done if a <= t_end]
        return {
            "seconds": seconds,
            "views_done": K * len(in_window),
            "batch_latencies_s": [a - p for p, a in in_window],
            "completed_pool_idx": completed,
            "batches_pulled": n_pulled,
            "launches_per_batch": launches,
        }

    def _launches(self) -> dict:
        from omnidata_tpu_torch.mesh import raster_kernels as rk

        return {f"{fn.__name__}.{attr}": getattr(fn, attr, 0)
                for fn in (rk.raster_tiles_chunklist, rk.raster_tiles_streamed,
                           rk.raster_tiles_compact)
                for attr in ("launches", "count_launches") if hasattr(fn, attr)}

    def rows_past_stage_cap(self) -> dict:
        """Kernel C's last launch: rows staging more faces than its cap."""
        from omnidata_tpu_torch.mesh import raster_kernels as rk

        sched = getattr(rk.raster_tiles_streamed, "last_schedule", None)
        if sched is None or sched.staged is None:
            return {}
        staged = sched.staged
        return {"rows": int(staged.numel()),
                "rows_past_stage_cap": int((staged > rk.STREAMED_STAGE_CAP).sum()),
                "max_staged": int(staged.max())}

    # ---- traced run: stages and work --------------------------------------

    def stage_batches(self, n: int = 3):
        return self.pool[:n]

    def work(self, pool_idx) -> dict:
        """benchmark.work of each pool batch in pool_idx -> {idx: work}."""
        from .. import work

        torch = self.torch
        v, f, _ = self.arrays
        V = torch.as_tensor(v, device=self.device)
        Fc = torch.as_tensor(np.asarray(f, np.int64), device=self.device)
        cams = tuple(torch.as_tensor(x, device=self.device) for x in self.cams)
        return {b: work.batch_work(V, Fc, cams, range(b * self.K, (b + 1) * self.K),
                                   self.res, self.tile)
                for b in sorted(set(pool_idx))}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.mesh = self.curv = self.pool = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # ---- correctness --------------------------------------------------------

    def check(self, limits: dict, n_sample: int, control: str | None = None) -> dict:
        """Compare a seeded sample of the kept views with the reference ->
        [(name, value, limit, passed)]. control: a lower precision in which the
        reference takes the program's place."""
        import torch

        from ..reference.views import Reference

        cand = sorted(self.kept)
        rng = np.random.RandomState((self.seed + 2) % 2**32)
        sample = sorted(rng.choice(cand, min(n_sample, len(cand)), replace=False)) \
            if cand else []
        v, f, c = self.arrays
        ref = Reference(v, f, c, self.res, self.tile, self.device)
        locs, Rs, fovs = self.cams
        worst = {m: 0.0 for m in self.mods}
        for seq in sample:
            i = int(seq) * self.K + int(self.sample_vi[seq])
            r = ref.labels(locs[i], Rs[i], fovs[i])
            prog = self.kept[seq]
            if control:
                prog = ref.labels(locs[i], Rs[i], fovs[i], getattr(torch, control))
            for m in self.mods:
                d = np.abs(prog[m].astype(np.int64) - r[m].astype(np.int64))
                off = d > limits[f"{m}_off"]["tol"]
                if off.ndim == 3:
                    off = off.any(-1)
                worst[m] = max(worst[m], float(off.mean()))
        checks = [(f"{m}_off", worst[m], limits[f"{m}_off"]["limit"],
                   worst[m] <= limits[f"{m}_off"]["limit"]) for m in self.mods]
        checks.append(("malformed_batches", self.malformed, 0, self.malformed == 0))
        want = min(n_sample, max(len(cand), 1))
        checks.append(("views_compared", len(sample), want, len(sample) >= want))
        return checks
