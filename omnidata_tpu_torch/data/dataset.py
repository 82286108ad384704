"""Filesystem dataset over annotator outputs — the bpv-index design of the
reference's loaders (data/omnidata_dataset.py:86-637 and the newer
dataloader/omnidata_dataset.py:59-665), host-side (yields numpy batches for
the trainers to move to the device); the port's copy of the JAX package's
``data/dataset.py`` on the port's PIL-free transforms and mesh loaders.

Layout: <root>/<building>/<task>/point_{p}_view_{v}_domain_{task}.png
(a single-building root without the extra level also works).

Key behaviors kept from the reference:
- index = (building, point, view) tuples kept only when ALL requested tasks
  exist (omnidata_dataset.py:270-342), with a pickle cache (:136-207)
- per-task resize (bilinear rgb / nearest else) + square crop with JOINT
  offsets across the sample's tasks: random for random_crop components
  (hypersim/BlendedMVS), center otherwise (data/omnidata_dataset.py:394-408)
- optional joint horizontal flip that also flips the normal X channel
  (res[0] = 1 - res[0], :411-414)
- split filtering: when split_csv is set, buildings are restricted to the
  requested split's spaces (starter_dataset splits.py CSVs)
- multiview: FILENAME sampler — positives are other views of the same
  (building, point) (dataloader/omnidata_dataset.py:698-743)
- point_info JSONs load with camera pose fields; R/T/K(+inv) tensors in
  PyTorch3D convention are attached per view (dataloader/omnidata_dataset.py:565-594)
"""
from __future__ import annotations

import os
import pickle
import re
from dataclasses import dataclass, field

import numpy as np

from .pose import cam_to_world_R_T_K
from .transforms import default_loader, get_transform

_FN = re.compile(r"point_(\w+)_view_(\w+)_domain_(\w+)\.(\w+)$")

_POSE_KEYS = ("cam_to_world_R", "cam_to_world_T", "proj_K", "proj_K_inv")


@dataclass
class Options:
    data_path: str = ""
    tasks: tuple = ("rgb", "normal")
    image_size: int | None = None
    split: str = "train"
    split_csv: str | None = None  # train_val_test_*.csv restricting buildings
    num_positive: int = 1  # views per sample (multiview if > 1)
    random_flip: bool = True
    random_crop: bool = False
    cache_dir: str | None = None
    seed: int = 0


class OmnidataDataset:
    def __init__(self, options: Options):
        self.o = options
        self.transforms = {
            t: get_transform(t, options.image_size) for t in options.tasks
        }
        self.index = self._build_index()
        # component subclasses install per-task hooks fn(arr, building, point,
        # view) -> arr, applied right after the task transform and BEFORE the
        # joint crop/flip (e.g. hypersim world->cam normals, NYU40 remap)
        self.post_transform_hooks: dict = {}
        # O(1) multiview lookup: (building, point) -> index positions
        self._bp_map: dict = {}
        for i, (b, p, _, _) in enumerate(self.index):
            self._bp_map.setdefault((b, p), []).append(i)
        self.rng = np.random.RandomState(options.seed)

    # ---- index ------------------------------------------------------------
    def _buildings(self):
        root = self.o.data_path
        subs = [
            d for d in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, d))
        ]
        if any(t in subs for t in self.o.tasks):
            return [("", root)]  # single-building layout
        out = [(d, os.path.join(root, d)) for d in subs]
        if self.o.split_csv:
            from .splits import get_splits

            allowed = get_splits(self.o.split_csv).get(self.o.split, set())
            out = [(d, p) for d, p in out if d in allowed]
        return out

    def _build_index(self):
        cache = None
        if self.o.cache_dir:
            os.makedirs(self.o.cache_dir, exist_ok=True)
            cache = os.path.join(self.o.cache_dir, self._cache_key())
            if os.path.exists(cache):
                with open(cache, "rb") as fh:
                    return pickle.load(fh)

        index = []  # (building, point, view) with paths per task
        for bname, bpath in self._buildings():
            per_task: dict = {}
            for task in self.o.tasks:
                tdir = os.path.join(bpath, task)
                if not os.path.isdir(tdir):
                    per_task = {}
                    break
                for fn in os.listdir(tdir):
                    m = _FN.match(fn)
                    if not m or m.group(3) != ("fixatedpose" if task == "point_info" else task):
                        continue
                    per_task.setdefault((m.group(1), m.group(2)), {})[task] = (
                        os.path.join(tdir, fn)
                    )
            for (p, v), paths in sorted(per_task.items()):
                if len(paths) == len(self.o.tasks):  # complete bpv only
                    index.append((bname, p, v, paths))

        if cache:
            with open(cache, "wb") as fh:
                pickle.dump(index, fh)
        return index

    def _cache_key(self) -> str:
        """Stable across processes — Python's str hash is salted per
        interpreter (the reference's FileDirCache keys on a repr for the
        same reason, dataloader/omnidata_dataset.py:174-178)."""
        import hashlib

        spec = repr((
            os.path.abspath(self.o.data_path), tuple(self.o.tasks),
            self.o.split, self.o.split_csv,
        ))
        return hashlib.md5(spec.encode()).hexdigest() + ".pkl"

    # ---- sampling ---------------------------------------------------------
    def __len__(self):
        return len(self.index)

    def _views_of_point(self, building: str, point: str):
        return self._bp_map.get((building, point), [])

    @staticmethod
    def _crop(arr: np.ndarray, top: int, left: int, size: int) -> np.ndarray:
        if arr.ndim == 3:  # CHW
            return arr[:, top : top + size, left : left + size]
        return arr[top : top + size, left : left + size]  # HW labels

    def _raw_task(self, entry, task):
        """Decoded + transformed + hooked array for one task of one entry —
        deterministic per (entry, task); augmentation (joint crop/flip)
        happens in _load_one. PackedDataset overrides this with a memmap
        read (data/packed_cache.py)."""
        building, point, view, paths = entry
        data = default_loader(paths[task])
        tr = self.transforms[task]
        arr = tr(data) if tr is not None else data
        hook = self.post_transform_hooks.get(task)
        if hook is not None:
            arr = hook(arr, building, point, view)
        return arr

    def _load_one(self, entry, rng=None):
        rng = self.rng if rng is None else rng
        building, point, view, paths = entry
        out = {"building": building, "point": point, "view": view}
        flip = self.o.random_flip and rng.rand() < 0.5
        size = self.o.image_size
        top = left = None  # joint crop offsets, sampled from the first task
        for task in self.o.tasks:
            arr = self._raw_task(entry, task)
            if isinstance(arr, np.ndarray) and size and arr.ndim in (2, 3):
                h, w = arr.shape[-2], arr.shape[-1]
                if h != size or w != size:  # non-square source: crop square
                    if top is None:
                        if self.o.random_crop:
                            top = int(rng.randint(0, h - size + 1))
                            left = int(rng.randint(0, w - size + 1))
                        else:  # torchvision CenterCrop offsets
                            top = int(round((h - size) / 2.0))
                            left = int(round((w - size) / 2.0))
                    arr = self._crop(arr, top, left, size)
            if isinstance(arr, np.ndarray) and flip and arr.ndim in (2, 3):
                arr = arr[..., ::-1].copy()  # mirrors CHW images AND 2D labels
                if task == "normal":
                    arr[0] = 1.0 - arr[0]  # X flips under mirror
            out[task] = arr
            if task == "point_info" and isinstance(arr, dict):
                out.update(cam_to_world_R_T_K(arr))
        return out

    def __getitem__(self, i: int):
        return self._get(int(i), self.rng)

    def item(self, i: int, seed: int):
        """Thread-safe deterministic access: all augmentation/multiview
        draws come from a private RandomState(seed). The prefetching
        loaders use this so decode-thread completion order cannot change
        which sample gets which flip/crop."""
        return self._get(int(i), np.random.RandomState(int(seed) & 0x7FFFFFFF))

    def _get(self, i: int, rng):
        entry = self.index[i]
        if self.o.num_positive <= 1:
            return self._load_one(entry, rng)
        # FILENAME multiview: other views of the same (building, point)
        building, point, _, _ = entry
        candidates = self._views_of_point(building, point)
        picks = [i]
        others = [c for c in candidates if c != i]
        rng.shuffle(others)
        picks += others[: self.o.num_positive - 1]
        while len(picks) < self.o.num_positive:  # backoff: repeat (SAME)
            picks.append(picks[-1])
        samples = [self._load_one(self.index[j], rng) for j in picks]
        out = {"building": building, "point": point}
        keys = list(self.o.tasks) + [k for k in _POSE_KEYS if k in samples[0]]
        for task in keys:
            vals = [s[task] for s in samples]
            out[task] = (
                np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
            )
        return out

    def load_building_mesh(self, building: str, max_edge: float = 0.0):
        """The scan mesh for a building (pose-aware multiview training /
        fragment re-rendering) — the reference's load_building_meshes with
        an LRU cache (dataloader/omnidata_dataset.py:60-97). Looks for
        mesh.ply / mesh.obj under the building dir (hypersim-style
        subclasses override _mesh_path). max_edge > 0 splits long edges
        (see mesh.subdivide_mesh)."""
        key = (building, max_edge)
        cache = getattr(self, "_mesh_cache", None)
        if cache is None:
            cache = self._mesh_cache = {}
        if key in cache:
            return cache[key]
        from ..mesh.mesh import load_obj, load_ply, subdivide_mesh

        path = self._mesh_path(building)
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"no mesh for building {building!r}")
        mesh = load_ply(path) if path.endswith(".ply") else load_obj(path)
        if max_edge:
            mesh = subdivide_mesh(mesh, max_edge)
        if len(cache) >= 4:  # small LRU: scan meshes are hundreds of MB
            cache.pop(next(iter(cache)))
        cache[key] = mesh
        return mesh

    def _mesh_path(self, building: str) -> str | None:
        base = os.path.join(self.o.data_path, building) if building else self.o.data_path
        for name in ("mesh.ply", "mesh.obj", "mesh_semantic.ply"):
            p = os.path.join(base, name)
            if os.path.exists(p):
                return p
        return None

    def subset(self, keep) -> "OmnidataDataset":
        """Shallow copy restricted to the given index positions."""
        import copy

        ds = copy.copy(self)
        ds.index = [self.index[i] for i in keep]
        ds._bp_map = {}
        for i, (b, p, _, _) in enumerate(ds.index):
            ds._bp_map.setdefault((b, p), []).append(i)
        ds.rng = np.random.RandomState(self.o.seed)
        return ds

    def filter_buildings(self, allowed) -> "OmnidataDataset":
        """Restrict to buildings in `allowed` — the training-side subset
        ladder (reference config/depth.yml taskonomy_variant: fullplus)."""
        allowed = set(allowed)
        keep = [i for i, (b, _, _, _) in enumerate(self.index) if b in allowed]
        return self.subset(keep)

    def buildings(self) -> list:
        return sorted({b for b, _, _, _ in self.index})

    def holdout(self, fraction: float = 0.05):
        """(train, val) split by whole (building, point) groups — views of a
        point never straddle the split (the reference separates val by
        building CSVs; this is the CSV-less equivalent for self-annotated
        data). Deterministic in the group order."""
        groups = sorted(self._bp_map)
        stride = max(2, int(round(1.0 / max(fraction, 1e-6))))
        val_groups = set(groups[::stride][: max(1, int(len(groups) * fraction) or 1)])
        tr, va = [], []
        for i, (b, p, _, _) in enumerate(self.index):
            (va if (b, p) in val_groups else tr).append(i)
        return self.subset(tr), self.subset(va)

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True):
        """Yield stacked numpy batches (the host loader feeding the device).
        drop_last=False keeps the final partial batch (eval protocols must
        score every sample)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        stop = (len(order) - batch_size + 1) if drop_last else len(order)
        for s in range(0, stop, batch_size):
            items = [self[int(i)] for i in order[s : s + batch_size]]
            batch = {}
            for k in items[0]:
                v0 = items[0][k]
                if isinstance(v0, np.ndarray):
                    batch[k] = np.stack([it[k] for it in items])
                else:
                    batch[k] = [it[k] for it in items]
            yield batch


def component_weighted_indices(datasets: list, n: int, rng) -> list:
    """Equal-component sampling (train_normal.py:140-156 WeightedRandomSampler):
    draw n (dataset_idx, item_idx) pairs, each component equally likely."""
    out = []
    for _ in range(n):
        d = rng.randint(len(datasets))
        out.append((d, rng.randint(len(datasets[d]))))
    return out
