"""Packed binary sample cache: decode once, train at memory bandwidth.

The reference feeds training from per-sample PNG/HDF5 files through a
16-worker DataLoader pool (omnidata_tools/torch/train_normal.py:140-156);
SURVEY.md §7.7 calls 1000 views/sec dataloading out as a hard part and
prescribes pre-indexed binary caches. This module materializes each
dataset's post-transform (pre-augmentation) arrays into one memory-mapped
``.npy`` per task, so a training sample becomes a few mmap row reads plus
the cheap joint crop/flip — no PNG inflate, no resize, no JSON parse.

    ds = OmnidataDataset(Options(...))
    pds = PackedDataset.build(ds, cache_dir)   # packs on first use, ~decode
    sample = pds[i]                            # == ds[i] bit for bit

The port's copy of ``omnidata_tpu.data.packed_cache`` over the port's
dataset and PIL-free decode. ``chip_smoke.py`` phase 19c times the loader's
samples/s packed against PNG on the card's host.

The pack is keyed on a digest of the dataset's resolved index (building/
point/view rows), task tuple and image size, so a re-filtered or re-split
dataset never aliases a stale pack. Tasks whose per-sample arrays differ
in shape (mixed-resolution components) or aren't ndarrays (point_info)
stay on the direct decode path; everything else is packed.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .dataset import OmnidataDataset

_MANIFEST = "manifest.json"


def pack_digest(ds: OmnidataDataset) -> str:
    """Stable identity of a dataset's resolved sample list — includes the
    installed post-transform hooks (by module+qualname) since those are
    baked into the packed arrays; the task transforms themselves are fully
    determined by (task, image_size), which are folded in directly."""
    hooks = sorted(
        (t, getattr(f, "__module__", ""), getattr(f, "__qualname__", repr(f)))
        for t, f in ds.post_transform_hooks.items()
    )
    spec = repr((
        os.path.abspath(ds.o.data_path),  # two roots with identical row
        # names (single-building layouts all have building '') must not
        # alias each other's packs in a shared cache dir
        [(b, p, v) for b, p, v, _ in ds.index],
        tuple(ds.o.tasks), ds.o.image_size, hooks,
    ))
    return hashlib.md5(spec.encode()).hexdigest()


def build_packed_cache(ds: OmnidataDataset, cache_dir: str,
                       num_workers: int = 8) -> str:
    """Materialize `ds`'s post-transform arrays under
    ``cache_dir/<digest>/``; returns that directory. Idempotent — an
    existing complete pack is reused. Decode fans out on a thread pool
    (PNG inflate releases the GIL) writing straight into the memmaps."""
    from concurrent.futures import ThreadPoolExecutor

    out = os.path.join(cache_dir, pack_digest(ds))
    manifest_path = os.path.join(out, _MANIFEST)
    if os.path.exists(manifest_path):
        return out
    os.makedirs(out, exist_ok=True)

    n = len(ds)
    assert n > 0, "cannot pack an empty dataset"
    probe = {t: ds._raw_task(ds.index[0], t) for t in ds.o.tasks}
    tasks: dict = {}
    mmaps: dict = {}
    for t, arr in probe.items():
        if isinstance(arr, np.ndarray) and arr.dtype != object:
            tasks[t] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
            mmaps[t] = np.lib.format.open_memmap(
                os.path.join(out, f"{t}.npy"), mode="w+",
                dtype=arr.dtype, shape=(n, *arr.shape),
            )
        else:
            tasks[t] = None  # non-array (point_info) or object: direct path

    dropped: set = set()

    def fill(i):
        for t, mm in mmaps.items():
            if t in dropped:
                continue
            arr = ds._raw_task(ds.index[i], t)
            if arr.shape != mm.shape[1:]:
                dropped.add(t)  # mixed shapes: demote to direct path
                continue
            mm[i] = arr

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        list(pool.map(fill, range(n)))

    for t in dropped:
        tasks[t] = None
        mmaps[t].flush()
        del mmaps[t]
        os.remove(os.path.join(out, f"{t}.npy"))
    for mm in mmaps.values():
        mm.flush()

    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"n": n, "tasks": tasks}, fh)
    os.replace(tmp, manifest_path)  # manifest commits the pack atomically
    return out


class PackedDataset(OmnidataDataset):
    """An OmnidataDataset whose per-task decode reads memmap rows.

    Augmentation (joint crop/flip, normal-X inversion), multiview
    sampling, hooks baked at pack time, and the pose keys all behave
    identically to the source dataset — ``pds[i] == ds[i]`` for equal rng
    states."""

    def __init__(self, source: OmnidataDataset, pack_dir: str):
        # carry the source's FULL state (component subclasses keep their
        # keyframe tables, intrinsics, class remaps, …) then override the
        # packed-path fields
        self.__dict__.update(source.__dict__)
        self.post_transform_hooks = {}  # baked into the pack
        self.rng = np.random.RandomState(source.o.seed)
        self._source = source
        self._pack_dir = pack_dir
        with open(os.path.join(pack_dir, _MANIFEST)) as fh:
            manifest = json.load(fh)
        if manifest["n"] != len(self.index):
            raise ValueError(
                f"pack at {pack_dir} holds {manifest['n']} samples but the "
                f"dataset resolves {len(self.index)} — rebuild the pack"
            )
        self._packed = {
            t: np.load(os.path.join(pack_dir, f"{t}.npy"), mmap_mode="r")
            for t, spec in manifest["tasks"].items() if spec is not None
        }
        self._row_of = {
            (b, p, v): i for i, (b, p, v, _) in enumerate(self.index)
        }

    @classmethod
    def build(cls, source: OmnidataDataset, cache_dir: str,
              num_workers: int = 8) -> "PackedDataset":
        pack_dir = build_packed_cache(source, cache_dir, num_workers)
        src_cls = type(source)
        if src_cls is OmnidataDataset:
            return cls(source, pack_dir)
        # component subclasses (HypersimDataset, …) override _load_one /
        # _mesh_path etc.; a dynamic mixin keeps those overrides while the
        # packed _raw_task (first in the MRO) serves the arrays
        mixed = type(f"Packed{src_cls.__name__}", (cls, src_cls), {})
        return mixed(source, pack_dir)

    def _raw_task(self, entry, task):
        mm = self._packed.get(task)
        if mm is None:  # unpacked task (point_info / mixed shapes)
            return self._source._raw_task(entry, task)
        return mm[self._row_of[entry[:3]]]
