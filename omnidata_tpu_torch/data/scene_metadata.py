"""Scene metadata for multiview sampling — capability match for the
reference's modular dataloader (dataloader/scene_metadata.py:59-361 and the
multiview samplers in dataloader/omnidata_dataset.py:698-1090).

- BuildingMetadata: (point, view) -> camera index, camera locations deduped
  by tolerance; HDF5-persistable.
- BuildingMultiviewMetadata: (point, view) -> set of visible points, computed
  from point_info's nonfixated_points_in_view (the reference's point_info
  path; its alternative fragment-render path is served by our renderer's
  Fragments.face ids directly).
- CenterVisibleMultiviewSampler: positives = views whose visible-point sets
  reach the anchor's point within `hops` on the view graph, with BACKOFF
  through SAME/FIXATED/DIFFERENT and optional camera-KNN filtering.

The port's copy of ``omnidata_tpu.data.scene_metadata``; h5py is imported
on first use, and without it the HDF5 readers and writers raise an
ImportError that names it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .transforms import h5py_module


@dataclass
class BuildingMetadata:
    points: list  # point uuid per bpv row
    views: list  # view id per bpv row
    camera_idx: np.ndarray  # (N,) index into camera_locations
    camera_locations: np.ndarray  # (C,3) deduped

    @classmethod
    def from_point_info(cls, point_infos, atol: float = 1e-4):
        """Camera dedup is O(N) via quantized-location hashing (round to the
        atol grid); the previous all-pairs allclose loop was O(N*C) — a scale
        hazard at the reference's 14.6M-view datasets. Matching is ABSOLUTE
        (rtol=0): a relative tolerance would accept matches outside the
        probed +-1 grid cells for far-from-origin coordinates. Each camera's
        neighboring 26 cells are probed so near-boundary duplicates within
        atol still coalesce."""
        pts, views, cam_idx, cams = [], [], [], []
        cell_of: dict = {}  # quantized cell -> camera index

        def key(q, di, dj, dk):
            return (q[0] + di, q[1] + dj, q[2] + dk)

        for pviews in point_infos:
            for view in pviews:
                loc = np.asarray(view["camera_location"], np.float32)
                q = tuple(int(x) for x in np.round(loc / atol))
                found = None
                for di in (0, -1, 1):
                    for dj in (0, -1, 1):
                        for dk in (0, -1, 1):
                            i = cell_of.get(key(q, di, dj, dk))
                            if i is not None and np.allclose(
                                cams[i], loc, rtol=0.0, atol=atol
                            ):
                                found = i
                                break
                        if found is not None:
                            break
                    if found is not None:
                        break
                if found is None:
                    cams.append(loc)
                    found = len(cams) - 1
                    cell_of[key(q, 0, 0, 0)] = found
                pts.append(str(view["point_uuid"]))
                views.append(int(view["view_id"]))
                cam_idx.append(found)
        return cls(pts, views, np.asarray(cam_idx),
                   np.stack(cams) if cams else np.zeros((0, 3), np.float32))

    def save_hdf5(self, path: str):
        h5py = h5py_module("scene metadata HDF5 files")
        with h5py.File(path, "w") as f:
            f.create_dataset("points", data=np.asarray(self.points, "S"))
            f.create_dataset("views", data=np.asarray(self.views))
            f.create_dataset("camera_idx", data=self.camera_idx)
            f.create_dataset("camera_locations", data=self.camera_locations)

    @classmethod
    def load_hdf5(cls, path: str):
        h5py = h5py_module("scene metadata HDF5 files")
        with h5py.File(path, "r") as f:
            return cls(
                [s.decode() for s in f["points"][:]],
                [int(v) for v in f["views"][:]],
                f["camera_idx"][:],
                f["camera_locations"][:],
            )


@dataclass
class BuildingMultiviewMetadata:
    """(point, view) -> sorted array of visible point uuids."""

    visible: dict  # (point, view) -> list[str]

    @classmethod
    def from_point_info(cls, point_infos):
        vis = {}
        for pviews in point_infos:
            for view in pviews:
                key = (str(view["point_uuid"]), int(view["view_id"]))
                vis[key] = sorted(
                    str(j) for j in view.get("nonfixated_points_in_view", [])
                )
        return cls(vis)

    @classmethod
    def from_fragments(cls, frag_faces: dict, face_to_point: np.ndarray,
                       center_crop: float = 0.5):
        """Fragment-render path (scene_metadata.py compute_from_frags:298-358):
        frag_faces[(point, view)] = (H,W) face-id image; face_to_point maps
        face id -> point id (or -1). Visibility = points whose faces appear
        in the center crop of the view."""
        vis = {}
        for key, faces in frag_faces.items():
            H, W = faces.shape
            h0, h1 = int(H * (0.5 - center_crop / 2)), int(H * (0.5 + center_crop / 2))
            w0, w1 = int(W * (0.5 - center_crop / 2)), int(W * (0.5 + center_crop / 2))
            ids = np.unique(faces[h0:h1, w0:w1])
            ids = ids[ids >= 0]
            pts = np.unique(face_to_point[ids])
            vis[key] = sorted(str(p) for p in pts[pts >= 0])
        return cls(vis)

    def save_hdf5(self, path: str):
        h5py = h5py_module("scene metadata HDF5 files")
        with h5py.File(path, "w") as f:
            for (p, v), pts in self.visible.items():
                f.create_dataset(f"{p}/{v}", data=np.asarray(pts, "S"))

    @classmethod
    def load_hdf5(cls, path: str):
        h5py = h5py_module("scene metadata HDF5 files")
        vis = {}
        with h5py.File(path, "r") as f:
            for p in f:
                for v in f[p]:
                    vis[(p, int(v))] = [s.decode() for s in f[p][v][:]]
        return cls(vis)


BACKOFF_ORDER = ("SAME", "FIXATED", "DIFFERENT")


class OverlapMultiviewSampler:
    """Positives ranked by pairwise pixel overlap (the reference's
    OverlapMultiviewSampler, dataloader/omnidata_dataset.py:746-833, which
    reads precomputed overlap CSVs from mesh-fragment renders).

    Overlap here comes straight from fragment face-id images (the renderer's
    Fragments.face): overlap(a, b) = |faces(a) ∩ faces(b)| / |faces(a)|."""

    def __init__(self, frag_faces: dict, min_overlap_prop: float = 0.1,
                 max_views: int = 32):
        self.keys = sorted(frag_faces)
        sets = {k: set(np.unique(v[v >= 0]).tolist()) for k, v in frag_faces.items()}
        self.overlap = {}
        for a in self.keys:
            rows = []
            fa = sets[a]
            if not fa:
                continue
            for b in self.keys:
                if b == a:
                    continue
                prop = len(fa & sets[b]) / len(fa)
                if prop >= min_overlap_prop:
                    rows.append((prop, b))
            rows.sort(reverse=True)
            self.overlap[a] = [b for _, b in rows[:max_views]]

    def positives(self, point, view, n: int,
                  rng: np.random.RandomState | None = None) -> list:
        anchor = (str(point), int(view))
        cands = list(self.overlap.get(anchor, []))
        out = cands[:n]
        while len(out) < n:  # SAME backoff
            out.append(anchor)
        return out[:n]


class CenterVisibleMultiviewSampler:
    """Positives for an anchor (point, view): other views that see the
    anchor's point (1 hop), or points visible from those views (more hops);
    BACKOFF: SAME view -> FIXATED (other views of the same point) ->
    DIFFERENT (any view). Optional camera-KNN restricts candidates to the
    k nearest cameras (dataloader/omnidata_dataset.py:838-1090)."""

    def __init__(self, building: BuildingMetadata, mv: BuildingMultiviewMetadata,
                 knn_cameras: int | None = None):
        self.b = building
        self.mv = mv
        self.knn = knn_cameras
        # index: point -> [(point, view) rows that see it]
        self.seen_by: dict = {}
        for (p, v), pts in mv.visible.items():
            for q in pts:
                self.seen_by.setdefault(q, []).append((p, v))
        self.rows = list(zip(building.points, building.views))
        self.row_index = {pv: i for i, pv in enumerate(self.rows)}

    def _knn_thresh(self, anchor) -> tuple:
        """(anchor_loc, kth-nearest distance) — computed once per anchor
        (positives() may test hundreds of candidates against it)."""
        ai = self.row_index.get(anchor)
        if ai is None:
            return None, None
        locs = self.b.camera_locations
        a_loc = locs[self.b.camera_idx[ai]]
        d_all = np.linalg.norm(locs - a_loc, axis=1)
        k = min(self.knn, len(d_all) - 1)
        return a_loc, float(np.partition(d_all, k)[k])

    def _knn_ok(self, anchor_loc, thresh, cand) -> bool:
        if self.knn is None or thresh is None:
            return True
        ci = self.row_index.get(cand)
        if ci is None:
            return True
        locs = self.b.camera_locations
        return float(np.linalg.norm(locs[self.b.camera_idx[ci]] - anchor_loc)) <= thresh

    def positives(self, point: str, view: int, n: int, hops: int = 1,
                  rng: np.random.RandomState | None = None) -> list:
        rng = rng or np.random.RandomState(0)
        anchor = (str(point), int(view))
        a_loc, thresh = (self._knn_thresh(anchor) if self.knn is not None
                         else (None, None))
        frontier = {str(point)}
        cands: list = []
        seen = {anchor}
        for _ in range(max(hops, 1)):
            nxt = set()
            for q in frontier:
                for pv in self.seen_by.get(q, []):
                    if pv not in seen and self._knn_ok(a_loc, thresh, pv):
                        cands.append(pv)
                        seen.add(pv)
                        nxt.update(self.mv.visible.get(pv, []))
            frontier = nxt
        rng.shuffle(cands)
        out = cands[:n]
        # BACKOFF: FIXATED (same point, other views), then DIFFERENT, then SAME
        if len(out) < n:
            fixated = [pv for pv in self.rows
                       if pv[0] == str(point) and pv != anchor and pv not in out]
            rng.shuffle(fixated)
            out += fixated[: n - len(out)]
        if len(out) < n:
            others = [pv for pv in self.rows if pv not in out and pv != anchor]
            rng.shuffle(others)
            out += others[: n - len(out)]
        while len(out) < n:
            out.append(anchor)  # SAME
        return out[:n]
