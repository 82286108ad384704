"""The whole slice: omnidata_tpu_torch.annotator.annotate_views against the
JAX annotate_views (Pallas raster kernel in interpret mode) on the same
mesh and cameras. Tolerance: every modality meets the integer-label rule of
tests/test_mesh.py (max diff <= 1 on < 2% of pixels, or <= 32 on < 0.1%),
with equal shapes and dtypes."""
import numpy as np
import torch

from omnidata_tpu.annotator import annotate_views as j_annotate_views
from omnidata_tpu.cues.curvature import bake_curvature_colors
from omnidata_tpu.mesh import cube, from_arrays, room
from omnidata_tpu_torch.annotator import DEVICE_MODALITIES, annotate_views

from _torch_port_util import both_cameras, int_label_ok, look_at_np, port_mesh

torch.set_num_threads(1)

RES = 64


def _cameras():
    locs = np.array([[1.0, 0.5, 1.2], [-0.8, 1.1, 1.6]], np.float32)
    tgts = np.array([[0.0, 0.0, 0.5], [0.5, -0.5, 0.8]], np.float32)
    return both_cameras(locs, look_at_np(locs, tgts),
                        np.array([1.0, 1.2], np.float32), RES)


def _compare(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape,
                                                           g.dtype, w.dtype)
        ok, dmax, frac = int_label_ok(g, w)
        assert ok, (k, dmax, frac)


def test_annotate_views_matches_jax():
    """room(4.0, 2.5) with seeded vertex colours and baked curvature; K=2,
    64², tile 32, chunk 64; the mesh carried across with interop."""
    base = room(size=4.0, height=2.5)
    rng = np.random.RandomState(0)
    colors = rng.rand(base.vertices.shape[0], 3).astype(np.float32) * 0.6 + 0.2
    jmesh = from_arrays(np.asarray(base.vertices),
                        np.asarray(base.faces[: base.num_faces]),
                        vertex_colors=colors)
    jcurv = bake_curvature_colors(jmesh, rings=1)
    jcam, tcam = _cameras()
    kw = dict(tile=32, chunk=64)
    want = j_annotate_views(jcam, jmesh, jcurv, interpret=True, **kw)
    got = annotate_views(tcam, port_mesh(jmesh), port_mesh(jcurv), **kw)
    assert len(got) == len(DEVICE_MODALITIES) - 1  # no face labels: no semantic
    assert got["mask_valid"].numpy().mean() > 200  # inside a closed room
    _compare(got, want)


def test_annotate_views_face_colours_and_semantic_match_jax():
    """Per-face material colours (the rgb/edge/keypoint cues without vertex
    colours) and the semantic label modality."""
    r = room(size=4.0, height=2.5)
    c = cube(size=0.8, center=(0.0, 0.0, 0.6))
    vs = np.concatenate([np.asarray(r.vertices), np.asarray(c.vertices)])
    fs = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                         np.asarray(c.faces[: c.num_faces]) + r.vertices.shape[0]])
    rng = np.random.RandomState(1)
    jmesh = from_arrays(vs, fs, face_labels=rng.randint(1, 40, len(fs)),
                        face_colors=rng.rand(len(fs), 3))
    jcam, tcam = _cameras()
    kw = dict(tile=32, chunk=64)
    want = j_annotate_views(jcam, jmesh, None, interpret=True, **kw)
    got = annotate_views(tcam, port_mesh(jmesh), None, **kw)
    assert "semantic" in got and "principal_curvature" not in got
    assert len(np.unique(got["semantic"].numpy())) > 2
    _compare(got, want)
