"""omnidata_tpu_torch.mesh.mesh, cues.curvature, interop and scenes against
the JAX package on the same numpy inputs. Tolerance: exact — the port
copies the numpy host code, so arrays, padding and face order are equal."""
import numpy as np
import pytest
import torch

import bench
from omnidata_tpu.cues.curvature import bake_curvature_colors as j_bake
from omnidata_tpu.mesh import mesh as jm
from omnidata_tpu_torch import scenes
from omnidata_tpu_torch.cues.curvature import bake_curvature_colors as t_bake
from omnidata_tpu_torch.mesh import mesh as tm

from _torch_port_util import MESH_FIELDS, port_mesh

torch.set_num_threads(1)


def _assert_same_mesh(tmesh, jmesh):
    assert tmesh.num_faces == jmesh.num_faces
    for k in MESH_FIELDS:
        j, t = getattr(jmesh, k), getattr(tmesh, k)
        assert (j is None) == (t is None), k
        if j is not None:
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=k)
            assert t.numpy().dtype == np.asarray(j).dtype, k


@pytest.mark.parametrize("prim, kw", [
    ("room", dict(size=4.0, height=2.5)),
    ("cube", dict(size=0.7, center=(0.1, -0.2, 0.3))),
    ("uv_sphere", dict(radius=0.6, center=(0.5, 0.0, 1.0), n_lat=12, n_lon=24)),
])
def test_primitives_equal_jax(prim, kw):
    _assert_same_mesh(getattr(tm, prim)(**kw), getattr(jm, prim)(**kw))


def test_from_arrays_equal_jax():
    """Random soup with colours, labels and per-face colours: same Morton
    order, padding and normals."""
    rng = np.random.RandomState(3)
    v = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    f = rng.randint(0, 200, (300, 3)).astype(np.int32)
    kw = dict(vertex_colors=rng.rand(200, 3), face_labels=rng.randint(0, 9, 300),
              face_colors=rng.rand(300, 3), pad_multiple=128)
    _assert_same_mesh(tm.from_arrays(v, f, **kw), jm.from_arrays(v, f, **kw))
    np.testing.assert_array_equal(tm._morton_order(v, f), jm._morton_order(v, f))


def test_split_long_edges_equal_jax():
    r = jm.room(size=6.0, height=3.0)
    v = np.asarray(r.vertices)
    f = np.asarray(r.faces[: r.num_faces])
    rng = np.random.RandomState(4)
    args = (v, f, 0.9, rng.rand(len(v), 3).astype(np.float32),
            rng.rand(len(v), 2).astype(np.float32), np.arange(len(f)),
            rng.rand(len(f), 3).astype(np.float32))
    got, want = tm.split_long_edges(*args), jm.split_long_edges(*args)
    assert len(got[1]) > 10 * len(f)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_curvature_bake_equal_jax():
    s = jm.uv_sphere(radius=0.5, n_lat=16, n_lon=32)
    want = j_bake(s, rings=2)
    got = t_bake(port_mesh(s), rings=2)
    np.testing.assert_array_equal(got.vertex_colors.numpy(),
                                  np.asarray(want.vertex_colors))
    assert got.vertex_colors.dtype == torch.float32


def test_interop_mesh_round_trip():
    rng = np.random.RandomState(5)
    j = jm.from_arrays(rng.rand(40, 3), rng.randint(0, 40, (60, 3)),
                       vertex_colors=rng.rand(40, 3),
                       face_labels=rng.randint(0, 4, 60))
    _assert_same_mesh(port_mesh(j), j)


def test_bench_scene_equal_jax():
    """scenes.build_scene is bench.py's scene (39,760 faces, 312 chunks of
    128): the same arrays, face order and curvature colours."""
    from omnidata_tpu.mesh import cube, room, uv_sphere

    rng = np.random.RandomState(0)
    parts = [room(size=10.0, height=3.2)]
    for _ in range(4):
        c = (rng.uniform(-3.5, 3.5), rng.uniform(-3.5, 3.5), rng.uniform(0.4, 1.2))
        parts.append(uv_sphere(radius=rng.uniform(0.25, 0.6), center=c,
                               n_lat=48, n_lon=96))
    for _ in range(5):
        c = (rng.uniform(-4.0, 4.0), rng.uniform(-4.0, 4.0), rng.uniform(0.3, 1.0))
        parts.append(cube(size=rng.uniform(0.4, 1.2), center=c))
    v, f, colors = bench._assemble(parts, rng, edge=0.8)
    jmesh = jm.from_arrays(v, f, vertex_colors=colors)
    jcurv = j_bake(jmesh, rings=1)

    mesh, curv = scenes.build_scene()
    assert mesh.num_faces == 39760 and mesh.faces.shape[0] == 39936
    assert mesh.vertices.shape[0] == 19900
    _assert_same_mesh(mesh, jmesh)
    np.testing.assert_array_equal(curv.vertex_colors.numpy(),
                                  np.asarray(jcurv.vertex_colors))

    locs, Rs, fovs = scenes.sample_cameras_np(6)
    for g, w in zip((locs, Rs, fovs), bench.sample_cameras_np(6)):
        np.testing.assert_array_equal(g, w)


def test_large_scene_equal_jax():
    """scenes.build_large_scene is bench.py's large scene (584,704 faces,
    4,570 chunks of 128): the same arrays, face order and curvature
    colours as bench.py's assembly with the JAX package."""
    from omnidata_tpu.mesh import cube, room, uv_sphere

    rng = np.random.RandomState(0)
    parts = [room(size=10.0, height=3.2)]
    for _ in range(8):
        c = (rng.uniform(-3.5, 3.5), rng.uniform(-3.5, 3.5), rng.uniform(0.4, 1.2))
        parts.append(uv_sphere(radius=rng.uniform(0.25, 0.6), center=c,
                               n_lat=96, n_lon=192))
    for _ in range(12):
        c = (rng.uniform(-4.0, 4.0), rng.uniform(-4.0, 4.0), rng.uniform(0.3, 1.0))
        parts.append(cube(size=rng.uniform(0.4, 1.2), center=c))
    v, f, colors = bench._assemble(parts, rng, edge=0.08)
    jmesh = jm.from_arrays(v, f, vertex_colors=colors)
    jcurv = j_bake(jmesh, rings=1)

    mesh, curv = scenes.build_large_scene()
    assert mesh.num_faces == 584704 and mesh.faces.shape[0] == 584960
    _assert_same_mesh(mesh, jmesh)
    np.testing.assert_array_equal(curv.vertex_colors.numpy(),
                                  np.asarray(jcurv.vertex_colors))
