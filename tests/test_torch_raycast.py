"""omnidata_tpu_torch.mesh.raycast against omnidata_tpu.mesh.raycast on the
same rays and meshes: the inputs of tests/test_mesh.py's raycast, cube,
parity and line-of-sight tests, and 4,096 rays of a bench-scene camera
(39,760 faces).

Tolerance: `valid` equal; `face` equal on >= 99.9% of rays; `t` within
rtol 1e-5 where the faces match; `any_hit_within` and `count_crossings`
equal. Port only: the raycast against the port's kernel-A plain version on
the bench scene, with the bar of tests/test_torch_raycast_check.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.mesh import cube, quad_plane, room
from omnidata_tpu.mesh.mesh import TriangleMesh as JaxMesh
from omnidata_tpu.mesh.raycast import any_hit_within as j_any_hit
from omnidata_tpu.mesh.raycast import count_crossings as j_count
from omnidata_tpu.mesh.raycast import raycast as j_raycast
from omnidata_tpu_torch import scenes
from omnidata_tpu_torch.core import cameras as tcams
from omnidata_tpu_torch.mesh import raster as traster
from omnidata_tpu_torch.mesh.raycast import any_hit_within, count_crossings, raycast

from _torch_port_util import MESH_FIELDS, both_cameras, look_at_np, port_mesh

torch.set_num_threads(1)

RES = 64


def _camera_rays(loc, target, fov, res=RES):
    """(origins (N,3), dirs (N,3)) numpy rays of one look-at camera."""
    locs = np.asarray([loc], np.float32)
    _, tcam = both_cameras(locs, look_at_np(locs, np.asarray([target], np.float32)),
                           np.asarray([fov], np.float32), res)
    o, d = tcams.camera_rays(tcam)
    d = d.reshape(-1, 3).numpy()
    return np.repeat(o.numpy(), len(d), 0), d


def _compare_hits(jmesh, tmesh, origins, dirs, chunk=None):
    want = j_raycast(jnp.asarray(origins), jnp.asarray(dirs), jmesh)
    got = raycast(torch.as_tensor(origins), torch.as_tensor(dirs), tmesh,
                  chunk=chunk)
    jv, jf, jt = (np.asarray(a) for a in (want.valid, want.face, want.t))
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    tf = got.face.numpy()
    assert (tf == jf).mean() >= 0.999, (tf != jf).sum()
    same = (tf == jf) & jv
    np.testing.assert_allclose(got.t.numpy()[same], jt[same], rtol=1e-5)
    np.testing.assert_allclose(got.bary.numpy()[same], np.asarray(want.bary)[same],
                               atol=1e-5)
    return got


def test_plane_distance_matches_jax():
    jmesh = quad_plane(size=100.0, z=0.0)
    o, d = _camera_rays([0, 0, 2.0], [0, 0, 0.0], 1.0)
    got = _compare_hits(jmesh, port_mesh(jmesh), o, d)
    assert bool(got.valid.all())
    np.testing.assert_allclose(got.t.numpy() * -d[:, 2], 2.0, atol=1e-4)


@pytest.mark.parametrize("chunk", [None, 4])  # one chunk; several chunks
def test_cube_matches_jax(chunk):
    jmesh = cube(size=1.0)
    o, d = _camera_rays([2.0, 1.5, 1.2], [0, 0, 0], 1.0)
    got = _compare_hits(jmesh, port_mesh(jmesh), o, d, chunk=chunk)
    assert 0 < got.valid.float().mean() < 1


def test_inside_outside_parity_matches_jax():
    jmesh = room(size=8.0, height=3.0)
    pts = np.asarray([[0.0, 0, 1.5], [10.0, 0, 1.5], [3.9, 3.9, 2.9], [0, 0, 5.0]],
                     np.float32)
    d = np.broadcast_to(np.asarray([0.31, 0.52, 0.80], np.float32), (4, 3)).copy()
    want = np.asarray(j_count(jnp.asarray(pts), jnp.asarray(d), jmesh))
    got = count_crossings(torch.as_tensor(pts), torch.as_tensor(d), port_mesh(jmesh))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy() % 2 == 1, [True, False, True, False])


def test_line_of_sight_matches_jax():
    jmesh = cube(size=1.0, center=(0.0, 0.0, 0.0))
    o = np.asarray([[0.0, -3.0, 0.0], [0.0, -3.0, 3.0]], np.float32)
    tgt = np.asarray([[0.0, 3.0, 0.0], [0.0, 3.0, 3.0]], np.float32)
    d = tgt - o
    dist = np.linalg.norm(d, axis=-1)
    args = (o, d / dist[:, None], dist - 1e-3)
    want = np.asarray(j_any_hit(*(jnp.asarray(a) for a in args), jmesh))
    got = any_hit_within(*(torch.as_tensor(a) for a in args), port_mesh(jmesh))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [True, False])


@pytest.fixture(scope="module")
def bench_scene():
    """The bench scene (port arrays, carried into a JAX mesh), the 4,096
    rays of view 0 of sample_cameras_np(1, seed=1) at 64², and both
    packages' hits (each raycast runs once per module)."""
    mesh, _ = scenes.build_scene()
    jmesh = JaxMesh(num_faces=mesh.num_faces, **{
        k: None if getattr(mesh, k) is None else jnp.asarray(getattr(mesh, k).numpy())
        for k in MESH_FIELDS})
    cam = scenes.camera_batch(scenes.sample_cameras_np(1, seed=1), [0], RES)
    o, d = tcams.camera_rays(cam)
    d = d.reshape(-1, 3).numpy()
    o = np.repeat(o.numpy(), len(d), 0)
    want = j_raycast(jnp.asarray(o), jnp.asarray(d), jmesh)
    # one shared origin row, as the panorama renderer passes it
    got = raycast(torch.as_tensor(o[:1]), torch.as_tensor(d), mesh)
    return mesh, jmesh, cam, o, d, want, got


def test_bench_scene_rays_match_jax(bench_scene):
    _, _, _, o, d, want, got = bench_scene
    assert len(d) == 4096
    jv, jf, jt = (np.asarray(a) for a in (want.valid, want.face, want.t))
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    assert jv.mean() > 0.99  # inside a closed room
    tf = got.face.numpy()
    assert (tf == jf).mean() >= 0.999, (tf != jf).sum()
    same = (tf == jf) & jv
    np.testing.assert_allclose(got.t.numpy()[same], jt[same], rtol=1e-5)


def test_bench_scene_occlusion_and_crossings_match_jax(bench_scene):
    """Every 8th ray: segments that end at half and at 1.5 times the ray's
    hit distance (blocked iff the hit is closer), and crossing counts."""
    mesh, jmesh, _, o, d, want, _ = bench_scene
    o, d, t = o[::8], d[::8], np.asarray(want.t)[::8]
    max_t = np.where(np.arange(len(t)) % 2 == 0, 0.5, 1.5) * np.minimum(t, 50.0)
    want_b = np.asarray(j_any_hit(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(max_t, jnp.float32), jmesh))
    got_b = any_hit_within(torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(max_t, dtype=torch.float32), mesh)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    assert 0 < want_b.mean() < 1
    want_c = np.asarray(j_count(jnp.asarray(o), jnp.asarray(d), jmesh))
    got_c = count_crossings(torch.as_tensor(o), torch.as_tensor(d), mesh)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert want_c.max() >= 2


def test_bench_scene_raycast_matches_plain_kernel_a(bench_scene):
    """The port's referee against the port's renderer: the same 64² view
    through render_views_fused (kernel A's plain version on the CPU), tile
    32 and chunk 128 as the bench. valid equal, faces equal on >= 99.9%,
    t within 1e-4 relative where the faces differ."""
    mesh, _, cam, _, _, _, hits = bench_scene
    frag = traster.render_views_fused(cam, mesh, tile=32, chunk=128)
    hv, hf, ht = (a.reshape(1, RES, RES).numpy()
                  for a in (hits.valid, hits.face, hits.t))
    fv, ff, ft = frag.valid.numpy(), frag.face.numpy(), frag.t.numpy()
    np.testing.assert_array_equal(fv, hv)
    assert (ff == hf).mean() >= 0.999, (ff != hf).sum()
    differ = (ff != hf) & fv
    np.testing.assert_allclose(ft[differ], ht[differ], rtol=1e-4)


def test_pano_matches_jax_and_any_block_split():
    """tests/test_mesh.py's room panorama (64x32, leveled camera): the port
    against JAX with blocks that divide the ray count, and the port's
    result independent of the block size. The JAX render_pano misplaces
    the tail block when the block does not divide width x height (its
    dynamic slice clamps the start): that reference fault, logged in
    ROADMAP.md, is pinned here too."""
    from omnidata_tpu.core.rotations import euler_xyz_to_matrix
    from omnidata_tpu.mesh.pano import render_pano as j_render_pano
    from omnidata_tpu_torch.mesh.pano import render_pano

    jmesh = room(size=8.0, height=3.0)
    R = euler_xyz_to_matrix(jnp.asarray([np.pi / 2, 0.0, 0.0]))
    loc = jnp.asarray([0.5, 0.2, 1.5])
    want = j_render_pano(loc, R, jmesh, width=64, height=32, block=512)
    args = (torch.as_tensor(np.asarray(loc)), torch.as_tensor(np.asarray(R)),
            port_mesh(jmesh), 64, 32)
    got = render_pano(*args, block=512)
    assert bool(got.valid.all())
    np.testing.assert_array_equal(got.face.numpy(), np.asarray(want.face))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    assert torch.equal(got.z, got.t)
    odd = render_pano(*args, block=1000)
    assert all(torch.equal(a, b) for a, b in zip(odd, got))
    j_odd = j_render_pano(loc, R, jmesh, width=64, height=32, block=1000)
    assert (np.asarray(j_odd.face) != np.asarray(want.face)).any()
