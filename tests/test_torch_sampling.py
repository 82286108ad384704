"""The port's samplers (sampling/{poisson,points,sweep,trajectory}.py)
against the JAX package's, from the same numpy RandomState seeds: the
building and object camera samplers, generate_points with prune_points,
the SWEEP views and the smooth trajectory. Random draws follow the line of
sight and inside-mesh booleans, so those must decide alike.

Tolerance: the same structure (keys, lengths, order); integers, booleans
and strings equal; floats within 1e-5."""
import numpy as np
import pytest
import torch

from omnidata_tpu import sampling as js
from omnidata_tpu.mesh import cube, from_arrays, room
from omnidata_tpu.sampling import sweep as jsweep
from omnidata_tpu_torch import sampling as ts
from omnidata_tpu_torch.sampling import sweep as tsweep

from _torch_port_util import assert_same_tree, port_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    """(JAX, port) meshes: tests/test_sampling.py's 8 m room, and that room
    with a cube in it (blocked lines of sight)."""
    r = room(size=8.0, height=3.0)
    c = cube(size=1.5, center=(0.5, -0.5, 0.75))
    vs = np.concatenate([np.asarray(r.vertices), np.asarray(c.vertices)])
    fs = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                         np.asarray(c.faces[: c.num_faces]) + r.vertices.shape[0]])
    rc = from_arrays(vs, fs)
    return {"room": (r, port_mesh(r)), "room_cube": (rc, port_mesh(rc))}


@pytest.mark.parametrize("name, spacing, seed", [("room", 1.5, 1), ("room", 1.0, 5),
                                                 ("room_cube", 1.0, 11)])
def test_building_sampler_matches_jax(scenes, name, spacing, seed):
    jmesh, tmesh = scenes[name]
    want = js.sample_camera_locations_building(
        jmesh, np.random.RandomState(seed), min_spacing=spacing)
    got = ts.sample_camera_locations_building(
        tmesh, np.random.RandomState(seed), min_spacing=spacing)
    assert len(want) >= 4
    assert_same_tree(got, want)
    assert js.find_building_floors(np.asarray(jmesh.vertices)) == \
        ts.find_building_floors(tmesh.vertices.numpy())


def test_object_sampler_matches_jax(scenes):
    jmesh, tmesh = scenes["room"]
    assert_same_tree(ts.sample_camera_locations_object(tmesh, np.random.RandomState(2), 16),
                     js.sample_camera_locations_object(jmesh, np.random.RandomState(2), 16))
    assert_same_tree(ts.sample_camera_yaw_roll(np.random.RandomState(3), 8),
                     js.sample_camera_yaw_roll(np.random.RandomState(3), 8))


@pytest.mark.parametrize("name", ["room", "room_cube"])
def test_generate_and_prune_points_match_jax(scenes, name):
    jmesh, tmesh = scenes[name]
    cams = js.sample_camera_locations_building(jmesh, np.random.RandomState(5),
                                               min_spacing=2.0)
    kw = dict(n_points=6, min_views_per_point=2, resolution=64)
    want = js.generate_points(jmesh, cams, np.random.RandomState(8), **kw)
    got = ts.generate_points(tmesh, cams, np.random.RandomState(8), **kw)
    assert sum(len(v) for v in want) >= 6
    assert_same_tree(got, want)
    assert_same_tree(ts.prune_points(got, 1, 1), js.prune_points(want, 1, 1))
    pts = np.asarray([v[0]["point_location"] for v in want], np.float32)
    los_j = js.line_of_sight_matrix(cams, pts, jmesh)
    np.testing.assert_array_equal(ts.line_of_sight_matrix(cams, pts, tmesh), los_j)
    if name == "room_cube":
        assert not los_j.all()  # the cube blocks some views


@pytest.mark.parametrize("panos", [True, False])
def test_sweep_views_match_jax(panos):
    poses = {"0000": {"position": (1.0, 2.0, 1.5), "rotation": (np.pi / 2, 0.0, 0.3)},
             "0001": {"position": (-1.0, 0.5, 1.2), "rotation": (np.pi / 2, 0.0, -2.0)}}
    kw = dict(num_points=4, resolution=64, panos=panos)
    want = jsweep.generate_points_per_camera(poses, rng=np.random.RandomState(0), **kw)
    got = tsweep.generate_points_per_camera(poses, rng=np.random.RandomState(0), **kw)
    assert_same_tree(got, want)
    R = np.eye(3)
    for d in ([0, 1, 0], [0, 0, -1], [1, 0, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0]):
        assert tsweep.skybox_face_of_direction(d, R) == \
            jsweep.skybox_face_of_direction(d, R)


@pytest.mark.parametrize("with_rotations", [False, True])
def test_trajectory_matches_jax(with_rotations):
    cams = np.array([[3.0, 0, 1.5], [0.0, 3, 1.5], [-3.0, 0, 1.5], [0.5, -2, 1.0]],
                    np.float32)
    point = np.array([0.0, 0, 1.0], np.float32)
    key_Rs = None
    if with_rotations:  # keyframes with roll: the slerp carries it
        from omnidata_tpu.core.rotations import euler_xyz_to_matrix
        import jax.numpy as jnp

        e = np.random.RandomState(4).uniform(-1, 1, (4, 3)).astype(np.float32)
        key_Rs = np.asarray(euler_xyz_to_matrix(jnp.asarray(e)))
    want = js.interpolate_trajectory(cams, point, key_Rs, steps_per_meter=4.0)
    got = ts.interpolate_trajectory(cams, point, key_Rs, steps_per_meter=4.0)
    for g, w in zip(got, want):
        assert_same_tree(g, w)
    assert ts.frame_uuid(7) == js.frame_uuid(7) == "0007"
