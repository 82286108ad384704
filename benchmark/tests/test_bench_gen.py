"""The frozen generators give the port's scene and camera arrays."""
import numpy as np
import pytest

from benchmark.gen import cameras, scene
from omnidata_tpu_torch import scenes
from omnidata_tpu_torch.mesh.mesh import from_arrays

SMALL = dict(seed=0, spheres=4, boxes=5, sphere_lat=48, edge_m=0.8, room_m=10.0,
             room_height_m=3.2)


@pytest.mark.parametrize("seed", [0, 1])
def test_scene_equals_the_ports(seed):
    v, f, c = scene.build({**SMALL, "seed": seed})
    mesh = from_arrays(v, f, vertex_colors=c)
    ref, _ = scenes.build_scene(seed)
    assert np.array_equal(mesh.vertices.numpy(), ref.vertices.numpy())
    assert np.array_equal(mesh.faces.numpy(), ref.faces.numpy())
    assert np.array_equal(mesh.vertex_colors.numpy(), ref.vertex_colors.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_cameras_equal_the_ports(seed):
    for a, b in zip(cameras.sample(96, seed), scenes.sample_cameras_np(96, seed)):
        assert np.array_equal(a, b)
