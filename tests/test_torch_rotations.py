"""The port's rotation and camera helpers (core/rotations.py, the rest of
core/cameras.py) against the JAX package's on the same seeded float32
inputs. Tolerance: atol 1e-6 (float32 trig rounds differently across
frameworks by an ulp or two)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.core import cameras as jcams
from omnidata_tpu.core import rotations as jrot
from omnidata_tpu_torch.core import cameras as tcams
from omnidata_tpu_torch.core import rotations as trot

from _torch_port_util import look_at_np

torch.set_num_threads(1)

ATOL = 1e-6


def _eulers(n=16, seed=0):
    rng = np.random.RandomState(seed)
    e = rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)
    e[:, 1] *= 0.45  # keep clear of gimbal lock (|y| < ~81 deg)
    return e


def _rotations():
    """Random rotations plus half turns about x, y and z and the identity,
    so every branch of Shepperd's method (trace, m00, m11, m22 largest)
    is taken."""
    e = np.concatenate([_eulers(), np.array(
        [[3.1, 0.05, 0.02], [0.03, 1.5, 1.6], [0.02, 0.04, 3.1], [0, 0, 0]],
        np.float32)])
    return np.array(jrot.euler_xyz_to_matrix(jnp.asarray(e)))


def _both(fn_name, *args):
    want = np.asarray(getattr(jrot, fn_name)(*(jnp.asarray(a) for a in args)))
    got = getattr(trot, fn_name)(*(torch.as_tensor(np.array(a)) for a in args)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


@pytest.mark.parametrize("fn_name, make", [
    ("euler_xyz_to_matrix", lambda: (_eulers(),)),
    ("matrix_to_euler_xyz", lambda: (_rotations(),)),
    ("matrix_to_quat", lambda: (_rotations(),)),
    ("euler_xyz_to_quat", lambda: (_eulers(),)),
    ("quat_to_matrix", lambda: (np.random.RandomState(1).normal(
        size=(16, 4)).astype(np.float32),)),
    ("quat_to_euler_xyz", lambda: (np.asarray(jrot.euler_xyz_to_quat(
        jnp.asarray(_eulers(seed=2)))),)),
    ("quat_multiply", lambda: tuple(np.random.RandomState(3).normal(
        size=(2, 16, 4)).astype(np.float32))),
    ("quat_conjugate", lambda: (np.random.RandomState(4).normal(
        size=(16, 4)).astype(np.float32),)),
    ("quat_rotate", lambda: (np.asarray(jrot.euler_xyz_to_quat(jnp.asarray(
        _eulers(seed=5)))), np.random.RandomState(5).normal(
            size=(16, 3)).astype(np.float32))),
    ("rotate_euler", lambda: (_eulers(seed=6), _eulers(seed=7) * 0.3)),
])
def test_rotation_helper_matches_jax(fn_name, make):
    got, want = _both(fn_name, *make())
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_matrix_to_quat_covers_every_branch():
    R = _rotations()
    m = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0], R[:, 1, 1],
                  R[:, 2, 2]], -1)
    assert set(np.argmax(m, -1)) == {0, 1, 2, 3}
    q = trot.matrix_to_quat(torch.as_tensor(R)).numpy()
    assert (q[:, 0] >= 0).all()
    np.testing.assert_allclose(trot.quat_to_matrix(torch.as_tensor(q)).numpy(),
                               R, atol=1e-5)


def test_rotate_axis_x_matches_jax():
    e = _eulers(seed=8)
    want = np.asarray(jrot.rotate_axis_x(jnp.asarray(e), np.pi / 2))
    got = trot.rotate_axis_x(torch.as_tensor(e), np.pi / 2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0])
def test_slerp_matches_jax(t):
    q = np.array(jrot.euler_xyz_to_quat(jnp.asarray(_eulers(8, seed=9))))
    q0, q1 = q[:4], q[4:]
    q1[0] = q0[0]  # one identical pair: the linear branch
    q1[1] = -q1[1]  # a negative dot product: the sign flip
    want = np.asarray(jrot.slerp(jnp.asarray(q0), jnp.asarray(q1),
                                 jnp.asarray(t, jnp.float32)))
    got = trot.slerp(torch.as_tensor(q0), torch.as_tensor(q1), t).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    per_row = np.linspace(0, 1, 4).astype(np.float32)  # one t per quaternion
    want = np.asarray(jrot.slerp(jnp.asarray(q0), jnp.asarray(q1),
                                 jnp.asarray(per_row)))
    got = trot.slerp(torch.as_tensor(q0), torch.as_tensor(q1),
                     torch.as_tensor(per_row)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_focal_fov_helpers_match_jax():
    f_mm = np.array([10.0, 24.0, 35.0, 50.0], np.float32)
    fov = np.asarray(jcams.fov_from_focal_mm(jnp.asarray(f_mm)))
    np.testing.assert_allclose(
        tcams.fov_from_focal_mm(torch.as_tensor(f_mm)).numpy(), fov, atol=ATOL)
    np.testing.assert_allclose(
        tcams.focal_mm_from_fov(torch.as_tensor(fov)).numpy(),
        np.asarray(jcams.focal_mm_from_fov(jnp.asarray(fov))), rtol=1e-6)


def test_project_matches_jax():
    rng = np.random.RandomState(10)
    locs = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    Rs = look_at_np(locs, rng.uniform(-3, 3, (3, 3)).astype(np.float32))
    fov = rng.uniform(0.6, 1.5, 3).astype(np.float32)
    pts = rng.uniform(-3, 3, (3, 7, 3)).astype(np.float32)
    K = np.asarray(jcams.intrinsic_matrix(jnp.asarray(fov), 64))
    RT = np.asarray(jcams.extrinsic_RT(jnp.asarray(locs), jnp.asarray(Rs)))
    juv, jz = jcams.project(jnp.asarray(K), jnp.asarray(RT), jnp.asarray(pts))
    tuv, tz = tcams.project(torch.as_tensor(K), torch.as_tensor(RT),
                            torch.as_tensor(pts))
    assert tuv.shape == (3, 7, 2) and tz.shape == (3, 7)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("euclidean", [False, True])
def test_unproject_depth_matches_jax(euclidean):
    depth = np.random.RandomState(11).uniform(0.5, 9.0, (2, 16, 16)).astype(np.float32)
    fov = np.array([0.8, 1.3], np.float32)
    want = np.asarray(jcams.unproject_depth(jnp.asarray(depth), jnp.asarray(fov),
                                            16, euclidean=euclidean))
    got = tcams.unproject_depth(torch.as_tensor(depth), torch.as_tensor(fov), 16,
                                euclidean=euclidean).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("key", ["camera_rotation_final_quaternion",
                                 "camera_rotation_final"])
def test_camera_from_view_dict_matches_jax(key):
    e = _eulers(1, seed=12)[0]
    view = {"camera_location": [0.5, -1.0, 1.4], "field_of_view_rads": 1.1,
            "resolution": 64}
    view[key] = ([float(x) for x in np.asarray(jrot.euler_xyz_to_quat(
        jnp.asarray(e)))] if key.endswith("quaternion") else [float(x) for x in e])
    want = jcams.camera_from_view_dict(view)
    got = tcams.camera_from_view_dict(view)
    assert got.resolution == want.resolution == 64
    assert tcams.camera_from_view_dict(view, resolution=32).resolution == 32
    for name in ("location", "R", "fov"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=ATOL)


def test_decompose_KRT_matches_jax():
    loc = np.array([1.0, -2.0, 1.5], np.float32)
    R_obj = look_at_np(loc[None], np.array([[0.5, 0.5, 0.8]], np.float32))[0]
    K = np.asarray(jcams.intrinsic_matrix(jnp.asarray(0.9), 512), np.float64)
    RT = np.asarray(jcams.extrinsic_RT(jnp.asarray(loc), jnp.asarray(R_obj)),
                    np.float64)
    want = jcams.decompose_KRT(K @ RT)
    got = tcams.decompose_KRT(K @ RT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-9)
    np.testing.assert_allclose(got[1], RT[:, :3], atol=1e-6)
