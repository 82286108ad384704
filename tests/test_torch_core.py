"""omnidata_tpu_torch.core against omnidata_tpu.core on the same numpy
inputs. Tolerance: atol 1e-5 (float32; the two frameworks sum the small
matrix products in different orders and round tan/cos/sin differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.core import cameras as jcams
from omnidata_tpu.core import rotations as jrot
from omnidata_tpu_torch.core import cameras as tcams
from omnidata_tpu_torch.core import rotations as trot

from _torch_port_util import both_cameras, look_at_np

torch.set_num_threads(1)

ATOL = 1e-5


def _views(n=3, seed=0):
    rng = np.random.RandomState(seed)
    locs = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    fovs = rng.uniform(0.6, 1.5, n).astype(np.float32)
    return locs, tgts, fovs


@pytest.mark.parametrize("name", ["rot_x", "rot_y", "rot_z"])
def test_rotation_helpers_match_jax(name):
    a = np.random.RandomState(1).uniform(-3, 3, (5,)).astype(np.float32)
    want = np.asarray(getattr(jrot, name)(jnp.asarray(a)))
    got = getattr(trot, name)(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_small_matmul_and_norm_match_jax():
    rng = np.random.RandomState(2)
    a, b = rng.uniform(-2, 2, (2, 4, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trot._mm(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jrot._mm(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)
    v = rng.normal(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(trot._norm(torch.as_tensor(v)).numpy(),
                               np.asarray(jrot._norm(jnp.asarray(v))), rtol=1e-6)


def test_look_at_rotation_matches_jax():
    locs, tgts, _ = _views(4)
    want = look_at_np(locs, tgts)
    got = tcams.look_at_rotation(torch.as_tensor(locs),
                                 torch.as_tensor(tgts)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # camera -Z looks at the target
    fwd = tgts - locs
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    np.testing.assert_allclose(-got[:, :, 2], fwd, atol=ATOL)


def test_intrinsics_and_extrinsics_match_jax():
    locs, tgts, fovs = _views(3)
    Rs = look_at_np(locs, tgts)
    for res in (64, 512):
        np.testing.assert_allclose(
            tcams.focal_px_from_fov(torch.as_tensor(fovs), res).numpy(),
            np.asarray(jcams.focal_px_from_fov(jnp.asarray(fovs), res)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tcams.intrinsic_matrix(torch.as_tensor(fovs), res).numpy(),
            np.asarray(jcams.intrinsic_matrix(jnp.asarray(fovs), res)),
            rtol=1e-6)
    np.testing.assert_allclose(
        tcams.extrinsic_RT(torch.as_tensor(locs), torch.as_tensor(Rs)).numpy(),
        np.asarray(jcams.extrinsic_RT(jnp.asarray(locs), jnp.asarray(Rs))),
        atol=ATOL)


@pytest.mark.parametrize("res", [32, 64])
def test_camera_rays_match_jax(res):
    locs, tgts, fovs = _views(3, seed=res)
    jcam, tcam = both_cameras(locs, look_at_np(locs, tgts), fovs, res)
    jo, jd = jcams.camera_rays(jcam)
    to, td = tcams.camera_rays(tcam)
    assert td.shape == (3, res, res, 3) and td.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
