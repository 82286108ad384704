"""omnidata_tpu_torch.cues against omnidata_tpu.cues, one module at a time on
the same float inputs (numpy seeds). Tolerances: atol 1e-5 on float outputs
(float32, different convolution/summation order); integer labels meet the
integer-label rule of tests/test_mesh.py (max diff <= 1 on < 2% of pixels,
or <= 32 on < 0.1%)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.cues import edges as jedges
from omnidata_tpu.cues import encode as jenc
from omnidata_tpu.cues.keypoints2d import keypoints2d as j_keypoints2d
from omnidata_tpu.cues import reshading as jresh
from omnidata_tpu_torch.cues import edges as tedges
from omnidata_tpu_torch.cues import encode as tenc
from omnidata_tpu_torch.cues.keypoints2d import keypoints2d as t_keypoints2d
from omnidata_tpu_torch.cues import reshading as tresh

from _torch_port_util import int_label_ok

torch.set_num_threads(1)

ATOL = 1e-5
N, H, W = 2, 48, 64


def _rng(seed):
    return np.random.RandomState(seed)


def _smooth_gray(seed):
    """(N,H,W) float32 images with edges and texture, in [0,1]."""
    rng = _rng(seed)
    base = rng.rand(N, H // 8, W // 8).repeat(8, 1).repeat(8, 2)
    return np.clip(base + 0.1 * rng.rand(N, H, W), 0, 1).astype(np.float32)


def _depth_and_valid(seed):
    rng = _rng(seed)
    d = rng.uniform(0.5, 12.0, (N, H, W)).astype(np.float32)
    valid = rng.rand(N, H, W) > 0.2
    return d, valid


def _jvmap(fn, *arrays):
    return np.asarray(jax.vmap(fn)(*(jnp.asarray(a) for a in arrays)))


def _assert_labels(got: torch.Tensor, want):
    assert got.numpy().dtype == np.asarray(want).dtype
    assert got.shape == np.asarray(want).shape
    ok, dmax, frac = int_label_ok(got.numpy(), want)
    assert ok, (dmax, frac)


def test_depth_and_mask_encoders_match_jax():
    d, valid = _depth_and_valid(0)
    d[0, :2] = 200.0  # past the 128 m range: saturates
    _assert_labels(tenc.encode_depth_16bit(torch.as_tensor(d), torch.as_tensor(valid)),
                   _jvmap(jenc.encode_depth_16bit, d, valid))
    _assert_labels(tenc.mask_valid_image(torch.as_tensor(valid)),
                   _jvmap(jenc.mask_valid_image, valid))


def test_uint_casts_round_half_even_like_jax():
    x = np.array([0.0, 0.5 / 255, 1.5 / 255, 2.5 / 255, 0.5, 1.0, 1.7, -0.2,
                  0.5 / 65535, 2.5 / 65535], np.float32)
    np.testing.assert_array_equal(tenc.img_as_uint8(torch.as_tensor(x)).numpy(),
                                  np.asarray(jenc.img_as_uint8(jnp.asarray(x))))
    np.testing.assert_array_equal(tenc.img_as_uint16(torch.as_tensor(x)).numpy(),
                                  np.asarray(jenc.img_as_uint16(jnp.asarray(x))))


def test_normals_color_matches_jax():
    rng = _rng(1)
    n = rng.normal(size=(N, H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    valid = rng.rand(N, H, W) > 0.3
    got = tenc.encode_normals_color(torch.as_tensor(n), torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(),
                               _jvmap(jenc.encode_normals_color, n, valid),
                               atol=ATOL)


def test_reshade_matches_jax():
    rng = _rng(2)
    t = rng.uniform(0.3, 15.0, (N, H, W)).astype(np.float32)
    n = rng.normal(size=(N, H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.normal(size=(N, H, W, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = rng.rand(N, H, W) > 0.1
    got = tresh.reshade(*(torch.as_tensor(a) for a in (t, n, d, valid)))
    np.testing.assert_allclose(got.numpy(), _jvmap(jresh.reshade, t, n, d, valid),
                               atol=ATOL)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_gaussian_blur_matches_jax(sigma):
    g = _smooth_gray(3)
    got = tedges.gaussian_blur_constant(torch.as_tensor(g), sigma)
    want = _jvmap(lambda x: jedges.gaussian_blur_constant(x, sigma), g)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_sobel_and_erosion_match_jax():
    g = _smooth_gray(4)
    mask = _rng(4).rand(N, H, W) > 0.1
    got = tedges.sobel_magnitude(torch.as_tensor(g), torch.as_tensor(mask))
    want = _jvmap(jedges.sobel_magnitude, g, mask)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(
        tedges._binary_erosion_3x3(torch.as_tensor(mask)).numpy(),
        _jvmap(jedges._binary_erosion_3x3, mask))


def test_edge_texture_matches_jax():
    g = _smooth_gray(5)
    got = tedges.edge_texture(torch.as_tensor(g), sigma=3.0)
    want = _jvmap(lambda x: jedges.edge_texture(x, sigma=3.0), g)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    _assert_labels(tenc.img_as_uint16(got), np.asarray(jenc.img_as_uint16(want)))


def test_edge_occlusion_matches_jax():
    d, valid = _depth_and_valid(6)
    codes = np.array(_jvmap(jenc.encode_depth_16bit, d, valid))  # uint16
    got = tedges.edge_occlusion(torch.as_tensor(codes))
    want = _jvmap(jedges.edge_occlusion, codes)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    _assert_labels(tenc.img_as_uint16(got), np.asarray(jenc.img_as_uint16(want)))


def test_keypoints2d_matches_jax():
    g = _smooth_gray(7)
    got = t_keypoints2d(torch.as_tensor(g))
    want = _jvmap(j_keypoints2d, g)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    _assert_labels(tenc.img_as_uint16(torch.clamp(got, 0.0, 1.0)),
                   np.asarray(jenc.img_as_uint16(jnp.clip(want, 0.0, 1.0))))


def test_keypoints2d_on_the_cpu_launches_and_counts_nothing():
    """A CPU call takes the plain version: no kernel launch, and no
    keypoints2d.images_fused under a recording profiler."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")
    from omnidata_tpu_torch.utils import profiler

    g = torch.as_tensor(_smooth_gray(7))
    before = kp.keypoints2d.launches
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = kp.keypoints2d(g)
    counters = profiler.summary()["counters"]
    profiler.reset()
    assert kp.keypoints2d.launches - before == 0
    assert counters.get("keypoints2d.images_fused", {"total": 0})["total"] == 0
    assert torch.equal(got, kp.keypoints2d_reference(g))


@pytest.mark.parametrize("sigmas", [(1.0, 30.0, 10), (2.0, 60.0, 7), (1.0, 5.0, 3)])
def test_keypoints2d_kernel_scale_rows_match_the_plain_reads(monkeypatch, sigmas):
    """The kernel's per-scale rows: size, s2, s3, s3 // 2 and the float32
    weight as the plain version computes them, and a reach equal to the
    largest |offset| of a corner that hessian_det_appx reads."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")

    offsets = []
    real = kp._box_sum

    def recording(padded, H, W, r0, c0, rl, cl):
        offsets.append(max(abs(o) for o in (r0 - 1, c0 - 1, r0 + rl - 1, c0 + cl - 1)))
        return real(padded, H, W, r0, c0, rl, cl)

    monkeypatch.setattr(kp, "_box_sum", recording)
    padded = kp._pad_integral(kp.integral_image(torch.rand(1, 8, 8)))
    rows = kp._scale_rows(*sigmas)
    assert len(rows) == sigmas[2]
    for row, sigma in zip(rows, np.linspace(*sigmas)):
        offsets.clear()
        kp.hessian_det_appx(padded, 8, 8, float(sigma))
        size = int(3 * float(sigma))
        s3 = size // 3
        w = np.float32(1.0 / (size * size))
        assert list(row[:4]) == [size, (size - 1) // 2, s3, s3 // 2]
        assert row[4] == max(offsets) and len(offsets) == 8
        assert row[5] == w.view(np.int32)


def test_keypoints2d_kernel_refuses_a_reach_past_the_pad():
    """A scale reaching past the plain version's pad of 128 is refused
    before any launch, where the plain version's slices would not fit."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")

    kp._scale_rows(1.0, 85.0, 2)  # size 255, reach 128: inside
    with pytest.raises(ValueError, match="past the pad"):
        kp._scale_rows(1.0, 86.0, 2)


@pytest.mark.parametrize("num_sigma", [0, 17])
def test_keypoints2d_kernel_refuses_scales_it_does_not_take(num_sigma):
    """The kernel takes 1 to 16 scales in its one launch: any other count is
    refused before a launch."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")

    assert len(kp._scale_rows(1.0, 30.0, 16)) == 16
    with pytest.raises(ValueError, match=f"num_sigma {num_sigma} must be 1 to 16"):
        kp._scale_rows(1.0, 30.0, num_sigma)
