"""The refocus augmentation in the port (omnidata_tpu_torch.augment.refocus
and ``python -m omnidata_tpu_torch.demo_refocus``) against the JAX
package's ``omnidata_tpu.augment`` and root ``demo_refocus.py``, on the CPU,
inputs made with numpy from a seed.

Tolerances, in float32: the blurs, stack, composite and refocused image
within 1e-5 absolute on [0, 1] images (61-tap sums in the frameworks' own
orders); quantiles within 1e-6 relative (XLA may fuse the interpolation's
multiply-add); membership indices equal and distances within 1e-6 on the
same quantile values; the demo's PNGs equal the port's ``refocus_image`` at
the same draws, and within one 8-bit step of JAX's (float rounding may move
a truncated value across a step).
"""
import glob
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import omnidata_tpu.augment as J
from omnidata_tpu.data.transforms import get_transform as j_get_transform
from omnidata_tpu_torch import demo_refocus
from omnidata_tpu_torch.augment import (
    composite_blur_stack,
    compute_circle_of_confusion_no_magnification,
    compute_quantile_membership,
    compute_quantiles,
    get_blur_stack,
    refocus_augmentation,
    refocus_draws,
    refocus_image,
    separable_gaussian,
)
from omnidata_tpu_torch.cues.encode import load_png

from _torch_port_util import jax_mini_scene

torch.set_num_threads(1)

IMG_ATOL = 1e-5
QUANTILE_RTOL = 1e-6
DIST_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, b=2, h=40, w=48):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 3, h, w).astype(np.float32),
            (1.0 + 5.0 * rng.rand(b, 1, h, w)).astype(np.float32))


def _two_planes():
    """tests/test_data_augment.py:357's depth: near half at 1 m, far half at
    10 m, whose quantiles repeat."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(1, 3, 32, 32).astype(np.float32)
    depth = np.concatenate([np.full((1, 1, 32, 16), 1.0, np.float32),
                            np.full((1, 1, 32, 16), 10.0, np.float32)], -1)
    return rgb, depth


DEPTHS = {"random": lambda: _images(1)[1], "two_planes": lambda: _two_planes()[1]}


@pytest.mark.parametrize("max_cutoff", [15, 31, 61])
@pytest.mark.parametrize("sigma", [0.05, 1.1, 9.7])
def test_separable_gaussian_matches_jax(sigma, max_cutoff):
    """Delta below sigma 0.1, replicate padding, a static window."""
    rgb, _ = _images(0)
    want = np.asarray(J.separable_gaussian(jnp.asarray(rgb), jnp.float32(sigma), max_cutoff))
    got = separable_gaussian(_t(rgb), sigma, max_cutoff).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    if sigma < 0.1:
        np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("n_quantiles", [4, 8, 10])
@pytest.mark.parametrize("which", sorted(DEPTHS))
def test_compute_quantiles_matches_jax(which, n_quantiles):
    depth = DEPTHS[which]()
    want = np.asarray(J.compute_quantiles(jnp.asarray(depth), n_quantiles))
    got = compute_quantiles(_t(depth), n_quantiles).numpy()
    assert got.shape == (depth.shape[0], n_quantiles + 1)
    np.testing.assert_allclose(got, want, rtol=QUANTILE_RTOL, atol=0)
    assert (np.diff(got, axis=1) >= 0).all()


@pytest.mark.parametrize("n_quantiles", [4, 8])
@pytest.mark.parametrize("which", sorted(DEPTHS))
def test_quantile_membership_matches_jax(which, n_quantiles):
    """searchsorted side left, clipped to [1, Q - 1]: indices equal and
    distances within 1e-6 on JAX's quantile values."""
    depth = DEPTHS[which]()
    qv = np.asarray(J.compute_quantiles(jnp.asarray(depth), n_quantiles))
    want = J.compute_quantile_membership(jnp.asarray(depth), jnp.asarray(qv))
    got = compute_quantile_membership(_t(depth), _t(qv))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DIST_ATOL)


def _draws(qv):
    """A focus at quantile 3 (or the last interior one) and two apertures."""
    b = qv.shape[0]
    focus = qv[:, min(3, qv.shape[1] - 2)][:, None].astype(np.float32)
    aperture = np.array([[0.5], [4.0]], np.float32)[:b]
    return focus, aperture


def test_blur_stack_and_composite_match_jax():
    rgb, depth = _images(2)
    qv = np.asarray(J.compute_quantiles(jnp.asarray(depth), 8))
    focus, aperture = _draws(qv)
    radii_j = np.asarray(J.compute_circle_of_confusion_no_magnification(
        jnp.asarray(qv), jnp.asarray(aperture), jnp.asarray(focus)))
    radii = compute_circle_of_confusion_no_magnification(_t(qv), _t(aperture), _t(focus))
    np.testing.assert_allclose(radii.numpy(), radii_j, rtol=1e-6, atol=0)
    want = np.asarray(J.get_blur_stack(jnp.asarray(rgb), jnp.asarray(radii_j), 31))
    stack = get_blur_stack(_t(rgb), _t(radii_j), 31)
    np.testing.assert_allclose(stack.numpy(), want, rtol=0, atol=IMG_ATOL)
    dl, dr, il, ir = J.compute_quantile_membership(jnp.asarray(depth), jnp.asarray(qv))
    want = np.asarray(J.composite_blur_stack(jnp.asarray(want), dl, dr, il[:, 0], ir[:, 0]))
    got = composite_blur_stack(stack, _t(dl), _t(dr), _t(il)[:, 0].long(), _t(ir)[:, 0].long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("max_cutoff", [31, 61])
@pytest.mark.parametrize("which", ["random", "two_planes"])
def test_refocus_image_matches_jax(which, max_cutoff):
    rgb, depth = _images(3) if which == "random" else _two_planes()
    qv = np.asarray(J.compute_quantiles(jnp.asarray(depth), 8))
    focus, aperture = _draws(qv)
    want = np.asarray(J.refocus_image(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(focus),
                                      jnp.asarray(aperture), jnp.asarray(qv), max_cutoff))
    got = refocus_image(_t(rgb), _t(depth), _t(focus), _t(aperture), _t(qv), max_cutoff)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)


def test_refocus_keeps_focus_plane_sharp():
    """tests/test_data_augment.py:357 on the port."""
    rgb, depth = _two_planes()
    qv = compute_quantiles(_t(depth), 4)
    out = refocus_image(_t(rgb), _t(depth), torch.full((1, 1), 1.0), torch.full((1, 1), 3.0),
                        qv, max_cutoff=31).numpy()
    near_err = np.abs(out[..., :14] - rgb[..., :14]).mean()
    far_err = np.abs(out[..., 18:] - rgb[..., 18:]).mean()
    assert near_err < 0.02 and far_err > near_err * 2


@pytest.mark.parametrize("n_quantiles,a_min,a_max", [(8, 0.01, 1.0), (10, 0.001, 6.0)])
def test_refocus_augmentation_is_refocus_image_at_its_draws(n_quantiles, a_min, a_max):
    """The augmentation equals refocus_image at the draws a generator of the
    same seed gives (``refocus_draws``), which lie in JAX's ranges: the
    focus index in [1, n_quantiles), the aperture in [min, max]; and JAX's
    refocus_image at those draws within 1e-5."""
    rgb, depth = _images(4, b=4)
    got = refocus_augmentation(_t(rgb), _t(depth), torch.Generator().manual_seed(7),
                               n_quantiles=n_quantiles, aperture_min=a_min,
                               aperture_max=a_max, max_cutoff=31)
    f_idx, aperture = refocus_draws(4, torch.Generator().manual_seed(7), n_quantiles,
                                    a_min, a_max)
    assert ((f_idx >= 1) & (f_idx < n_quantiles)).all()
    assert ((aperture >= a_min) & (aperture <= a_max)).all()
    qv = compute_quantiles(_t(depth), n_quantiles)
    focus = torch.gather(qv, 1, f_idx)
    want = refocus_image(_t(rgb), _t(depth), focus, aperture, qv, 31)
    assert torch.equal(got, want)
    want_j = np.asarray(J.refocus_image(jnp.asarray(rgb), jnp.asarray(depth),
                                        jnp.asarray(focus.numpy()),
                                        jnp.asarray(aperture.numpy()),
                                        jnp.asarray(qv.numpy()), 31))
    np.testing.assert_allclose(got.numpy(), want_j, rtol=0, atol=IMG_ATOL)


# ---- demo_refocus -----------------------------------------------------------

N_PAIRS = 2


@pytest.fixture(scope="module")
def pairs_dir(tmp_path_factory):
    """The JAX CLI's mini scene (rgb and depth_euclidean at 64²): its first
    N_PAIRS pairs copied into one folder, as the demo reads them."""
    scene = jax_mini_scene(str(tmp_path_factory.mktemp("refocus_scene")),
                           tasks=("rgb", "depth_euclidean"))
    d = tmp_path_factory.mktemp("pairs")
    for f in sorted(glob.glob(f"{scene}/rgb/*.png"))[:N_PAIRS]:
        shutil.copy(f, d)
        depth = f.replace("rgb", "depth_euclidean")
        assert os.path.exists(depth)
        shutil.copy(depth, d)
    return str(d)


def _rgb_files(d):
    return sorted(glob.glob(f"{d}/*rgb*.png"))


def test_demo_refocus_inputs_equal_jax(pairs_dir):
    """The demo's rgb and depth at 512 equal the JAX demo's (PIL images
    through the JAX package's transforms, depth clamped at 1e-3)."""
    t_rgb = j_get_transform("rgb", image_size=512)
    t_depth = j_get_transform("depth_euclidean", image_size=512)
    for f in _rgb_files(pairs_dir):
        dpath = os.path.join(pairs_dir, os.path.basename(f).replace("rgb", "depth_euclidean"))
        rgb, depth = demo_refocus.load_pair(f, dpath)
        want_rgb = np.asarray(t_rgb(Image.open(f)))[:3][None]
        want_depth = np.maximum(np.asarray(t_depth(Image.open(dpath)))[:1][None], 1e-3)
        assert rgb.shape == (1, 3, 512, 512) and depth.shape == (1, 1, 512, 512)
        np.testing.assert_array_equal(rgb, want_rgb)
        np.testing.assert_array_equal(depth, want_depth)
        assert depth.min() >= 1e-3 and depth.max() > depth.min()


def test_demo_refocus_pngs_equal_refocus_image(pairs_dir, tmp_path):
    """``demo_refocus.main(... --device cpu)``: one <name>_refocused.png per
    pair, equal to the port's refocus_image at the draws of a generator
    seeded with --seed (file after file), and within one 8-bit step of
    JAX's refocus_image at those draws."""
    out_dir = str(tmp_path / "out")
    demo_refocus.main(["--input_path", pairs_dir, "--output_path", out_dir, "--seed", "3",
                       "--device", "cpu"])
    gen = torch.Generator().manual_seed(3)
    files = _rgb_files(pairs_dir)
    assert len(files) == N_PAIRS
    for f in files:
        name = os.path.splitext(os.path.basename(f))[0]
        rgb, depth = demo_refocus.load_pair(
            f, os.path.join(pairs_dir, os.path.basename(f).replace("rgb", "depth_euclidean")))
        f_idx, aperture = refocus_draws(1, gen, 10, 0.001, 6.0)
        qv = compute_quantiles(_t(depth), 10)
        focus = torch.gather(qv, 1, f_idx)
        want = demo_refocus.to_png_u8(refocus_image(_t(rgb), _t(depth), focus, aperture, qv)[0])
        got = load_png(os.path.join(out_dir, f"{name}_refocused.png"))
        np.testing.assert_array_equal(got, want)
        want_j = np.asarray(J.refocus_image(jnp.asarray(rgb), jnp.asarray(depth),
                                            jnp.asarray(focus.numpy()),
                                            jnp.asarray(aperture.numpy()),
                                            jnp.asarray(qv.numpy())))
        want_j = (np.clip(want_j[0], 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
        assert np.abs(got.astype(int) - want_j.astype(int)).max() <= 1


def test_demo_refocus_needs_a_card_by_default(pairs_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default --device cuda runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_refocus.main(["--input_path", pairs_dir, "--output_path", str(tmp_path)])
