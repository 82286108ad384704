"""The port's demo (``python -m omnidata_tpu_torch.demo``) against the root
``demo.py`` of the JAX package, on the CPU: Flax DPT-hybrid weights (the
JAX model's parameter tree, filled from a seeded numpy generator) saved as
a published-layout checkpoint, both demos run with ``--checkpoint`` on it
at ``--image_size 128`` on a seeded 640x480 PNG, for both tasks.

- ``<name>_rgb.png`` equal;
- the normal PNG within 1 code on >= 99.9% of pixels;
- the depth viridis PNG equal on >= 99.9% of pixels;
- the port's PIL-free resize against ``demo.preprocess`` (PIL) within
  1/255, and its viridis against ``plt.imsave`` equal.

The JAX demo needs PIL and matplotlib; without either this file skips.
"""
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.models import DPTHybrid as JDPT
from omnidata_tpu_torch import demo as tdemo
from omnidata_tpu_torch.cues.encode import load_png, save_png
from omnidata_tpu_torch.models.convert import _dpt_mapping, state_dict_from_flax

Image = pytest.importorskip("PIL.Image")
matplotlib = pytest.importorskip("matplotlib")

torch.set_num_threads(1)


def _flax_params(num_channels, seed):
    """The JAX DPTHybrid's parameter tree, filled from a seeded numpy
    generator: kernels N(0, 1/fan_in), biases N(0, 0.02), norm scales
    1 + N(0, 0.02), cls token and position embedding N(0, 0.02). As in a
    trained net, each residual branch starts small (the bottlenecks' last
    norm scale and the ViT blocks' output projections x 0.1), so float32
    rounding is not amplified block after block as a random stack does;
    the head's last conv is scaled by 0.5 so the outputs fall in [0, 1]."""
    shapes = jax.eval_shape(JDPT(num_channels=num_channels).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            a = rng.standard_normal(s.shape) / math.sqrt(np.prod(s.shape[:-1]))
            if str(path[-2].key) == "head_conv3":
                a = a * 0.5
            elif str(path[-2].key) in ("fc2", "proj") and str(path[-3].key) != "readout":
                a = a * 0.1
        elif name == "scale":
            a = 1.0 + 0.02 * rng.standard_normal(s.shape)
            if str(path[-2].key) == "gn" and str(path[-3].key) == "norm3":
                a = a * 0.1
        else:
            a = 0.02 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(shapes))


def _photo(seed=0):
    """A seeded 640x480 RGB image: smooth gradients, blobs and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    img = np.stack([xx / 640, yy / 480, 0.5 + 0.5 * np.sin(xx / 37 + yy / 53)], -1)
    for _ in range(6):
        cy, cx, r = rng.rand() * 480, rng.rand() * 640, 30 + rng.rand() * 90
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    img = img + 0.05 * rng.standard_normal(img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """Both demos, both tasks -> (port dir, JAX dir, image name)."""
    import demo as jdemo

    base = tmp_path_factory.mktemp("demo")
    png = str(base / "photo.png")
    save_png(png, _photo())
    tdir, jdir = str(base / "port"), str(base / "jax")
    for task, nc in (("depth", 1), ("normal", 3)):
        sd = state_dict_from_flax(_dpt_mapping(), _flax_params(nc, nc))
        ckpt = str(base / f"omnidata_dpt_{task}_v2.ckpt")
        torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, ckpt)
        del sd
        common = ["--task", task, "--img_path", png, "--checkpoint", ckpt,
                  "--image_size", "128"]
        tdemo.main(common + ["--output_path", tdir, "--device", "cpu"])
        jdemo.main(common + ["--output_path", jdir])
        os.remove(ckpt)
    return tdir, jdir, "photo"


def test_rgb_crop_equal(demo_runs):
    tdir, jdir, name = demo_runs
    a = load_png(os.path.join(tdir, f"{name}_rgb.png"))
    b = np.asarray(Image.open(os.path.join(jdir, f"{name}_rgb.png")))
    assert a.shape == b.shape == (512, 512, 3)
    np.testing.assert_array_equal(a, b)


def test_normal_png_within_one_code(demo_runs):
    tdir, jdir, name = demo_runs
    a = load_png(os.path.join(tdir, f"{name}_normal.png")).astype(np.int64)
    b = np.asarray(Image.open(os.path.join(jdir, f"{name}_normal.png"))).astype(np.int64)
    assert a.shape == b.shape == (128, 128, 3)
    assert len(np.unique(b)) > 10  # not saturated
    assert (np.abs(a - b) <= 1).all(-1).mean() >= 0.999


def test_depth_viridis_png_equal(demo_runs):
    tdir, jdir, name = demo_runs
    a = load_png(os.path.join(tdir, f"{name}_depth.png"))
    b = np.asarray(Image.open(os.path.join(jdir, f"{name}_depth.png")))
    assert a.shape == b.shape == (512, 512, 4)
    assert len(np.unique(b.reshape(-1, 4), axis=0)) > 10
    assert (a == b).all(-1).mean() >= 0.999


@pytest.mark.parametrize("task", ["depth", "normal"])
@pytest.mark.parametrize("size", [128, 384])
def test_pil_free_preprocess_matches_demo(task, size):
    import demo as jdemo

    img = _photo(1)
    want = jdemo.preprocess(Image.fromarray(img), size, task)
    got = tdemo.preprocess(img, size, task)
    assert got.shape == want.shape == (1, 3, size, size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1 / 255)
    np.testing.assert_array_equal(tdemo.center_crop_512(img),
                                  np.asarray(jdemo.center_crop_512(Image.fromarray(img))))


def test_viridis_matches_imsave():
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.random.RandomState(2).rand(40, 50).astype(np.float32)
    x[0, 0], x[1, 1] = 0.0, 1.0
    for arr in (x, 1.0 - x * 0.3, np.full((4, 5), 0.7, np.float32)):
        buf = io.BytesIO()
        plt.imsave(buf, arr, cmap="viridis", format="png")
        buf.seek(0)
        np.testing.assert_array_equal(tdemo.viridis_rgba(arr), np.asarray(Image.open(buf)))


def test_non_png_without_pil_names_the_format(tmp_path, monkeypatch):
    import builtins

    path = str(tmp_path / "photo.jpg")
    Image.fromarray(_photo()).save(path)
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match=r"\.jpg images needs PIL"):
        tdemo.load_rgb_u8(path)
