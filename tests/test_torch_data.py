"""The port's data path against the JAX package's on the CPU: the YAML
subset reader against PyYAML; task configs, poses and splits; the PIL-free
transforms bit for bit against JAX's PIL path, on the PNGs the JAX CLI
writes for the mini scene of tests/test_train.py:25 and on synthetic PNGs
of other modes and sizes; the dataset's samples and batches and the mixing
loader's batches for equal seeds, bit for bit; the training masks (exact);
the augmentation functions with their parameters fixed (float32 convolutions
summed in other orders: within 1e-6; the bilinear resize, two taps in the
port against JAX's dense interpolation matmuls, within
tests/test_torch_models.py's layer tolerance, 1e-4 of the largest value).
"""
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from omnidata_tpu.augment import image_augs as jaug
from omnidata_tpu.data import dataset as jds
from omnidata_tpu.data import loader as jloader
from omnidata_tpu.data import masks as jmasks
from omnidata_tpu.data import pose as jpose
from omnidata_tpu.data import splits as jsplits
from omnidata_tpu.data import task_configs as jtc
from omnidata_tpu.data import transforms as jtr
from omnidata_tpu_torch.augment import image_augs as taug
from omnidata_tpu_torch.cues.encode import encode_png
from omnidata_tpu_torch.data import dataset as tds
from omnidata_tpu_torch.data import loader as tloader
from omnidata_tpu_torch.data import masks as tmasks
from omnidata_tpu_torch.data import pose as tpose
from omnidata_tpu_torch.data import splits as tsplits
from omnidata_tpu_torch.data import task_configs as ttc
from omnidata_tpu_torch.data import transforms as ttr
from omnidata_tpu_torch.utils import config as tconfig
from omnidata_tpu_torch.utils.pil_image import pil_bilinear_resize, pil_nearest_resize

from _torch_port_util import jax_mini_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG_TOL = 1e-6
RESIZE_TOL = 1e-4  # x max |JAX|, as tests/test_torch_models.py's LAYER_TOL
TASKS = ("rgb", "normal", "depth_zbuffer", "mask_valid")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jax_mini_scene(str(tmp_path_factory.mktemp("scene")))


@pytest.fixture(scope="module")
def wide_scene(tmp_path_factory):
    """A building of 96x64 PNGs written by PIL (rgb 8-bit RGB, normal RGBA,
    depth 16-bit grey, mask 8-bit grey with 0/255): non-square, so the
    dataset crops; an incomplete view that the index must drop."""
    root = tmp_path_factory.mktemp("wide") / "b0"
    rng = np.random.RandomState(0)
    for task in TASKS:
        (root / task).mkdir(parents=True)
        for p in range(2):
            for v in range(3):
                if task == "depth_zbuffer":
                    arr = rng.randint(0, 65535, (64, 96)).astype(np.uint16)
                elif task == "mask_valid":
                    arr = (rng.rand(64, 96) > 0.2).astype(np.uint8) * 255
                elif task == "normal":
                    arr = rng.randint(0, 255, (64, 96, 4)).astype(np.uint8)
                else:
                    arr = rng.randint(0, 255, (64, 96, 3)).astype(np.uint8)
                Image.fromarray(arr).save(root / task / f"point_{p}_view_{v}_domain_{task}.png")
    Image.fromarray(np.zeros((64, 96, 3), np.uint8)).save(
        root / "rgb" / "point_9_view_0_domain_rgb.png")
    return str(root.parent)


# ---------------- config reader ----------------

CONFIGS = [
    {"model": "unet", "unet_downsample": 2, "image_size": 64, "lr": 1.0e-3,
     "weight_decay": 2.0e-6, "val_fraction": 0.4, "augment": False,
     "checkpoint_dir": "/tmp/a b/ck", "pretrained_weights_path": None,
     "data_paths": {"scene": "/tmp/x", "replica": None}},
    {"lr": 1e-5, "x": 1e5, "neg": -3, "s": "it's: #here", "n": "123", "e": "",
     "nested": {"a": {"b": True, "c": "null"}}, "yes": "no"},
]


@pytest.mark.parametrize("path", ["config/depth.yml", "config/normal.yml"])
def test_config_reader_reads_the_repo_configs_as_pyyaml(path):
    text = open(os.path.join(ROOT, path)).read()
    assert tconfig.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["trainer", "scalars"])
def test_config_reader_reads_dumped_configs_as_pyyaml(cfg):
    text = yaml.safe_dump(cfg)
    assert tconfig.loads(text) == yaml.safe_load(text) == cfg
    for extra in ("a: 1e-5", "a: 1.0e-5", "a: +7", "a: 'x'' y' # c", 'a: "t\\tu"',
                  "a:\n  b:\n  c: 2\nd: ~", "'k k': 1"):
        assert tconfig.loads(extra) == yaml.safe_load(extra), extra


@pytest.mark.parametrize("text", ["a: [1, 2]", "- a", "a: yes", "a: 0x10", "a: &x 1",
                                  "a: !!str 1", "a: |\n  x", "a: .inf", "a:\n\tb: 1",
                                  "a: 010", "a: b: c", "---\na: 1"])
def test_config_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        tconfig.loads(text)


# ---------------- task configs, poses, splits ----------------

def test_task_configs_poses_and_splits_match_jax(scene, tmp_path):
    assert ttc.task_parameters == jtc.task_parameters
    assert ttc.SINGLE_IMAGE_TASKS == jtc.SINGLE_IMAGE_TASKS
    pdir = os.path.join(scene, "point_info")
    for fn in sorted(os.listdir(pdir)):
        info = jtr.default_loader(os.path.join(pdir, fn))
        assert ttr.default_loader(os.path.join(pdir, fn)) == info
        got, want = tpose.cam_to_world_R_T_K(info), jpose.cam_to_world_R_T_K(info)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    csv = tmp_path / "split.csv"
    csv.write_text("id,train,val,test\nb0,1,0,0\nb1,0,1,0\nmosquito,1,0,0\nb2,1,0,1\n")
    assert tsplits.get_splits(str(csv)) == jsplits.get_splits(str(csv))
    spaces = [f"s{i:03d}" for i in range(37)]
    ladder = tsplits.subset_ladder(spaces)
    assert ladder == jsplits.subset_ladder(spaces)
    splits = jsplits.get_splits(str(csv))
    assert tsplits.flat_split_to_spaces(splits, ladder) == \
        jsplits.flat_split_to_spaces(splits, ladder)


# ---------------- transforms ----------------

def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("size", [None, 64, 48, 40, 96])
def test_transforms_on_the_jax_cli_pngs_equal_jax_bit_for_bit(scene, size):
    for task in TASKS:
        tdir = os.path.join(scene, task)
        jt, tt = jtr.get_transform(task, size), ttr.get_transform(task, size)
        for fn in sorted(os.listdir(tdir)):
            p = os.path.join(tdir, fn)
            _same(tt(ttr.default_loader(p)), jt(jtr.default_loader(p)), (task, size, fn))


def _png_bytes(arr, mode=None):
    buf = io.BytesIO()
    (Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)).save(buf, "PNG")
    return buf.getvalue()


def _synthetic_pngs(tmp_path):
    """(task, path) of PNGs in other modes: grey and RGB 8-bit, RGBA, 16-bit
    grey, 16-bit RGB (PIL keeps the high byte), a palette image (PIL gives
    its indices), each 37x53, and the CLI's own encoder's output."""
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 255, (37, 53, 3)).astype(np.uint8)
    g16 = rng.randint(0, 65535, (37, 53)).astype(np.uint16)
    pal = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=64)
    buf = io.BytesIO()
    pal.save(buf, "PNG")
    files = {
        ("rgb", "rgb8"): _png_bytes(rgb),
        ("rgb", "grey8"): _png_bytes(rgb[..., 0]),
        ("rgb", "port_encoder"): encode_png(rgb),
        ("normal", "rgba8"): _png_bytes(rng.randint(0, 255, (37, 53, 4)).astype(np.uint8)),
        ("depth_zbuffer", "grey16"): _png_bytes(g16),
        ("depth_euclidean", "port_encoder16"): encode_png(g16),
        ("mask_valid", "grey8"): _png_bytes((rgb[..., 1] > 100).astype(np.uint8) * 255),
        ("segment_semantic", "palette"): buf.getvalue(),
        ("principal_curvature", "rgb8"): _png_bytes(rgb),
        ("fragments", "rgb8"): _png_bytes(rgb),
    }
    rgb16 = np.stack([g16, g16[::-1], g16[:, ::-1]], -1)
    import zlib
    import struct

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    raw = np.concatenate([np.zeros((37, 1), np.uint8),
                          rgb16.astype(">u2").view(np.uint8).reshape(37, -1)], 1)
    files[("normal", "rgb16")] = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 53, 37, 16, 2, 0, 0, 0)) + chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + chunk(b"IEND", b""))
    out = []
    for (task, name), data in files.items():
        p = tmp_path / f"{task}_{name}.png"
        p.write_bytes(data)
        out.append((task, str(p)))
    return out


@pytest.mark.parametrize("size", [None, 37, 24, 16, 50, 75])
def test_transforms_on_other_png_modes_equal_jax_bit_for_bit(tmp_path, size):
    for task, p in _synthetic_pngs(tmp_path):
        if task == "rgb" and p.endswith("rgba8.png"):
            continue
        want = jtr.get_transform(task, size)(jtr.default_loader(p))
        got = ttr.get_transform(task, size)(ttr.default_loader(p))
        _same(got, want, (task, size, os.path.basename(p)))


def test_bilinear_of_alpha_or_16_bit_images_raises(tmp_path):
    for task, p in _synthetic_pngs(tmp_path):
        if p.endswith(("rgba8.png", "grey16.png", "encoder16.png")):
            with pytest.raises(ValueError):
                ttr.get_transform("rgb", 24)(ttr.default_loader(p))


@pytest.mark.parametrize("size", [64, 40, 7])
def test_resize_of_2d_label_arrays_equals_jax(size):
    arr = np.random.RandomState(2).randint(-1, 40, (45, 61)).astype(np.int16)
    _same(ttr._resize(arr, size, "nearest"), jtr._resize(arr, size, "nearest"), size)
    feat = np.zeros((3, 45, 61), np.float32)
    assert ttr._resize(feat, size, "nearest") is feat


@pytest.mark.parametrize("src", [(512, 512), (480, 640), (37, 53), (300, 301)])
def test_pil_resizes_equal_pil(src):
    rng = np.random.RandomState(3)
    H, W = src
    a8 = rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
    g16 = rng.randint(0, 65535, (H, W)).astype(np.uint16)
    i32 = rng.randint(-5, 10**6, (H, W)).astype(np.int32)
    for h, w in [(384, 384), (384, 512), (17, 29), (64, 85), (999, 1000), (H, W + 1)]:
        for arr, mode in [(a8, None), (a8[..., 0], None), (i32, "I")]:
            im = Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)
            np.testing.assert_array_equal(pil_nearest_resize(arr, (w, h)),
                                          np.asarray(im.resize((w, h), Image.NEAREST)))
        np.testing.assert_array_equal(
            pil_nearest_resize(g16, (w, h), special=True),
            np.asarray(Image.fromarray(g16).resize((w, h), Image.NEAREST)))
        for arr in (a8, a8[..., 0]):
            np.testing.assert_array_equal(
                pil_bilinear_resize(arr, (w, h)),
                np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR)))


def test_default_loader_npy_and_hdf5(tmp_path, monkeypatch):
    """.npy and .hdf5 (hypersim's int16 NYU40 ids, -1 undefined) load as
    JAX's loader loads them; without h5py the .hdf5 branch raises an
    ImportError that names it."""
    import sys

    import h5py

    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    np.save(tmp_path / "f.npy", a)
    np.testing.assert_array_equal(ttr.default_loader(str(tmp_path / "f.npy")), a)
    sem = np.arange(-1, 11, dtype=np.int16).reshape(3, 4)
    path = str(tmp_path / "x_domain_semantic.hdf5")
    with h5py.File(path, "w") as f:
        f["dataset"] = sem
    got, want = ttr.default_loader(path), jtr.default_loader(path)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        ttr.default_loader(path)


# ---------------- dataset and loaders ----------------

def _datasets(root, **kw):
    return (jds.OmnidataDataset(jds.Options(data_path=root, **kw)),
            tds.OmnidataDataset(tds.Options(data_path=root, **kw)))


def _same_sample(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            _same(got[k], want[k], k)
        elif isinstance(want[k], list) and want[k] and isinstance(want[k][0], dict):
            assert got[k] == want[k], k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("kw", [
    dict(tasks=TASKS + ("point_info",), random_flip=True),
    dict(tasks=TASKS, random_flip=True, image_size=48),
    dict(tasks=("rgb", "normal", "point_info"), num_positive=2, random_flip=True),
], ids=["flip", "resize48", "multiview"])
def test_dataset_items_equal_jax_for_equal_seeds(scene, kw):
    jd, td = _datasets(scene, **kw)
    assert td.index == jd.index and len(td) >= 8
    for i in range(len(jd)):
        for seed in (0, 7, 2**31 + 5):
            _same_sample(td.item(i, seed), jd.item(i, seed))


@pytest.mark.parametrize("kw", [dict(random_crop=False), dict(random_crop=True)],
                         ids=["centre_crop", "random_crop"])
def test_dataset_crops_flips_and_batches_equal_jax(wide_scene, kw):
    jd, td = _datasets(wide_scene, tasks=TASKS, image_size=48, random_flip=True, **kw)
    assert len(td) == len(jd) == 6  # the incomplete view is dropped
    for i in range(6):
        _same_sample(td.item(i, 11 + i), jd.item(i, 11 + i))
    jd.rng, td.rng = np.random.RandomState(4), np.random.RandomState(4)
    for a, b in zip(td.batches(4, drop_last=False), jd.batches(4, drop_last=False)):
        _same_sample(a, b)
    jtr_, jva = jd.holdout(0.34)
    ttr_, tva = td.holdout(0.34)
    assert ttr_.index == jtr_.index and tva.index == jva.index
    assert td.filter_buildings(["b0"]).index == jd.filter_buildings(["b0"]).index


def test_loaders_yield_jax_batches_for_equal_seeds(scene, wide_scene):
    tasks = ("rgb", "depth_zbuffer", "mask_valid")  # wide_scene's normals are RGBA
    jd = [jds.OmnidataDataset(jds.Options(data_path=r, tasks=tasks, image_size=48))
          for r in (scene, wide_scene)]
    td = [tds.OmnidataDataset(tds.Options(data_path=r, tasks=tasks, image_size=48))
          for r in (scene, wide_scene)]
    for seed in (0, 3):
        got = list(tloader.MixedLoader(td, 4, num_workers=3).batches(steps=3, seed=seed))
        want = list(jloader.MixedLoader(jd, 4, num_workers=3).batches(steps=3, seed=seed))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _same_sample(a, b)
    got = list(tloader.PrefetchLoader(td[0], 3, num_workers=2).epoch(seed=5))
    want = list(jloader.PrefetchLoader(jd[0], 3, num_workers=2).epoch(seed=5))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same_sample(a, b)


# ---------------- masks ----------------

def test_masks_equal_jax_on_the_augment_tests_inputs():
    """tests/test_data_augment.py:63,80 inputs, and random masks."""
    t = np.ones((1, 1, 8, 8), np.float32)
    t[0, 0, 4, 4] = 0.0
    for k in (1, 2, 3, 4, 5):
        _same(tmasks.build_mask(torch.from_numpy(t), 0.0, k).numpy(),
              np.asarray(jmasks.build_mask(jnp.asarray(t), val=0.0, max_pool_size=k)), k)
    t3 = np.full((1, 3, 8, 8), 128.0 / 255.0, np.float32)
    t3[0, :, 0, 0] = 0.9
    _same(tmasks.build_mask(torch.from_numpy(t3), 0.502, 1).numpy(),
          np.asarray(jmasks.build_mask(jnp.asarray(t3), val=0.502, max_pool_size=1)), "t3")
    mv = np.ones((1, 1, 8, 8), bool)
    mv[0, 0, 5, 5] = False
    got = tmasks.make_valid_mask(torch.from_numpy(mv), 4).numpy()
    _same(got, np.asarray(jmasks.make_valid_mask(jnp.asarray(mv), 4)), "tile")
    assert not got[0, 0, 4:8, 4:8].any() and got[0, 0, :4].all()
    rng = np.random.RandomState(5)
    for k in (2, 3, 4, 8):
        m = rng.rand(2, 1, 16, 24) > 0.1
        _same(tmasks.dilate_invalid(torch.from_numpy(m), k).numpy(),
              np.asarray(jmasks.dilate_invalid(jnp.asarray(m), k)), ("dilate", k))
        if 16 % k == 0:
            _same(tmasks.make_valid_mask(torch.from_numpy(m), k).numpy(),
                  np.asarray(jmasks.make_valid_mask(jnp.asarray(m), k)), ("valid", k))


# ---------------- augmentations ----------------

def _img(shape=(2, 3, 20, 28), seed=6):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=AUG_TOL)


def test_sharpness_and_blurs_equal_jax():
    x = _img()
    factor = np.array([0.3, 0.9], np.float32)
    _close(taug.sharpness(torch.from_numpy(x), torch.from_numpy(factor)),
           jaug.sharpness(jnp.asarray(x), jnp.asarray(factor)))
    for d in range(4):
        # the JAX function draws its direction from a key: find a key per d
        key = next(k for k in (jax.random.PRNGKey(s) for s in range(64))
                   if int(jax.random.randint(k, (), 0, 4)) == d)
        _close(taug.motion_blur(torch.from_numpy(x), d), jaug.motion_blur(jnp.asarray(x), key))
        _close(taug.motion_blur(torch.from_numpy(x), torch.tensor(d)),
               jaug.motion_blur(jnp.asarray(x), key))
    for sigma in (0.1, 0.7, 2.0):
        _close(taug.gaussian_blur(torch.from_numpy(x), sigma),
               jaug.gaussian_blur(jnp.asarray(x), jnp.float32(sigma)))


@pytest.mark.parametrize("out_size", [12, 20, 28, 40, 64])
def test_resize_crop_equals_jax(out_size):
    x = _img()
    depth = _img((2, 1, 20, 28), 7)
    mask = _img((2, 1, 20, 28), 8) > 0.3
    jb = {"rgb": jnp.asarray(x), "depth": jnp.asarray(depth), "mask_valid": jnp.asarray(mask),
          "name": ["a", "b"]}
    tb = {"rgb": torch.from_numpy(x), "depth": torch.from_numpy(depth),
          "mask_valid": torch.from_numpy(mask), "name": ["a", "b"]}
    want = jaug.resize_crop(jb, jax.random.PRNGKey(0), out_size)
    got = taug.resize_crop(tb, torch.Generator().manual_seed(0), out_size)
    assert got["name"] == ["a", "b"]
    for k in ("rgb", "depth", "mask_valid"):
        assert tuple(got[k].shape) == want[k].shape, k
        if k == "mask_valid":
            _same(got[k].numpy(), np.asarray(want[k]), k)
        elif k == "rgb" and out_size > 28:  # resized, not cropped
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                       atol=RESIZE_TOL * float(np.abs(want[k]).max()))
        else:
            _close(got[k], want[k])
    rc = taug.resize_crop(tb, torch.Generator().manual_seed(1), 12, random_crop=True)
    assert rc["rgb"].shape == (2, 3, 12, 12) and rc["depth"].shape == (2, 1, 12, 12)


def test_augment_rgb_runs_in_range():
    """tests/test_data_augment.py:384 on the port: shape kept, values in
    [0, 1]; the draws come from the generator, so a seed repeats them."""
    rgb = torch.from_numpy(_img((2, 3, 32, 32), 1))
    outs = [taug.augment_rgb(rgb, torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert outs[0].shape == rgb.shape and float(outs[0].min()) >= 0
    assert torch.equal(outs[0], outs[1])
    changed = [not torch.equal(taug.augment_rgb(rgb, torch.Generator().manual_seed(s)), rgb)
               for s in range(12)]
    assert any(changed) and not all(changed)  # gated: some draws leave rgb as is


def test_load_building_mesh_uses_the_ports_loaders(scene):
    """The dataset's scan mesh (mesh.ply of a single-building root) comes
    from the port's PLY loader with the JAX loader's faces and vertices."""
    jd, td = _datasets(scene, tasks=("rgb",))
    got, want = td.load_building_mesh(""), jd.load_building_mesh("")
    assert got.num_faces == want.num_faces
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(want.vertices))
    np.testing.assert_array_equal(got.faces[: got.num_faces].numpy(),
                                  np.asarray(want.faces[: want.num_faces]))
    assert td.load_building_mesh("") is got  # cached
