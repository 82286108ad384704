"""The port's data modules against the JAX package's:
``data.{packed_cache, components, hypersim, scene_metadata,
segment_instance}``, the trainers' ``packed_cache`` config key and
``default_loader``'s .hdf5 labels, on the inputs of tests/test_train.py
(81, 111, 136, 606), tests/test_components.py (88, 126, 152, 185) and
tests/test_data_augment.py (409, 422, 459, 486, 502).

Tolerance: equal. Items of both packages' datasets, packed or direct, are
equal array for array for equal seeds (the port decodes PNGs as PIL does);
metadata, sampler draws and instance helpers are equal.
"""
import os
import sys

import numpy as np
import pytest
import torch

import omnidata_tpu.data as jdata
import omnidata_tpu_torch.data as tdata
from omnidata_tpu.data import hypersim as jhyp
from omnidata_tpu.data import packed_cache as jpc
from omnidata_tpu_torch.data import hypersim as thyp
from omnidata_tpu_torch.data import packed_cache as tpc

from _torch_port_util import jax_mini_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jax_mini_scene(str(tmp_path_factory.mktemp("scene")))


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _seeded(ds, seed):
    ds.rng = np.random.RandomState(seed)
    return ds


@pytest.mark.parametrize("tasks, num_positive", [
    (("rgb", "normal", "depth_zbuffer", "point_info"), 1), (("rgb", "normal"), 2)])
def test_packed_dataset_matches_direct_and_jax(scene, tmp_path, tasks, num_positive):
    """tests/test_train.py:81 and :111: flip augmentation, pose keys and
    FILENAME multiview; the same digest, packed tasks and items as JAX's."""
    opts = dict(data_path=scene, tasks=tasks, random_flip=True,
                num_positive=num_positive)
    ds = tdata.OmnidataDataset(tdata.Options(**opts))
    jds = jdata.OmnidataDataset(jdata.Options(**opts))
    assert tpc.pack_digest(ds) == jpc.pack_digest(jds)
    pds = tpc.PackedDataset.build(ds, str(tmp_path / "pack"), num_workers=2)
    jpds = jpc.PackedDataset.build(jds, str(tmp_path / "jpack"), num_workers=2)
    assert set(pds._packed) == set(jpds._packed) == {
        t for t in tasks if t != "point_info"}
    for t, mm in pds._packed.items():
        np.testing.assert_array_equal(mm, jpds._packed[t])
    for i in range(len(ds)):
        a = _seeded(ds, 100 + i)[i]
        _assert_items_equal(a, _seeded(pds, 100 + i)[i])
        _assert_items_equal(a, _seeded(jpds, 100 + i)[i])
    assert tpc.PackedDataset.build(ds, str(tmp_path / "pack"))._pack_dir == pds._pack_dir
    sub = ds.subset(range(1, len(ds)))
    assert tpc.pack_digest(sub) != tpc.pack_digest(ds)
    np.testing.assert_array_equal(pds.item(0, 99)["rgb"], pds.item(0, 99)["rgb"])


def test_packed_cache_bakes_hooks_and_checks_its_size(scene, tmp_path):
    """tests/test_train.py:136: hooks are applied at pack time only; a pack
    that does not hold the dataset's samples is refused."""
    ds = tdata.OmnidataDataset(tdata.Options(data_path=scene, tasks=("rgb",),
                                             random_flip=False))
    ds.post_transform_hooks["rgb"] = lambda a, b, p, v: a * 0.5
    pds = tpc.PackedDataset.build(ds, str(tmp_path / "pack"))
    np.testing.assert_array_equal(ds[0]["rgb"], pds[0]["rgb"])
    assert pds[0]["rgb"].max() <= 0.5
    with pytest.raises(ValueError, match="rebuild the pack"):
        tpc.PackedDataset(ds.subset(range(1, len(ds))), pds._pack_dir)


def test_build_datasets_packed_cache_matches_jax(scene, tmp_path):
    """tests/test_train.py:606 on both drivers: packed_cache wraps every
    resolved dataset; samples equal the direct path's and JAX's."""
    from omnidata_tpu.train.driver import build_datasets as j_build
    from omnidata_tpu_torch.train.driver import build_datasets as t_build

    cfg = {"data_paths": {"scene": scene}, "val_fraction": 0.5}
    tr0, va0 = t_build(cfg, ("rgb", "normal"), 64)
    cfg["packed_cache"] = str(tmp_path / "pack")
    tr, va = t_build(cfg, ("rgb", "normal"), 64)
    jtr, jva = j_build(dict(cfg, packed_cache=str(tmp_path / "jpack")),
                       ("rgb", "normal"), 64)
    assert all(isinstance(d, tpc.PackedDataset) for d in tr + va)
    assert [len(d) for d in tr + va] == [len(d) for d in tr0 + va0] == [
        len(d) for d in jtr + jva]
    for got, direct, want in zip(tr + va, tr0 + va0, jtr + jva):
        for i in range(len(got)):
            a = _seeded(got, 3 + i)[i]
            _assert_items_equal(a, _seeded(direct, 3 + i)[i])
            _assert_items_equal(a, _seeded(want, 3 + i)[i])


def test_trainer_runs_on_a_packed_cache(scene, tmp_path):
    """train_normal --device cpu with packed_cache set: the pack is built
    under that directory and the steps log finite losses."""
    import contextlib
    import io

    import yaml

    from omnidata_tpu_torch import train_normal

    pack = tmp_path / "pack"
    cfg = {"model": "unet", "unet_downsample": 2, "image_size": 64,
           "batch_size": 2, "max_steps": 2, "log_step": 1, "val_step": 100,
           "ckpt_step": 100, "val_fraction": 0.4, "num_workers": 2,
           "checkpoint_dir": str(tmp_path / "ck"), "data_paths": {"scene": scene},
           "packed_cache": str(pack)}
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_normal.main(["--config_file", str(path), "--device", "cpu"])
    out = buf.getvalue()
    assert "step 2:" in out and "nan" not in out.lower()
    assert len([d for d in os.listdir(pack) if
                os.path.exists(pack / d / "manifest.json")]) == 2  # train + val


def test_loader_rate_tool_runs_on_both_packages(scene):
    """tools/loader_rate.py (chip_smoke phase 19c's loader rates) on the
    mini scene, the port's data layer and the JAX package's."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from loader_rate import main

    for package in ("torch", "jax"):
        out = main(["--data", scene, "--package", package, "--workers", "1",
                    "--batch", "2", "--batches", "1"])
        assert out["samples"] >= 2 and out["png_1"] > 0 and out["packed_1"] > 0


# ---------------- components and hypersim ----------------

@pytest.fixture()
def fake_dataset_root(tmp_path):
    """tests/test_data_augment.py:95's six 16² samples and one incomplete."""
    from PIL import Image

    rng = np.random.RandomState(0)
    root = tmp_path / "building1"
    for task in ("rgb", "normal", "depth_zbuffer"):
        (root / task).mkdir(parents=True)
        for p in range(2):
            for v in range(3):
                arr = (rng.randint(0, 65535, (16, 16)).astype(np.uint16)
                       if task == "depth_zbuffer"
                       else rng.randint(0, 255, (16, 16, 3), np.uint8))
                Image.fromarray(arr).save(root / task / f"point_{p}_view_{v}_domain_{task}.png")
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
        root / "rgb" / "point_9_view_0_domain_rgb.png")
    return tmp_path


def test_component_registry_matches_jax(fake_dataset_root):
    """tests/test_data_augment.py:486: the registry's entries, the
    component dataset and normal_world_to_cam equal JAX's."""
    assert tdata.COMPONENTS.keys() == jdata.COMPONENTS.keys()
    for k, c in tdata.COMPONENTS.items():
        assert vars(c) == vars(jdata.COMPONENTS[k]), k
    assert tdata.NYU40_CLASSES == jdata.NYU40_CLASSES
    kw = dict(tasks=("rgb", "normal", "depth_zbuffer"), random_flip=False)
    ds = tdata.make_component_dataset("replica", str(fake_dataset_root), **kw)
    jds = jdata.make_component_dataset("replica", str(fake_dataset_root), **kw)
    assert len(ds) == len(jds) == 6
    for i in range(6):
        _assert_items_equal(ds[i], jds[i])
    with pytest.raises(KeyError):
        tdata.make_component_dataset("nope", ".")
    rng = np.random.RandomState(0)
    n = rng.rand(3, 4, 4).astype(np.float32)
    R = np.linalg.qr(rng.randn(3, 3))[0]
    np.testing.assert_array_equal(tdata.normal_world_to_cam(n, R),
                                  jdata.normal_world_to_cam(n, R))


@pytest.fixture()
def hypersim_root(tmp_path):
    """tests/test_components.py:24's hypersim layout: one camera of a scene,
    two 48x64 frames (rgb, world-frame normals, depth, NYU40 semantics in
    HDF5), camera keyframes and the intrinsics CSV."""
    import h5py
    from PIL import Image

    building = "ai_001_001-cam_00"
    b = tmp_path / building
    for task in ("rgb", "normal", "depth_zbuffer", "semantic"):
        (b / task).mkdir(parents=True)
    H, W = 48, 64
    rng = np.random.RandomState(0)
    n_world = np.array([0.6, 0.0, 0.8])
    normal_png = np.zeros((H, W, 3), np.uint8)
    normal_png[...] = np.round((n_world + 1) / 2 * 255).astype(np.uint8)
    sem = np.full((H, W), -1, np.int16)
    sem[:, : W // 2] = 1
    sem[:, W // 2:] = 2
    for frame in (0, 1):
        name = f"point_{frame}_view_0_domain"
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            b / "rgb" / f"{name}_rgb.png")
        Image.fromarray(normal_png).save(b / "normal" / f"{name}_normal.png")
        Image.fromarray((rng.rand(H, W) * 60000).astype(np.uint16)).save(
            b / "depth_zbuffer" / f"{name}_depth_zbuffer.png")
        with h5py.File(b / "semantic" / f"{name}_semantic.hdf5", "w") as f:
            f["dataset"] = sem
    meta = tmp_path / "_hypersim_meta"
    kf = meta / "camera_keyframe" / building
    kf.mkdir(parents=True)
    c, s = np.cos([0.3, 1.2]), np.sin([0.3, 1.2])
    orientations = np.stack([[[c[i], -s[i], 0], [s[i], c[i], 0], [0, 0, 1]]
                             for i in range(2)])
    with h5py.File(kf / "camera_keyframe_positions.hdf5", "w") as f:
        f["dataset"] = np.stack([[10.0, 0.0, 5.0], [0.0, 20.0, 5.0]])
    with h5py.File(kf / "camera_keyframe_orientations.hdf5", "w") as f:
        f["dataset"] = orientations
    cols = ["scene_name", "settings_output_img_width",
            "settings_output_img_height", "settings_units_info_meters_scale"]
    vals = ["ai_001_001", str(W), str(H), "0.02"]
    for i in range(4):
        for j in range(4):
            cols.append(f"M_proj_{i}{j}")
            vals.append(str(np.diag([1.5, 2.0, -1.0, 1.0])[i, j]))
    for i in range(3):
        for j in range(3):
            cols.append(f"M_cam_from_uv_{i}{j}")
            vals.append(str(np.diag([0.9, 1.1, 1.0])[i, j]))
    (meta / "metadata_camera_parameters.csv").write_text(
        ",".join(cols) + "\n" + ",".join(vals) + "\n")
    return tmp_path


HYPERSIM_TASKS = ("rgb", "normal", "depth_zbuffer", "semantic")


def test_hypersim_dataset_matches_jax(hypersim_root, tmp_path):
    """tests/test_components.py:88 and :126: square random crop of the 4:3
    frames, world->camera normals, the NYU40 remap, pose tensors; packed
    (the dynamic subclass mixin) equal to direct and to JAX's."""
    kw = dict(tasks=HYPERSIM_TASKS, image_size=32, random_flip=True)
    ds = tdata.make_component_dataset("hypersim", str(hypersim_root), **kw)
    jds = jdata.make_component_dataset("hypersim", str(hypersim_root), **kw)
    assert isinstance(ds, thyp.HypersimDataset) and len(ds) == len(jds) == 2
    pds = tpc.PackedDataset.build(ds, str(tmp_path / "pack"), num_workers=2)
    assert isinstance(pds, tpc.PackedDataset) and isinstance(pds, thyp.HypersimDataset)
    for i in range(2):
        a = _seeded(ds, 11 + i)[i]
        assert a["rgb"].shape == (3, 32, 32) and a["semantic"].shape == (32, 32)
        assert set(np.unique(a["semantic"])) <= {0, thyp.CLASS_LABEL_TRANSFORM[1],
                                                 thyp.CLASS_LABEL_TRANSFORM[2]}
        _assert_items_equal(a, _seeded(jds, 11 + i)[i])
        _assert_items_equal(a, _seeded(pds, 11 + i)[i])


def test_hypersim_metadata_and_pose_match_jax(hypersim_root):
    """tests/test_components.py:185: the CSV, keyframes and the pose chain."""
    meta = str(hypersim_root / "_hypersim_meta")
    csv = os.path.join(meta, "metadata_camera_parameters.csv")
    got, want = thyp.load_scene_metadata(csv), jhyp.load_scene_metadata(csv)
    assert got.keys() == want.keys()
    for k in want["ai_001_001"]:
        np.testing.assert_array_equal(got["ai_001_001"][k], want["ai_001_001"][k])
    pos, ori = thyp.load_camera_keyframes(meta, "ai_001_001-cam_00")
    jpos, jori = jhyp.load_camera_keyframes(meta, "ai_001_001-cam_00")
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(ori, jori)
    for frame in (0, 1):
        a = thyp.hypersim_pose(pos, ori, got["ai_001_001"], frame)
        b = jhyp.hypersim_pose(jpos, jori, want["ai_001_001"], frame)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    pose = thyp.hypersim_pose(np.zeros((1, 3)), np.eye(3)[None], {
        "meters_per_asset_unit": 1.0, "M_proj": np.diag([1.0, 1.0, -1.0, 1.0]),
        "M_cam_from_uv": np.eye(3)}, 0)
    assert abs(pose["proj_K"][0, 0]) == pytest.approx((4 / 3) ** 2)
    assert abs(pose["proj_K_inv"][0, 0]) == pytest.approx(0.75)


def test_semantic_labels_flip_with_images_as_jax(tmp_path):
    """tests/test_components.py:152: dense labels from HDF5 mirror with the
    rgb under the joint flip; 20 seeded draws equal JAX's."""
    import h5py
    from PIL import Image

    b = tmp_path / "b"
    for t in ("rgb", "semantic"):
        (b / t).mkdir(parents=True)
    rgb = np.zeros((16, 16, 3), np.uint8)
    rgb[:, :8] = 255
    Image.fromarray(rgb).save(b / "rgb" / "point_0_view_0_domain_rgb.png")
    sem = np.zeros((16, 16), np.int16)
    sem[:, :8] = 7
    with h5py.File(b / "semantic" / "point_0_view_0_domain_semantic.hdf5", "w") as f:
        f["dataset"] = sem
    opts = dict(data_path=str(tmp_path), tasks=("rgb", "semantic"),
                random_flip=True, seed=0)
    ds, jds = tdata.OmnidataDataset(tdata.Options(**opts)), jdata.OmnidataDataset(
        jdata.Options(**opts))
    flips = set()
    for _ in range(20):
        a, w = ds[0], jds[0]
        _assert_items_equal(a, w)
        assert (a["rgb"][0, 0, 0] > 0.5) == (a["semantic"][0, 0] == 7)
        flips.add(bool(a["rgb"][0, 0, 0] > 0.5))
    assert flips == {True, False}


def test_hdf5_readers_name_h5py_when_it_is_missing(hypersim_root, tmp_path, monkeypatch):
    """The card's machine has no h5py: the keyframe reader and the scene
    metadata files raise an ImportError that names it."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        thyp.load_camera_keyframes(str(hypersim_root / "_hypersim_meta"),
                                   "ai_001_001-cam_00")
    b = tdata.BuildingMetadata.from_point_info(_toy_point_infos())
    with pytest.raises(ImportError, match="h5py"):
        b.save_hdf5(str(tmp_path / "b.hdf5"))
    with pytest.raises(ImportError, match="h5py"):
        tdata.BuildingMultiviewMetadata.load_hdf5(str(tmp_path / "mv.hdf5"))


# ---------------- scene metadata and instance helpers ----------------

def _toy_point_infos():
    def mk(p, v, loc, nonfix):
        return {"point_uuid": str(p), "view_id": v, "camera_location": loc,
                "nonfixated_points_in_view": nonfix}

    return [
        [mk(0, 0, [0, 0, 1], [1]), mk(0, 1, [1, 0, 1], [1, 2])],
        [mk(1, 0, [0, 0, 1], [0]), mk(1, 1, [5, 5, 1], [])],
        [mk(2, 0, [2, 2, 1], [0, 1]), mk(2, 1, [2, 2, 1.00005], [2])],
    ]


def _same_building(a, b):
    assert a.points == b.points and a.views == b.views
    np.testing.assert_array_equal(a.camera_idx, b.camera_idx)
    np.testing.assert_array_equal(a.camera_locations, b.camera_locations)


def test_building_metadata_matches_jax(tmp_path):
    """tests/test_data_augment.py:409: camera dedup (within atol across grid
    cells) and the HDF5 round trip, files read by the other package."""
    infos = _toy_point_infos()
    b, jb = (m.BuildingMetadata.from_point_info(infos) for m in (tdata, jdata))
    _same_building(b, jb)
    assert b.camera_locations.shape[0] == 4
    b.save_hdf5(str(tmp_path / "t.hdf5"))
    jb.save_hdf5(str(tmp_path / "j.hdf5"))
    _same_building(tdata.BuildingMetadata.load_hdf5(str(tmp_path / "j.hdf5")), jb)
    _same_building(jdata.BuildingMetadata.load_hdf5(str(tmp_path / "t.hdf5")), b)


def test_multiview_metadata_and_samplers_match_jax(tmp_path):
    """tests/test_data_augment.py:422 and :502: visibility from point_info
    and from fragments, the HDF5 round trip, and both samplers' positives
    (seeded draws, hops, camera KNN, backoff) equal to JAX's."""
    infos = _toy_point_infos()
    mv, jmv = (m.BuildingMultiviewMetadata.from_point_info(infos) for m in (tdata, jdata))
    assert mv.visible == jmv.visible
    mv.save_hdf5(str(tmp_path / "mv.hdf5"))
    assert jdata.BuildingMultiviewMetadata.load_hdf5(str(tmp_path / "mv.hdf5")).visible == mv.visible
    b, jb = (m.BuildingMetadata.from_point_info(infos) for m in (tdata, jdata))
    for knn in (None, 1, 3):
        s = tdata.CenterVisibleMultiviewSampler(b, mv, knn_cameras=knn)
        js = jdata.CenterVisibleMultiviewSampler(jb, jmv, knn_cameras=knn)
        for point, view in (("1", 0), ("0", 1), ("2", 1)):
            for n, hops in ((2, 1), (4, 1), (3, 2), (8, 2)):
                got = s.positives(point, view, n, hops=hops, rng=np.random.RandomState(n))
                assert got == js.positives(point, view, n, hops=hops,
                                           rng=np.random.RandomState(n))
                assert len(got) == n
    faces = np.random.RandomState(0).randint(-1, 40, (4, 16, 16))
    frag = {("0", 0): faces[0], ("0", 1): faces[1], ("1", 0): faces[2],
            ("1", 1): np.full((16, 16), 100)}
    f2p = np.random.RandomState(1).randint(-1, 5, 101)
    assert (tdata.BuildingMultiviewMetadata.from_fragments(frag, f2p).visible
            == jdata.BuildingMultiviewMetadata.from_fragments(frag, f2p).visible)
    for prop in (0.1, 0.25, 0.9):
        s = tdata.OverlapMultiviewSampler(frag, min_overlap_prop=prop, max_views=2)
        js = jdata.OverlapMultiviewSampler(frag, min_overlap_prop=prop, max_views=2)
        assert s.overlap == js.overlap
        for key in frag:
            assert s.positives(*key, 3) == js.positives(*key, 3)


def test_segment_instance_helpers_match_jax():
    """tests/test_data_augment.py:459 on both packages."""
    labels = np.random.RandomState(0).randint(0, 6, (12, 10)).astype(np.int32)
    ids, masks = tdata.extract_instance_masks(labels)
    jids, jmasks = jdata.extract_instance_masks(labels)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(masks, jmasks)
    empty = tdata.extract_instance_masks(np.zeros((3, 3), np.int32))
    assert empty[1].shape == (0, 3, 3)
    np.testing.assert_array_equal(tdata.masks_to_bboxes(masks), jdata.masks_to_bboxes(jmasks))
    for n, seed, bright in ((5, 0, True), (9, 3, False)):
        np.testing.assert_array_equal(tdata.random_colors(n, seed, bright),
                                      jdata.random_colors(n, seed, bright))
    face_ids = np.array([[0, 1, 7], [2, -1, 3]])
    f2i = np.array([7, 7, 8, 9])
    np.testing.assert_array_equal(tdata.fragments_to_instances(face_ids, f2i),
                                  jdata.fragments_to_instances(face_ids, f2i))
    rgb = np.random.RandomState(2).randint(0, 256, (12, 10, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tdata.overlay_instances(rgb, labels, 0.3),
                                  jdata.overlay_instances(rgb, labels, 0.3))
