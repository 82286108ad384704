"""The port's annotator CLI (omnidata_tpu_torch.annotator.cli, --device cpu)
against the JAX package's CLI, on room(size=4.0, height=2.5) with random
vertex colours written as mesh.ply, at RESOLUTION=64:

- `--task points`: the same point_info file names, camera_poses.json and
  JSON within 1e-5 (integers, booleans and strings equal);
- the 12 device tasks on one shared copy of point_info (both sides on the
  batched path, FORCE_BATCHED_PATH=1, once per module): every PNG and
  fragments .npy within the integer-label rule of tests/test_mesh.py;
- `--task pano` at PANO_RESOLUTION=(64,32): tests/test_sampling.py's
  panorama checks, and every domain within the integer-label rule of JAX's;
- the host cues from the same input PNGs: equal to JAX's;
- the trajectory, object mode (SCENE=False on a cube) and `--task all`,
  which writes the reference layout.
"""
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import omnidata_tpu.annotator.cli as jcli
from omnidata_tpu.annotator.settings import load_settings as j_load_settings
from omnidata_tpu.cues.vanishing import vanishing_points
from omnidata_tpu_torch.annotator import cli as tcli
from omnidata_tpu_torch.annotator.settings import load_settings as t_load_settings
from omnidata_tpu_torch.mesh.mesh import cube, room
from omnidata_tpu_torch.sampling import load_point_info
from omnidata_tpu_torch.utils.convert_mesh import write_obj, write_ply

from _torch_port_util import assert_same_tree, int_label_ok

torch.set_num_threads(1)

POINTS = ["NUM_POINTS=3", "RESOLUTION=64", "MIN_CAMERA_SPACING=1.0",
          "MIN_VIEWS_PER_POINT=2", "MAX_VIEWS_PER_POINT=4",
          "MIN_NONFIXATED_AFTER_PRUNE=0"]
DEVICE_TASKS = sorted(tcli.DEVICE_TASKS)
HOST_CUES = ["keypoints3d", "segment_unsup2d", "segment_unsup25d"]


def _room_dir(d):
    r = room(size=4.0, height=2.5)
    v, f = r.vertices.numpy(), r.faces[: r.num_faces].numpy()
    colors = np.random.RandomState(0).rand(v.shape[0], 3)
    os.makedirs(d, exist_ok=True)
    write_ply(os.path.join(d, "mesh.ply"), v, f, vertex_colors=colors)
    return d


def _t_main(d, task, *overrides):
    tcli.main(["--model_path", d, "--task", task, "--device", "cpu",
               "with", *overrides])


def _j_main(d, task, *overrides):
    jcli.main(["--model_path", d, "--task", task, "with", *overrides])


def _point_info(d):
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "point_info", "*.json"))):
        with open(p) as fh:
            out[os.path.basename(p)] = json.load(fh)
    return out


def _load(path):
    if path.endswith(".npy"):
        return np.load(path)
    a = np.asarray(Image.open(path))
    return a.astype(np.uint16) if a.dtype == np.int32 else a


def _assert_outputs_match(tdir, jdir, tasks, pattern="*"):
    """Every file of each task directory: the same names, and arrays of the
    same shape and dtype within the integer-label rule. -> files compared."""
    n = 0
    for t in tasks:
        tnames = sorted(os.listdir(os.path.join(tdir, t)))
        jnames = sorted(os.listdir(os.path.join(jdir, t)))
        assert tnames == jnames, t
        for name in glob.fnmatch.filter(tnames, pattern):
            g = _load(os.path.join(tdir, t, name))
            w = _load(os.path.join(jdir, t, name))
            assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
            ok, dmax, frac = int_label_ok(g, w)
            assert ok, (name, dmax, frac)
            n += 1
    return n


@pytest.fixture(scope="module")
def points_run(tmp_path_factory):
    """`--task points` through both CLIs, each on its own copy of the room
    -> (port dir, JAX dir)."""
    base = tmp_path_factory.mktemp("points")
    tdir = _room_dir(str(base / "port"))
    jdir = _room_dir(str(base / "jax"))
    _t_main(tdir, "points", *POINTS)
    _j_main(jdir, "points", *POINTS)
    return tdir, jdir


def test_points_match_jax(points_run):
    tdir, jdir = points_run
    got, want = _point_info(tdir), _point_info(jdir)
    assert len(want) >= 4 and list(got) == list(want)
    assert_same_tree(got, want)
    with open(os.path.join(tdir, "camera_poses.json")) as ft, \
            open(os.path.join(jdir, "camera_poses.json")) as fj:
        assert_same_tree(json.load(ft), json.load(fj))


@pytest.fixture(scope="module")
def device_run(points_run, tmp_path_factory):
    """The 12 device tasks through both run_device_tasks, on one shared
    copy of the JAX run's point_info -> (port dir, JAX dir)."""
    base = tmp_path_factory.mktemp("device")
    dirs = []
    for name in ("port", "jax"):
        d = _room_dir(str(base / name))
        shutil.copytree(os.path.join(points_run[1], "point_info"),
                        os.path.join(d, "point_info"))
        dirs.append(d)
    tcli.run_device_tasks(dirs[0], DEVICE_TASKS, t_load_settings(
        ["RESOLUTION=64", "FORCE_BATCHED_PATH=1"]), device="cpu")
    jcli.run_device_tasks(dirs[1], DEVICE_TASKS, j_load_settings(
        ["RESOLUTION=64", "FORCE_BATCHED_PATH=1"]))
    return tuple(dirs)


def test_device_tasks_match_jax(device_run):
    tdir, jdir = device_run
    n_views = len(_point_info(tdir))
    assert _assert_outputs_match(tdir, jdir, DEVICE_TASKS) == 11 * n_views
    assert os.listdir(os.path.join(tdir, "semantic")) == []  # no face labels
    frag = np.load(glob.glob(os.path.join(tdir, "fragments", "*.npy"))[0])
    assert frag.shape == (64, 64) and frag.dtype == np.int32 and (frag >= 0).all()


def test_host_cues_match_jax_on_the_same_pngs(device_run, tmp_path):
    """keypoints3d / segment_unsup2d / segment_unsup25d of two views from the
    JAX run's PNGs: the port's pool path (two spawned workers) and the JAX
    host_cues_for_view give equal images; vanishing points equal JAX's."""
    jdir = device_run[1]
    tdir = str(tmp_path / "port")
    os.makedirs(tdir)
    views = [v for views in load_point_info(jdir) for v in views][:2]
    os.makedirs(os.path.join(tdir, "point_info"))
    for v in views:
        name = f"point_{v['point_uuid']}_view_{v['view_id']}_domain_fixatedpose.json"
        shutil.copy(os.path.join(jdir, "point_info", name),
                    os.path.join(tdir, "point_info", name))
        for t in ("depth_zbuffer", "rgb", "normal", "edge_occlusion"):
            name = f"point_{v['point_uuid']}_view_{v['view_id']}_domain_{t}.png"
            os.makedirs(os.path.join(tdir, t), exist_ok=True)
            shutil.copy(os.path.join(jdir, t, name), os.path.join(tdir, t, name))
    settings = t_load_settings(["RESOLUTION=64"])
    mp = pytest.MonkeyPatch()
    mp.setattr(os, "cpu_count", lambda: 2)
    try:
        tcli.run_host_tasks(tdir, HOST_CUES + ["vanishing_points"], settings)
    finally:
        mp.undo()
    assert os.environ.get("CUDA_VISIBLE_DEVICES") != ""  # restored
    wdir = str(tmp_path / "jax")
    js = j_load_settings(["RESOLUTION=64"])
    for v in views:
        for t in HOST_CUES:
            os.makedirs(os.path.join(wdir, t), exist_ok=True)

        def get(task, v=v):
            return _load(os.path.join(jdir, task, f"point_{v['point_uuid']}_view_"
                                                  f"{v['view_id']}_domain_{task}.png"))

        jcli.host_cues_for_view(wdir, v, tuple(HOST_CUES), js, get)
    for t in HOST_CUES:
        names = sorted(os.listdir(os.path.join(wdir, t)))
        assert names == sorted(os.listdir(os.path.join(tdir, t))) and len(names) == 2
        for name in names:
            np.testing.assert_array_equal(_load(os.path.join(tdir, t, name)),
                                          _load(os.path.join(wdir, t, name)))
    for v in load_point_info(tdir)[0]:
        img_vps, sphere_vps = vanishing_points(v, 64)
        assert_same_tree(v["vanishing_points_image"],
                         {k: list(map(float, xy)) for k, xy in zip("xyz", img_vps)})
        assert_same_tree(v["vanishing_points_gaussian_sphere"],
                         {k: list(map(float, p)) for k, p in zip("xyz", sphere_vps)})


def test_trajectory_matches_jax(points_run, tmp_path):
    dirs = []
    for name in ("port", "jax"):
        d = str(tmp_path / name)
        shutil.copytree(os.path.join(points_run[1], "point_info"),
                        os.path.join(d, "point_info"))
        dirs.append(d)
    tcli.run_trajectory(dirs[0], t_load_settings([]))
    jcli.run_trajectory(dirs[1], j_load_settings([]))
    got, want = _point_info(dirs[0]), _point_info(dirs[1])
    assert len(want) > len(_point_info(points_run[1]))
    assert list(got) == list(want)
    assert_same_tree(got, want)


def test_pano_room_matches_jax_and_physics(tmp_path):
    """tests/test_sampling.py's panorama checks on a 40 m x 24 m room: all
    four geometry domains, z == t for an equirectangular camera, every
    pixel valid, and the reshading of the pixel looking straight up as the
    point-lamp physics gives it; depth within the integer-label rule of
    JAX's."""
    r = room(size=40.0, height=24.0)
    dirs = []
    for name in ("port", "jax"):
        d = str(tmp_path / name)
        os.makedirs(d)
        write_ply(os.path.join(d, "mesh.ply"), r.vertices.numpy(),
                  r.faces[: r.num_faces].numpy())
        with open(os.path.join(d, "camera_poses.json"), "w") as fh:
            json.dump([{"camera_id": "0000", "location": [0.0, 0.0, 1.0]}], fh)
        dirs.append(d)
    _t_main(dirs[0], "pano", "PANO_RESOLUTION=(64,32)")
    _j_main(dirs[1], "pano", "PANO_RESOLUTION=(64,32)")

    def load(d, task):
        return _load(os.path.join(
            d, task, f"point_0000_view_equirectangular_domain_{task}.png"))

    de, dz, rs = (load(dirs[0], t) for t in ("depth_euclidean", "depth_zbuffer",
                                            "reshading"))
    assert de.shape == (32, 64) and de.dtype == np.uint16
    np.testing.assert_array_equal(dz, de)
    assert (de < 65535).all()
    assert rs.shape == (32, 64) and rs.dtype == np.uint8
    cos_up = np.cos(np.pi * 0.5 / 32)
    t_up = 23.0 / cos_up
    np.testing.assert_allclose(de[0, 0] / 512.0, t_up, atol=2e-3)
    assert abs(rs[0, 0] / 255.0 - 2.5 * 64.0 / (64.0 + t_up * t_up) * cos_up) < 2 / 255.0
    assert _assert_outputs_match(*dirs, ["depth_euclidean", "depth_zbuffer",
                                         "normal", "reshading"]) == 4


def test_pano_coloured_room_matches_jax(points_run, tmp_path):
    """Panoramas with rgb at the sampled cameras of the coloured room."""
    dirs = []
    for name in ("port", "jax"):
        d = _room_dir(str(tmp_path / name))
        shutil.copy(os.path.join(points_run[1], "camera_poses.json"), d)
        dirs.append(d)
    _t_main(dirs[0], "pano", "PANO_RESOLUTION=(64,32)")
    _j_main(dirs[1], "pano", "PANO_RESOLUTION=(64,32)")
    tasks = ["depth_euclidean", "depth_zbuffer", "normal", "reshading", "rgb"]
    with open(os.path.join(dirs[0], "camera_poses.json")) as fh:
        n_cams = len(json.load(fh))
    assert _assert_outputs_match(*dirs, tasks) == 5 * n_cams
    rgb = _load(glob.glob(os.path.join(dirs[0], "rgb", "*equirectangular*"))[0])
    assert rgb.shape == (32, 64, 3) and rgb.max() > 0


def test_object_mode_matches_jax(tmp_path):
    """SCENE=False on a cube (tests/test_sampling.py's object mode): the
    same views, and depth renders within the integer-label rule."""
    c = cube(size=1.0)
    dirs = []
    for name in ("port", "jax"):
        d = str(tmp_path / name)
        os.makedirs(d)
        write_obj(os.path.join(d, "mesh.obj"), c.vertices.numpy(),
                  c.faces[: c.num_faces].numpy())
        dirs.append(d)
    pts = ["SCENE=False", "NUM_POINTS=2", "RESOLUTION=64", "MIN_VIEWS_PER_POINT=2",
           "MAX_VIEWS_PER_POINT=4", "MIN_NONFIXATED_AFTER_PRUNE=0"]
    _t_main(dirs[0], "points", *pts)
    _j_main(dirs[1], "points", *pts)
    assert_same_tree(_point_info(dirs[0]), _point_info(dirs[1]))
    _t_main(dirs[0], "depth_zbuffer", "RESOLUTION=64", "FORCE_BATCHED_PATH=1")
    _j_main(dirs[1], "depth_zbuffer", "RESOLUTION=64", "FORCE_BATCHED_PATH=1")
    assert _assert_outputs_match(*dirs, ["depth_zbuffer"]) >= 2
    arr = _load(glob.glob(os.path.join(dirs[0], "depth_zbuffer", "*.png"))[0])
    assert (arr < 65535).any() and (arr == 65535).any()


def test_task_all_writes_the_reference_layout(tmp_path, monkeypatch):
    """`--task all --device cpu` on the coloured room, host cues in threads
    (a one-core host): point_info, camera_poses.json, one directory per
    image task, point_{p}_view_{v}_domain_{task}.png for every view."""
    d = _room_dir(str(tmp_path / "all"))
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    _t_main(d, "all", *POINTS)
    infos = _point_info(d)
    assert infos and os.path.exists(os.path.join(d, "camera_poses.json"))
    views = [(v["point_uuid"], v["view_id"]) for v in infos.values()]
    image_tasks = [t for t in tcli.TASKS_ALL if t not in (
        "points", "trajectory", "pano", "vanishing_points", "semantic", "fragments")]
    for t in image_tasks:
        want = sorted(f"point_{p}_view_{v}_domain_{t}.png" for p, v in views)
        assert sorted(os.listdir(os.path.join(d, t))) == want, t
    assert len(os.listdir(os.path.join(d, "fragments"))) == len(views)
    assert all("vanishing_points_image" in v for v in infos.values())


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--model_path", str(tmp_path), "--task", "points"])
