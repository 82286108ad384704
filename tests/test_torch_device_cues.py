"""The host cues' device prefixes of the port (omnidata_tpu_torch.cues.
{narf_device,seg_device}) and the CLI's device-prefix route, against the
JAX package on the CPU, from the same numpy inputs:

- ``narf_border_maps`` on tests/test_cues.py:406's step depth and on a
  two-view batch with a focal per view: the same level count, shadow codes
  equal, change within 2e-3 of the [0, 1] score, direction aligned (5th
  percentile of the sign-folded dot > 0.95);
- the keypoints3d PNG from the port's maps against the one from JAX's maps
  (tests/test_cues.py:440's contract: atol 0.2 on the interest, correlation
  > 0.8);
- ``seg2d_blur_maps`` and ``seg25d_channel_maps`` on tests/test_cues.py:461
  and :494's inputs: codes within 1 of JAX's (the port sums the separable
  taps in order, XLA's convolution in its own order, so a code can round
  the other way), and equal dequantisers;
- the CLI on tests/test_train.py:865's mini scene: the port with
  ``--device cpu`` and FORCE_BATCHED_PATH=1 against the JAX CLI with
  FORCE_BATCHED_PATH=1 (device labels within the integer-label rule,
  keypoints3d within the hybrid tolerance, segmentation ARI > 0.85), its
  keypoints3d equal bit for bit to the maps recomputed from its written
  depth; without the flag its host cues equal the JAX host path's on the
  same PNGs.
"""
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.annotator import cli as jcli
from omnidata_tpu.annotator.settings import load_settings as j_load_settings
from omnidata_tpu.cues import keypoints3d as jkp
from omnidata_tpu.cues import narf_device as jnd
from omnidata_tpu.cues import seg_device as jsd
from omnidata_tpu_torch.annotator import cli as tcli
from omnidata_tpu_torch.annotator.settings import load_settings as t_load_settings
from omnidata_tpu_torch.cues import keypoints3d as tkp
from omnidata_tpu_torch.cues import narf_device as tnd
from omnidata_tpu_torch.cues import seg_device as tsd
from omnidata_tpu_torch.cues.encode import load_png
from omnidata_tpu_torch.sampling import load_point_info

from _torch_port_util import int_label_ok

torch.set_num_threads(1)

HOST_CUES = ("keypoints3d", "segment_unsup2d", "segment_unsup25d")
CLI_TASKS = ["rgb", "normal", "depth_zbuffer", "edge_occlusion", "mask_valid"]
POINTS = ["NUM_POINTS=2", "RESOLUTION=64", "MIN_CAMERA_SPACING=2.0",
          "MAX_VIEWS_PER_POINT=2", "MIN_NONFIXATED_AFTER_PRUNE=0"]


def _adjusted_rand(a, b):
    from test_golden_labels import _adjusted_rand as ari

    return ari(a, b)


def _step_depth():
    H = W = 48
    depth = np.full((H, W), 3.0, np.float32)
    depth[20:, 24:] = 1.5
    depth[5:15, 5:15] = 2.2
    return depth[None], np.array([40.0], np.float32)


def _two_views():
    """Two 64² views with slanted planes, a box and noise, one focal each."""
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    a = 2.0 + 0.02 * xx + 0.3 * rng.rand(64, 64).astype(np.float32) * 0.01
    a[30:50, 10:40] = 1.2
    b = 4.0 - 0.03 * yy
    b[:10, :12] = 0.0  # no hit
    b[40:, 40:] = 2.5
    return np.stack([a, b]).astype(np.float32), np.array([40.0, 55.0], np.float32)


@pytest.fixture(scope="module", params=["step", "two_views"])
def narf_maps(request):
    """(depth, focal, port maps, JAX's jitted maps) at max_levels_for(H, W)
    levels."""
    depth, focal = _step_depth() if request.param == "step" else _two_views()
    n = tnd.max_levels_for(*depth.shape[1:])
    assert n == jnd.max_levels_for(*depth.shape[1:])
    got = tnd.narf_border_maps(torch.from_numpy(depth), torch.from_numpy(focal), n)
    want = jax.device_get(jnd.narf_border_maps(jnp.asarray(depth),
                                               jnp.asarray(focal), n))
    return depth, focal, [tuple(m.numpy() for m in lvl) for lvl in got], want


def test_level_rules_match_jax():
    for focal, H, W in ((40.0, 48, 48), (443.4, 512, 512), (20.0, 64, 32)):
        assert tnd.n_levels_for(focal, H, W) == jnd.n_levels_for(focal, H, W)
        assert tnd.max_levels_for(H, W) == jnd.max_levels_for(H, W)


def test_narf_level_equals_jax_op_by_op():
    """JAX's border extraction evaluated op by op (jit off) rounds every
    float32 operation as the port does: level 0 of the step depth, every
    code equal; the min-range pooling to level 1 equal too."""
    depth, focal = _step_depth()
    tl = tnd._level0(torch.from_numpy(depth), torch.from_numpy(focal), 128.0)
    jl = jnd._level0(jnp.asarray(depth), jnp.asarray(focal), 128.0)
    with jax.disable_jit():
        want = jax.device_get(jnd._quantize(*jnd._extract_borders(*jl)))
    got = tnd._quantize(*tnd._extract_borders(*tl))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(tnd._half(*tl), jax.device_get(jnd._half(*jl))):
        np.testing.assert_array_equal(g.numpy(), w)


def test_narf_border_maps_match_jax_program(narf_maps):
    """Against the jitted program the JAX CLI runs: shadow codes equal,
    change within 2e-3 of the [0, 1] score, and on level 0 the directions
    aligned up to sign where the change is strong (5th percentile of the
    folded dot > 0.95). XLA's fused program rounds E[nn^T] - mean mean^T
    otherwise (the normal covariance is exactly 0 on a plane op by op, a
    few ulps in the fusion), so on coarse levels the direction of a
    pixel beside a border, set by the sign alignment to that noise, is
    held by the op-by-op test and by the keypoints3d contract."""
    _, _, got, want = narf_maps
    assert len(got) == len(want)
    for li, ((ch, cd, sh), (wch, wcd, wsh)) in enumerate(zip(got, want)):
        assert ch.dtype == np.uint16 and cd.dtype == np.int8 and sh.dtype == np.uint8
        assert ch.shape == wch.shape and cd.shape == wcd.shape
        np.testing.assert_array_equal(sh, wsh)
        np.testing.assert_allclose(ch / 65535.0, wch / 65535.0, atol=2e-3)
        a, b = cd / 127.0, wcd.astype(np.float64) / 127.0
        strong = (np.linalg.norm(b, axis=-1) > 0.5) & (wch / 65535.0 > 0.05)
        if li == 0 and strong.any():
            dots = np.abs(np.sum(a * b, -1))[strong]
            assert np.percentile(dots, 5) > 0.95, np.percentile(dots, 5)


def test_border_maps_for_views_cut_to_each_views_levels(narf_maps):
    depth, focal, got, _ = narf_maps
    per_view = tnd.border_maps_for_views(depth, focal)
    want = jnd.border_maps_for_views(depth, focal)
    assert [len(v) for v in per_view] == [len(v) for v in want]
    for k, levels in enumerate(per_view):
        assert len(levels) == tnd.n_levels_for(float(focal[k]), *depth.shape[1:])
        for li, (ch, cd, sh) in enumerate(levels):
            np.testing.assert_array_equal(ch, got[li][0][k])
            np.testing.assert_array_equal(sh, want[k][li][2])


def test_keypoints3d_from_port_maps_match_jax_maps():
    """tests/test_cues.py:440's contract on its inputs: the keypoints3d PNG
    from the port's border maps against the one from the JAX program's
    maps, and against the port's own native path: interest within 0.2,
    correlation > 0.8."""
    H = W = 48
    depth = np.full((H, W), 3.0, np.float32)
    depth[20:, 24:] = 1.5
    code = np.round(depth / (128.0 / 65535.0)).astype(np.uint16)
    depth_m = code.astype(np.float32) * (128.0 / 65535.0)
    fov = 2.0 * math.atan(W / (2.0 * 40.0))
    f_px = W / (2.0 * math.tan(fov / 2.0))
    port_maps = tnd.border_maps_for_views(depth_m[None], [f_px])[0]
    jax_maps = jnd.border_maps_for_views(depth_m[None], np.array([f_px]))[0]
    got = tkp.keypoints3d_from_depth_code(code, fov, W, support_size=0.5,
                                          border_maps=port_maps)
    want = jkp.keypoints3d_from_depth_code(code, fov, W, support_size=0.5,
                                           border_maps=jax_maps)
    native = tkp.keypoints3d_from_depth_code(code, fov, W, support_size=0.5)
    assert got.dtype == np.uint16 and got.shape == want.shape == (H, W)
    g = got / 65536.0
    assert g.max() > 0.05
    for other in (want, native):
        o = other / 65536.0
        np.testing.assert_allclose(g, o, atol=0.2)
        assert np.corrcoef(g.ravel(), o.ravel())[0, 1] > 0.8


def _within_one(got, want):
    """Codes equal or within 1 (f32 summation order); -> share that differ."""
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()
    return float((d > 0).mean())


def test_seg2d_blur_maps_match_jax():
    rng = np.random.RandomState(3)
    img = (rng.rand(2, 48, 40, 3) * 40).astype(np.uint8)
    img[:, 12:30, 8:24] += 120
    img[1, 34:, 28:] += 180
    for sigma in (3.0, 0.8):
        got = tsd.seg2d_blur_maps(torch.from_numpy(img), sigma=sigma).numpy()
        want = np.asarray(jsd.seg2d_blur_maps(jnp.asarray(img), sigma=sigma))
        assert _within_one(got, want) < 0.01
        np.testing.assert_array_equal(tsd.seg2d_blurred_from_maps(got[0]),
                                      jsd.seg2d_blurred_from_maps(got[0]))


def test_seg25d_channel_maps_match_jax():
    rng = np.random.RandomState(7)
    H, W = 48, 40
    depth = np.full((2, H, W), int(3.0 * 512), np.uint16)
    depth[:, 20:, 24:] = int(1.2 * 512)
    depth[0, :4, :6] = 65535  # invalid pixels exercise the mask
    depth[1] = (rng.rand(H, W) * 4000 + 200).astype(np.uint16)
    normal = (rng.rand(2, H, W, 3) * 255).astype(np.uint8)
    normal[:, 20:, 24:] //= 3
    edge = (rng.rand(2, H, W) * 5000).astype(np.uint16)
    got = tsd.seg25d_channel_maps(torch.from_numpy(depth), torch.from_numpy(normal),
                                  torch.from_numpy(edge)).numpy()
    want = np.asarray(jsd.seg25d_channel_maps(
        jnp.asarray(depth), jnp.asarray(normal), jnp.asarray(edge)))
    assert got.shape == (2, H, W, 5)
    assert _within_one(got, want) < 0.01
    np.testing.assert_array_equal(got[..., 4], want[..., 4])  # no blur: equal
    assert tsd.SEG25D_QSCALES == jsd.SEG25D_QSCALES
    np.testing.assert_array_equal(tsd.seg25d_input_from_maps(got[1], 2.0, 1.0, 10.0),
                                  jsd.seg25d_input_from_maps(got[1], 2.0, 1.0, 10.0))


def _mini_scene(d):
    """tests/test_train.py:25's scene: an 8 m room and a cube, random uchar
    vertex colours, as mesh.ply."""
    from omnidata_tpu_torch.mesh.mesh import cube, room
    from omnidata_tpu_torch.utils.convert_mesh import write_ply

    r = room(size=8.0, height=3.0)
    c = cube(size=1.0, center=(1.5, 0.5, 0.5))
    v = np.concatenate([r.vertices.numpy(), c.vertices.numpy()])
    f = np.concatenate([r.faces[: r.num_faces].numpy(),
                        c.faces[: c.num_faces].numpy() + r.vertices.shape[0]])
    col = (np.random.RandomState(0).rand(len(v), 3) * 255).astype(np.uint8) / 255.0
    os.makedirs(d)
    write_ply(os.path.join(d, "mesh.ply"), v, f, vertex_colors=col)
    return d


def _view_file(d, view, task):
    return os.path.join(d, task, f"point_{view['point_uuid']}_view_"
                                 f"{view['view_id']}_domain_{task}.png")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The mini scene's points from the JAX CLI, then the device tasks with
    the three host cues overlapped: JAX with FORCE_BATCHED_PATH=1, the port
    on the CPU with it and without it (host cues in threads, one core).
    -> {name: dir}, the views, the port's pool inputs per view."""
    base = tmp_path_factory.mktemp("device_cues")
    src = _mini_scene(str(base / "src"))
    jcli.main(["--model_path", src, "--task", "points", "with", *POINTS])
    dirs = {}
    for name in ("jax", "port", "port_host"):
        d = str(base / name)
        shutil.copytree(src, d)
        dirs[name] = d
    mp = pytest.MonkeyPatch()
    mp.setattr(os, "cpu_count", lambda: 1)
    pool_inputs = []
    job = tcli._host_cue_job

    def recording_job(model_path, view, tasks, kv, arrs, dev_maps=None):
        pool_inputs.append((model_path, sorted(arrs), sorted(dev_maps or {})))
        return job(model_path, view, tasks, kv, arrs, dev_maps)

    mp.setattr(tcli, "_host_cue_job", recording_job)
    try:
        jcli.run_device_tasks(dirs["jax"], CLI_TASKS, j_load_settings(
            ["RESOLUTION=64", "FORCE_BATCHED_PATH=1", "VIEWS_PER_DISPATCH=4"]),
            host_tasks=HOST_CUES)
        tcli.run_device_tasks(dirs["port"], CLI_TASKS, t_load_settings(
            ["RESOLUTION=64", "FORCE_BATCHED_PATH=1", "VIEWS_PER_DISPATCH=4"]),
            host_tasks=HOST_CUES, device="cpu")
        tcli.run_device_tasks(dirs["port_host"], CLI_TASKS, t_load_settings(
            ["RESOLUTION=64", "VIEWS_PER_DISPATCH=4"]),
            host_tasks=HOST_CUES, device="cpu")
    finally:
        mp.undo()
    views = [v for vs in load_point_info(src) for v in vs]
    assert len(views) >= 2
    return dirs, views, pool_inputs


def test_route_follows_device_and_flag():
    s0, s1 = t_load_settings([]), t_load_settings(["FORCE_BATCHED_PATH=1"])
    mods = tuple(CLI_TASKS)
    on = {"narf": True, "seg2d": True, "seg25d": True}
    assert tcli.device_prefixes(HOST_CUES, mods, s0, "cuda") == on
    assert tcli.device_prefixes(HOST_CUES, mods, s1, "cpu") == on
    assert not any(tcli.device_prefixes(HOST_CUES, mods, s0, "cpu").values())
    assert not any(tcli.device_prefixes(("keypoints3d",), ("rgb", "normal"), s0,
                                        "cuda").values())


def test_pool_gets_device_maps_and_no_unused_planes(cli_runs):
    """With the 2.5D channel maps the pool gets no normal or edge planes
    (JAX cli.py:373-376); without the route it gets every plane and no maps."""
    dirs, views, pool_inputs = cli_runs
    routed = [p for p in pool_inputs if p[0] == dirs["port"]]
    host = [p for p in pool_inputs if p[0] == dirs["port_host"]]
    assert len(routed) == len(host) == len(views)
    for _, arrs, maps in routed:
        assert arrs == ["depth_zbuffer", "rgb"]
        assert maps == ["narf", "seg25d_q", "seg2d_q"]
    for _, arrs, maps in host:
        assert arrs == ["depth_zbuffer", "edge_occlusion", "normal", "rgb"]
        assert maps == []


def test_cli_device_labels_match_jax_batched_cli(cli_runs):
    dirs, views, _ = cli_runs
    for view in views:
        for t in CLI_TASKS:
            g = load_png(_view_file(dirs["port"], view, t))
            w = load_png(_view_file(dirs["jax"], view, t))
            assert g.shape == w.shape and g.dtype == w.dtype
            ok, dmax, frac = int_label_ok(g, w)
            assert ok, (t, dmax, frac)


def test_cli_keypoints3d_is_the_device_prefix_route(cli_runs):
    """The port's keypoints3d equals, bit for bit, the interest stage on
    the border maps recomputed from its written depth with the CLI's focal
    recipe (``narf_device.focal_px``), and stays within the hybrid
    tolerance of the JAX batched CLI's: correlation > 0.8 (tests/test_train
    .py:948 asks 0.7 of hybrid against native), interest within 0.2 on 99%
    of pixels. The JAX program's fused rounding turns exactly-zero normal
    covariances into noise that steers some coarse-level directions (see
    test_narf_border_maps_match_jax_program); on this scene three of four
    views come out bit for bit equal, one at correlation 0.91."""
    dirs, views, _ = cli_runs
    n_lvl = tnd.max_levels_for(64, 64)
    for view in views:
        code = load_png(_view_file(dirs["port"], view, "depth_zbuffer"))
        depth_m = code.astype(np.float32) * (128.0 / 65535.0)
        fov = view["field_of_view_rads"]
        maps = tnd.narf_border_maps(
            torch.from_numpy(depth_m[None]),
            tnd.focal_px(torch.tensor([fov], dtype=torch.float32), 64), n_lvl)
        f_px = 64 / (2.0 * math.tan(fov / 2.0))
        S = min(n_lvl, tnd.n_levels_for(f_px, 64, 64))
        vm = [tuple(m[0].numpy() for m in lvl) for lvl in maps[:S]]
        hyb = tkp.narf_interest_with_maps(depth_m, f_px, vm, support_size=0.3)
        a = load_png(_view_file(dirs["port"], view, "keypoints3d"))
        np.testing.assert_array_equal(
            a, np.clip(hyb * 65536.0, 0, 65535).astype(np.uint16))
        b = load_png(_view_file(dirs["jax"], view, "keypoints3d"))
        assert (np.abs(a / 65536.0 - b / 65536.0) > 0.2).mean() < 0.01
        if a.std() > 0 and b.std() > 0:
            assert np.corrcoef(a.ravel().astype(np.float64),
                               b.ravel().astype(np.float64))[0, 1] > 0.8


def test_cli_segmentation_matches_jax_batched_cli(cli_runs):
    dirs, views, _ = cli_runs
    for view in views:
        for t in ("segment_unsup2d", "segment_unsup25d"):
            a = load_png(_view_file(dirs["port"], view, t))
            b = load_png(_view_file(dirs["jax"], view, t))
            assert a.shape == b.shape == (64, 64)
            if len(np.unique(a)) == 1 and len(np.unique(b)) == 1:
                continue  # both single-label: agreement, ARI undefined
            assert _adjusted_rand(a, b) > 0.85, (t, view["view_id"])


def test_cli_host_route_equals_jax_host_path(cli_runs, tmp_path):
    """Without FORCE_BATCHED_PATH on the CPU the port's host cues are the
    JAX host path's (host_cues_for_view without maps) on the same PNGs."""
    dirs, views, _ = cli_runs
    wdir = str(tmp_path / "jax_host")
    for t in HOST_CUES:
        os.makedirs(os.path.join(wdir, t))
    js = j_load_settings(["RESOLUTION=64"])
    for view in views:
        jcli.host_cues_for_view(
            wdir, view, HOST_CUES, js,
            lambda task, v=view: load_png(_view_file(dirs["port_host"], v, task)))
        for t in HOST_CUES:
            np.testing.assert_array_equal(
                load_png(_view_file(dirs["port_host"], view, t)),
                load_png(_view_file(wdir, view, t)))
