"""omnidata_tpu_torch.bench (the port's bench.py) and scenes.build_xl_scene
against the JAX package on the CPU, from the same seeds:

- ``build_xl_scene`` equals bench.py's xl assembly with the JAX package
  (1,423,360 faces): arrays, face order and curvature colours exactly;
- the bench's device pass on one K = 2 batch of the bench scene at 64²
  (bench.py's tile 32, chunk 128) against JAX's ``annotate_views`` with
  bench.py's keyword arguments (Pallas in interpret mode): every label
  within the integer-label rule of tests/test_mesh.py, the summed depth
  codes equal; full13's device maps of that batch, through the CLI's
  ``render_batches``, against JAX's ``narf_border_maps`` /
  ``seg2d_blur_maps`` / ``seg25d_channel_maps`` with bench.py's arguments
  on the same labels (shadow codes equal, the change score and directions
  as tests/test_torch_device_cues.py holds them, level 0's change score
  within what XLA's fusion reads, see the test; segmentation codes within 1
  on < 1% of pixels);
- ``_host_cues`` pickles and returns its three timings; ``main`` on the
  CPU route prints bench.py's headline keys; without a card the default
  route fails; the disk cache rebuilds the same mesh; the large-scene and
  full13 extras run end to end on the plain rasters at a reduced size;
  ``warm_pool`` starts every spawned worker; the share of peak names the
  TF32 peak while TF32 is on.
"""
import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from omnidata_tpu.annotator import annotate_views as j_annotate_views
from omnidata_tpu.cues import narf_device as jnd
from omnidata_tpu.cues import seg_device as jsd
from omnidata_tpu.cues.curvature import bake_curvature_colors as j_bake
from omnidata_tpu.mesh import mesh as jm
from omnidata_tpu_torch import bench, scenes
from omnidata_tpu_torch.annotator import DEVICE_MODALITIES, annotate_views
from omnidata_tpu_torch.annotator import cli
from omnidata_tpu_torch.cues import narf_device as tnd
from omnidata_tpu_torch.mesh import raster
from omnidata_tpu_torch.utils.flops import PEAK_FLOPS, model_flops

from _torch_port_util import MESH_FIELDS, both_cameras, int_label_ok, port_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RES = 64
KW = dict(tile=32, chunk=128)  # bench.py's card arguments (cap: JAX's only)
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "value_min",
                 "value_max", "config"}


def _jax_interior(n_spheres, n_boxes, n_lat, edge):
    """bench.py's scene assembly with the JAX package, seed 0 ->
    (mesh, curvature mesh)."""
    from omnidata_tpu.mesh import cube, room, uv_sphere

    rng = np.random.RandomState(0)
    parts = [room(size=10.0, height=3.2)]
    for _ in range(n_spheres):
        c = (rng.uniform(-3.5, 3.5), rng.uniform(-3.5, 3.5), rng.uniform(0.4, 1.2))
        parts.append(uv_sphere(radius=rng.uniform(0.25, 0.6), center=c,
                               n_lat=n_lat, n_lon=2 * n_lat))
    for _ in range(n_boxes):
        c = (rng.uniform(-4.0, 4.0), rng.uniform(-4.0, 4.0), rng.uniform(0.3, 1.0))
        parts.append(cube(size=rng.uniform(0.4, 1.2), center=c))
    v, f, colors = jbench._assemble(parts, rng, edge=edge)
    jmesh = jm.from_arrays(v, f, vertex_colors=colors)
    return jmesh, j_bake(jmesh, rings=1)


def _assert_same_mesh(tmesh, jmesh):
    assert tmesh.num_faces == jmesh.num_faces
    for k in MESH_FIELDS:
        j, t = getattr(jmesh, k), getattr(tmesh, k)
        assert (j is None) == (t is None), k
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=k)


def test_xl_scene_equal_jax():
    """scenes.build_xl_scene is bench.py's build_xl_scene (1,423,360 faces,
    11,122 chunks of 128): the same arrays, face order and curvature
    colours."""
    jmesh, jcurv = _jax_interior(10, 12, 128, 0.055)
    mesh, curv = scenes.build_xl_scene()
    assert mesh.num_faces == 1423360 and mesh.faces.shape[0] == 1423616
    assert mesh.faces.shape[0] // 128 == 11122 and mesh.faces.shape[0] < 2**24
    _assert_same_mesh(mesh, jmesh)
    np.testing.assert_array_equal(curv.vertex_colors.numpy(),
                                  np.asarray(jcurv.vertex_colors))


@pytest.fixture(scope="module")
def bench_batch():
    """The bench scene built by the JAX package and carried across, and
    the CPU route's batch (K = 2: rows 2, 3 of sample_cameras_np(4)) on both
    sides -> (JAX mesh, curv, cams; port mesh, curv, cams; fovs)."""
    jmesh, jcurv = _jax_interior(4, 5, 48, 0.8)
    locs, Rs, fovs = scenes.sample_cameras_np(4)
    jcam, tcam = both_cameras(locs[2:], Rs[2:], fovs[2:], RES)
    return jmesh, jcurv, jcam, port_mesh(jmesh), port_mesh(jcurv), tcam, fovs[2:]


def _full13_prefixes(settings):
    return cli.device_prefixes(cli.HOST_CUE_TASKS, DEVICE_MODALITIES, settings, "cpu")


@pytest.fixture(scope="module")
def device_pass(bench_batch):
    """The port's labels (the headline's annotate_views call), JAX's
    labels with bench.py's arguments, and full13's fetched batch (the CLI's
    ``render_batches`` under ``bench.full13_settings``)."""
    jmesh, jcurv, jcam, mesh, curv, tcam, _ = bench_batch
    want = j_annotate_views(jcam, jmesh, jcurv, cap=1024, interpret=True, **KW)
    got = annotate_views(tcam, mesh, curv, **KW)
    settings = bench.full13_settings(RES)
    assert all(_full13_prefixes(settings).values())
    fetched = list(cli.render_batches([tcam], mesh, curv, KW, bench.FULL13_NEEDED,
                                      settings, _full13_prefixes(settings)))
    assert len(fetched) == 1
    return got, {k: np.asarray(v) for k, v in want.items()}, fetched[0]


def test_device_pass_labels_match_jax(device_pass):
    got, want, d = device_pass
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        assert g.shape == want[k].shape and g.dtype == want[k].dtype, k
        ok, dmax, frac = int_label_ok(g, want[k])
        assert ok, (k, dmax, frac)
    assert got["mask_valid"].numpy().mean() > 200  # inside a closed room
    # the headline's data-dependent sum, both packages
    assert int(bench._depth_sum(got)) == int(jnp.sum(
        jnp.asarray(want["depth_zbuffer"]).astype(jnp.int32)))
    labels = d[0]
    assert set(labels) == set(bench.FULL13_NEEDED)
    for k in labels:
        np.testing.assert_array_equal(labels[k], got[k].numpy(), err_msg=k)


def test_full13_device_maps_match_jax(device_pass, bench_batch):
    """The maps of bench.py:478-489 from the same labels: JAX's on the
    port's depth, rgb, normal and edge codes. NARF: shadow codes equal;
    directions aligned up to sign where the change is strong (5th
    percentile of the folded dot > 0.95, on every level); the change score
    within 2e-3 of the [0, 1] score on levels 1 and up, as
    tests/test_torch_device_cues.py holds it against the jitted program.
    Level 0 of rendered depth is ill-conditioned at border pixels, where
    the normals' covariance is near zero: JAX evaluated op by op reads
    within 0.014 of the port there, and the jitted program, whose fusion
    rounds that covariance otherwise, moves 1.2% of this batch's level-0
    scores by up to 0.104 (coarser levels by at most 3.1e-5); so level 0
    holds 2e-3 on 98.5% of pixels and 0.12 everywhere."""
    _, _, (_, maps) = device_pass
    got = device_pass[0]
    fovs = bench_batch[-1]
    bmaps, seg2d_q, seg25d_q = maps["narf"], maps["seg2d_q"], maps["seg25d_q"]
    n_lvl = tnd.max_levels_for(RES, RES)
    depth = jnp.asarray(got["depth_zbuffer"].numpy())
    depth_m = depth.astype(jnp.float32) * (128.0 / 65535.0)
    # the port's focal (tnd.focal_px: float64, rounded once, so the card and
    # the CPU agree) is bench.py's float32 one within an ulp; an ulp moves
    # a border score by up to 0.1 on ~1% of pixels, so both get the port's
    focal = tnd.focal_px(torch.as_tensor(fovs), RES).numpy()
    np.testing.assert_allclose(focal, RES / (2.0 * jnp.tan(jnp.asarray(fovs) / 2.0)),
                               rtol=1.2e-7)
    jb = jnd.narf_border_maps(depth_m, jnp.asarray(focal), n_lvl, 128.0)
    assert len(bmaps) == len(jb) == n_lvl
    for li, ((ch, cd, sh), (wch, wcd, wsh)) in enumerate(zip(bmaps, jb)):
        wch, wcd = np.asarray(wch), np.asarray(wcd)
        assert ch.dtype == np.uint16 and cd.dtype == np.int8 and sh.dtype == np.uint8
        assert ch.shape == wch.shape and cd.shape == wcd.shape
        np.testing.assert_array_equal(sh, np.asarray(wsh))
        d = np.abs(ch / 65535.0 - wch / 65535.0)
        if li == 0:
            assert (d > 2e-3).mean() <= 0.015 and d.max() <= 0.12, ((d > 2e-3).mean(),
                                                                     d.max())
        else:
            assert d.max() <= 2e-3, (li, d.max())
        a, b = cd / 127.0, wcd.astype(np.float64) / 127.0
        strong = (np.linalg.norm(b, axis=-1) > 0.5) & (wch / 65535.0 > 0.05)
        assert strong.any(), li
        dots = np.abs(np.sum(a * b, -1))[strong]
        assert np.percentile(dots, 5) > 0.95, (li, np.percentile(dots, 5))
    want2d = np.asarray(jsd.seg2d_blur_maps(jnp.asarray(got["rgb"].numpy()), sigma=3.0))
    want25d = np.asarray(jsd.seg25d_channel_maps(
        depth, jnp.asarray(got["normal"].numpy()),
        jnp.asarray(got["edge_occlusion"].numpy())))
    for g, w in ((seg2d_q, want2d), (seg25d_q, want25d)):
        assert g.dtype == w.dtype and g.shape == w.shape
        diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_host_cues_pickle_and_time(device_pass, bench_batch):
    """One view of full13's fetched batch, cut by the CLI's view_cue_maps,
    through a pickled _host_cues."""
    labels, maps = device_pass[2]
    fn = pickle.loads(pickle.dumps(bench._host_cues))
    assert fn is bench._host_cues
    fov = float(bench_batch[-1][0])
    vm = cli.view_cue_maps(maps, 0, {"field_of_view_rads": fov}, RES)
    args = ({t: labels[t][0] for t in bench.FULL13_NEEDED}, fov, RES, vm["narf"],
            vm["seg2d_q"], vm["seg25d_q"])
    secs = fn(*pickle.loads(pickle.dumps(args)))
    assert set(secs) == {"kp3d", "seg2d", "seg25d"}
    assert all(math.isfinite(s) and s >= 0 for s in secs.values())


def test_render_batches_yields_each_batch_in_order(bench_batch):
    """The CLI's batched pipeline, as full13 drives it, on 2 batches: each
    yield is that batch's labels and cue maps, in order."""
    _, _, _, mesh, curv, _, _ = bench_batch
    cams_np = scenes.sample_cameras_np(6)
    batches = [scenes.camera_batch(cams_np, range(2 * b + 2, 2 * b + 4), RES, "cpu")
               for b in range(2)]
    settings = bench.full13_settings(RES)
    prefixes = _full13_prefixes(settings)
    fetched = list(cli.render_batches(iter(batches), mesh, curv, KW, ("rgb",),
                                      settings, prefixes))
    assert len(fetched) == 2
    for cams, (labels, maps) in zip(batches, fetched):
        out = annotate_views(cams, mesh, curv, **KW)
        want = cli.device_cue_maps(out, cams.fov, settings, prefixes)
        assert set(labels) == {"rgb"} and set(maps) == {"narf", "seg2d_q", "seg25d_q"}
        np.testing.assert_array_equal(labels["rgb"], out["rgb"].numpy())
        np.testing.assert_array_equal(maps["seg25d_q"], want["seg25d_q"].numpy())
        for lvl, wlvl in zip(maps["narf"], want["narf"]):
            for a, w in zip(lvl, wlvl):
                np.testing.assert_array_equal(a, w.numpy())


def test_warm_pool_starts_every_spawned_worker():
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
    import multiprocessing as mp

    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        assert bench.warm_pool(pool) == 2
        assert len(pool._processes) == 2
    with ThreadPoolExecutor(2) as pool:
        assert bench.warm_pool(pool) == 2


def test_share_of_peak_names_tf32_while_on(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert bench.peak_name("float32") == "tfloat32"
    assert bench.peak_name("bfloat16") == "bfloat16"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert bench.peak_name("float32") == "float32"
    assert PEAK_FLOPS["tfloat32"] == 495e12 and PEAK_FLOPS["float32"] == 67e12


def test_main_cpu_prints_headline(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "_SCENE_CACHE_DIR", tmp_path)
    bench.main(["--device", "cpu"], res=RES)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1  # the CPU route runs no extras
    out = json.loads(lines[0])
    assert set(out) == HEADLINE_KEYS
    assert set(out["config"]) == {"K", "tile", "chunk", "n_batches", "reps"}
    assert out["config"]["K"] == 2 and out["config"]["tile"] == 64
    assert out["value"] > 0 and out["value_min"] <= out["value"] <= out["value_max"]
    assert "39760 tris, cpu" in out["metric"] and out["unit"] == "viewpoints/s"


def test_no_card_fails_without_fallback():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    r = subprocess.run([sys.executable, "-m", "omnidata_tpu_torch.bench"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_scene_cache_rebuilds_the_same_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "_SCENE_CACHE_DIR", tmp_path)
    mesh, curv = bench.build_scene()
    assert [p.name for p in tmp_path.iterdir()] == ["small_0_4_5_cpu_v1.npz"]
    for got, want in zip(bench.build_scene(), (mesh, curv)):  # from the cache
        for k in MESH_FIELDS:
            a, b = getattr(got, k), getattr(want, k)
            assert (a is None) == (b is None), k
            if a is not None:
                assert torch.equal(a, b), k
    fresh = scenes.build_scene()
    assert torch.equal(fresh[1].vertex_colors, curv.vertex_colors)


def test_bench_large_scene_runs_kernel_c_route(tmp_path, monkeypatch):
    """bench_large_scene at K = 2, 64² on the bench scene, plain rasters:
    every render takes the streamed, compacting route (kernel C's)."""
    monkeypatch.setattr(bench, "_SCENE_CACHE_DIR", tmp_path)
    monkeypatch.setattr(bench, "LARGE_K", 2)
    monkeypatch.setattr(bench, "LARGE_RES", RES)
    calls = []
    streamed = raster.raster_tiles_streamed

    def counted(*a, **kw):
        calls.append(kw.get("bbox_words") is not None)
        return streamed(*a, **kw)

    monkeypatch.setattr(raster, "raster_tiles_streamed", counted)
    out = bench.bench_large_scene(build=bench.build_scene, prefix="xl",
                                  device="cpu", reps=2)
    assert calls == [True] * (1 + 2 * 2)  # the warm batch, 2 reps of 2 batches
    assert out["xl_scene_tris"] == 39760 and out["xl_scene_faces_padded"] == 39936
    assert out["xl_scene_vps_min"] <= out["xl_scene_vps"] <= out["xl_scene_vps_max"]
    assert out["xl_kernel_a_launches"] == 0  # CPU tensors: no kernel launched
    assert "xl_peak_gib" not in out  # no device memory measured on the CPU


def test_bench_full13_runs_on_the_cpu(monkeypatch, bench_batch):
    """bench_full13 end to end at K = 2, 64² on one batch (host cues in
    threads: one core)."""
    _, _, _, mesh, curv, _, _ = bench_batch
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    cams_np = scenes.sample_cameras_np(4)
    batches = [scenes.camera_batch(cams_np, range(2, 4), RES, "cpu")]
    out = bench.bench_full13(mesh, curv, batches, cams_np, 2, RES, KW, n_batches=1)
    assert set(out) == {"full13_vps", "full13_views", "full13_pool_workers",
                        "full13_pool_spawn_s", "full13_host_cpus",
                        "full13_cue_secs", "full13_cue_secs_pipelined",
                        "full13_fetch_mbps", "full13_payload_mb_per_view"}
    assert out["full13_views"] == 2 and out["full13_host_cpus"] == 1
    assert out["full13_pool_workers"] == 2  # the one-core pool: two threads
    for k in ("full13_cue_secs", "full13_cue_secs_pipelined"):
        assert set(out[k]) == {"kp3d", "seg2d", "seg25d"}
        assert all(math.isfinite(v) for v in out[k].values())


def test_model_flops_counts_convs_linears_and_attention():
    from omnidata_tpu_torch.models.layers import Attention

    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                              torch.nn.Conv2d(4, 4, 3, padding=1, groups=2))
    x = torch.zeros(2, 3, 8, 8)
    assert model_flops(net, x) == 2 * 64 * 4 * 3 * 9 + 2 * 64 * 4 * 2 * 9
    att = Attention(8, 2)
    got = model_flops(att, torch.zeros(1, 5, 8))
    # qkv (5 x 24 outputs of 8), proj (5 x 8 of 8), q k^T and attn v
    assert got == 2 * 5 * 24 * 8 + 2 * 5 * 8 * 8 + 2 * 2 * 5 * 5 * 8
    assert not any(m._forward_hooks for m in att.modules())
