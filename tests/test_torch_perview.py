"""The per-view path of omnidata_tpu_torch against the JAX package:
``mesh.raster.{bin_triangles, tile_candidate_counts, render_view,
render_views, render_view_fused}``, ``annotator.annotate_view`` and the
annotator CLI's per-view route (``--device cpu`` without
FORCE_BATCHED_PATH), on the inputs of tests/test_mesh.py. The JAX side
runs its XLA ``render_view``, and its Pallas kernel in interpret mode.

Tolerances:
- ``bin_triangles`` lists and counts, ``tile_candidate_counts``: equal;
- renders: ``valid`` and ``face`` equal, t and z within 1e-4 where valid
  (float32 products that the two frameworks round alike here);
- labels: the integer-label rule of tests/test_mesh.py:366-375 (max diff
  <= 1 on < 2% of pixels, or <= 32 on < 0.1%), equal shapes and dtypes.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnidata_tpu.annotator.cli as jcli
from omnidata_tpu.annotator import annotate_view as j_annotate_view
from omnidata_tpu.annotator.settings import load_settings as j_load_settings
from omnidata_tpu.core import Camera as JCamera
from omnidata_tpu.core import look_at_rotation
from omnidata_tpu.cues.curvature import bake_curvature_colors
from omnidata_tpu.mesh import cube, from_arrays, quad_plane, room, uv_sphere
from omnidata_tpu.mesh import raster as jraster
from omnidata_tpu_torch.annotator import annotate_view, annotate_views
from omnidata_tpu_torch.annotator import cli as tcli
from omnidata_tpu_torch.annotator.settings import load_settings as t_load_settings
from omnidata_tpu_torch.core.cameras import Camera
from omnidata_tpu_torch.mesh import raster as traster

from _torch_port_util import int_label_ok, port_mesh

torch.set_num_threads(1)

RES = 64


def _cameras(loc, target, fov=1.0, res=RES):
    """(JAX camera, port camera) of one view, the port's carrying JAX's
    rotation."""
    loc = jnp.asarray(loc, jnp.float32)
    jc = JCamera(loc, look_at_rotation(loc, jnp.asarray(target, jnp.float32)),
                 jnp.asarray(fov, jnp.float32), res)
    tc = Camera(torch.from_numpy(np.array(jc.location)),
                torch.from_numpy(np.array(jc.R)),
                torch.tensor(np.float32(fov)), res)
    return jc, tc


def _dense_scene():
    """tests/test_mesh.py:479's room with two dense spheres (> 6000 faces)."""
    r = room(size=8.0, height=3.0)
    parts = [r, uv_sphere(radius=0.5, center=(1.5, 0.5, 0.8), n_lat=40, n_lon=80),
             uv_sphere(radius=0.4, center=(-1.0, -1.5, 0.6), n_lat=40, n_lon=80)]
    vs, fs, off = [], [], 0
    for p in parts:
        vs.append(np.asarray(p.vertices))
        fs.append(np.asarray(p.faces[: p.num_faces]) + off)
        off += p.vertices.shape[0]
    return from_arrays(np.concatenate(vs), np.concatenate(fs))


SCENES = {  # name -> (JAX mesh constructor, camera location, target, fov)
    "plane": (lambda: quad_plane(size=100.0, z=0.0), [0, 0, 2.0], [0, 0, 0.0], 1.0),
    "cube": (lambda: cube(size=1.0), [2.0, 1.5, 1.2], [0, 0, 0], 1.0),
    "cube_top": (lambda: cube(size=1.0), [0, 0, 3.0], [0, 0, 0], 0.6),
    "room": (lambda: room(size=8.0, height=3.0), [0, 0, 1.5], [2.0, 1.0, 1.5], 1.0),
    "dense": (_dense_scene, [2.5, 1.0, 1.4], [-1.0, -1.0, 0.8], 1.2),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    build, loc, tgt, fov = SCENES[request.param]
    jmesh = build()
    jc, tc = _cameras(loc, tgt, fov)
    return request.param, jmesh, port_mesh(jmesh), jc, tc


def _assert_frags_match(got, want):
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(got.face.numpy(), np.asarray(want.face))
    m = wv
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(want.t)[m], atol=1e-4)
    np.testing.assert_allclose(got.z.numpy()[m], np.asarray(want.z)[m], atol=1e-4)


@pytest.mark.parametrize("cap", [64, 256, 2048])
def test_render_view_matches_jax(scene, cap):
    """cap 64 overflows the dense scene's tiles: both drop the same
    candidates (lowest face ids kept)."""
    name, jmesh, tmesh, jc, tc = scene
    want = jraster.render_view(jc, jmesh, tile=32, cap=cap, chunk=32)
    got = traster.render_view(tc, tmesh, tile=32, cap=cap, chunk=32)
    assert got.t.shape == (RES, RES) and got.bary.shape == (RES, RES, 2)
    _assert_frags_match(got, want)
    if name in ("plane", "room"):
        assert bool(got.valid.all())


def test_bin_triangles_and_candidate_counts_match_jax(scene):
    name, jmesh, tmesh, jc, tc = scene
    for tile, cap in ((32, 64), (32, 300), (16, 8)):
        lists, counts = traster.bin_triangles(tc, tmesh, tile, cap)
        jl, jcnt = jraster.bin_triangles(jc, jmesh, tile, cap)
        assert lists.dtype == torch.int32 and lists.shape == ((RES // tile) ** 2, cap)
        np.testing.assert_array_equal(lists.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcnt))
        want = np.asarray(jraster.tile_candidate_counts(jc, jmesh, tile=tile))
        got = traster.tile_candidate_counts(tc, tmesh, tile=tile)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "cube":  # tests/test_mesh.py:147
        assert int(traster.bin_triangles(tc, tmesh, 32, 64)[1].max()) <= 12


def test_render_view_plane_zbuffer_constant():
    """tests/test_mesh.py:51 on the port alone."""
    _, tc = _cameras([0, 0, 2.0], [0, 0, 0.0])
    frag = traster.render_view(tc, port_mesh(quad_plane(size=100.0, z=0.0)),
                               tile=32, cap=256, chunk=32)
    assert bool(frag.valid.all())
    np.testing.assert_allclose(frag.z.numpy(), 2.0, atol=1e-4)
    assert float(frag.t.max()) > 2.0 + 1e-3


def test_render_view_rejects_cap_past_the_key_bits():
    _, tc = _cameras([0, 0, 2.0], [0, 0, 0.0])
    with pytest.raises(ValueError, match="13 low bits"):
        traster.render_view(tc, port_mesh(cube(size=1.0)), tile=32, cap=16384)
    with pytest.raises(ValueError, match="at least one chunk"):
        traster.render_view(tc, port_mesh(cube(size=1.0)), tile=32, cap=64)


def test_render_views_matches_render_view():
    """tests/test_mesh.py:155: three cameras around the cube, each view equal
    to its own render_view and to JAX's render_views."""
    jmesh = cube(size=1.0)
    tmesh = port_mesh(jmesh)
    locs = [[2.0, 0, 0.5], [0, 2.0, 0.5], [-2.0, 0, 0.5]]
    pairs = [_cameras(loc, [0, 0, 0], 0.9) for loc in locs]
    tcams = Camera(torch.stack([c.location for _, c in pairs]),
                   torch.stack([c.R for _, c in pairs]),
                   torch.stack([c.fov for _, c in pairs]), RES)
    jcams = JCamera(jnp.stack([c.location for c, _ in pairs]),
                    jnp.stack([c.R for c, _ in pairs]),
                    jnp.stack([c.fov for c, _ in pairs]), RES)
    frags = traster.render_views(tcams, tmesh, tile=32, cap=256, chunk=32)
    assert frags.t.shape == (3, RES, RES)
    assert bool(frags.valid.any(dim=(1, 2)).all())
    want = jraster.render_views(jcams, jmesh, tile=32, cap=256, chunk=32)
    for k, (_, tc) in enumerate(pairs):
        one = traster.render_view(tc, tmesh, tile=32, cap=256, chunk=32)
        for a, b in zip(frags, one):
            assert torch.equal(a[k], b)
        _assert_frags_match(traster.Fragments(*(x[k] for x in frags)),
                            jraster.Fragments(*(x[k] for x in want)))


def test_render_view_fused_matches_jax_pallas_and_render_view():
    """tests/test_mesh.py:274 and :296: the K = 1 kernel render (plain
    version here) against JAX's render_view_pallas in interpret mode and the
    port's render_view, with interpolated attributes."""
    jmesh = cube(size=1.0)
    tmesh = port_mesh(jmesh)
    jc, tc = _cameras([2.0, 1.5, 1.2], [0, 0, 0])
    attrs = np.concatenate([np.asarray(jmesh.vertex_normals),
                            np.random.RandomState(0).rand(8, 3)], -1).astype(np.float32)
    jf, ja = jraster.render_view_pallas(jc, jmesh, tile=32, cap=256, chunk=64,
                                        interpret=True, vertex_attrs=jnp.asarray(attrs))
    tf, ta = traster.render_view_fused(tc, tmesh, tile=32, chunk=64,
                                       vertex_attrs=torch.from_numpy(attrs))
    _assert_frags_match(tf, jf)
    m = np.asarray(jf.valid)
    np.testing.assert_allclose(ta.numpy()[m], np.asarray(ja)[m], atol=1e-4)
    plain = traster.render_view(tc, tmesh, tile=32, cap=256, chunk=64)
    assert torch.equal(plain.valid, tf.valid) and torch.equal(plain.face, tf.face)
    np.testing.assert_allclose(plain.t.numpy()[m], tf.t.numpy()[m], atol=1e-4)


def _labels_match(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape)
        ok, dmax, frac = int_label_ok(g, w)
        assert ok, (k, dmax, frac)


@pytest.fixture(scope="module")
def coloured_room():
    """tests/test_mesh.py:333's room with seeded vertex colours and baked
    curvature, and its two cameras."""
    base = room(size=4.0, height=2.5)
    colors = (np.random.RandomState(0).rand(base.vertices.shape[0], 3)
              .astype(np.float32) * 0.6 + 0.2)
    jmesh = from_arrays(np.asarray(base.vertices),
                        np.asarray(base.faces[: base.num_faces]), vertex_colors=colors)
    jcurv = bake_curvature_colors(jmesh, rings=1)
    cams = [_cameras([1.0, 0.5, 1.2], [0, 0, 0.5], 1.0),
            _cameras([-0.8, 1.1, 1.6], [0.5, -0.5, 0.8], 1.2)]
    return jmesh, jcurv, port_mesh(jmesh), port_mesh(jcurv), cams


@pytest.mark.parametrize("route", [dict(use_pallas=False), dict(use_pallas=True),
                                   dict(use_pallas=True, fused_attrs=True), {}],
                         ids=["render_view", "kernel", "kernel_fused_attrs", "auto"])
def test_annotate_view_matches_jax(coloured_room, route):
    """Every route of annotate_view against JAX's annotate_view(use_pallas=
    False), and against the port's batched annotate_views."""
    jmesh, jcurv, tmesh, tcurv, cams = coloured_room
    kw = dict(tile=32, cap=512, chunk=64)
    tcams = Camera(torch.stack([c.location for _, c in cams]),
                   torch.stack([c.R for _, c in cams]),
                   torch.stack([c.fov for _, c in cams]), RES)
    batched = annotate_views(tcams, tmesh, tcurv, tile=32, chunk=64)
    for i, (jc, tc) in enumerate(cams):
        want = j_annotate_view(jc, jmesh, jcurv, use_pallas=False, **kw)
        got = annotate_view(tc, tmesh, tcurv, **kw, **route)
        _labels_match(got, want)
        _labels_match(got, {k: v[i] for k, v in batched.items()})


def test_annotate_view_face_colours_semantic_and_blur():
    """Per-face material colours, face labels and the keypoint blur on both
    routes against JAX's render_view route."""
    r = room(size=4.0, height=2.5)
    c = cube(size=0.8, center=(0.0, 0.0, 0.6))
    vs = np.concatenate([np.asarray(r.vertices), np.asarray(c.vertices)])
    fs = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                         np.asarray(c.faces[: c.num_faces]) + r.vertices.shape[0]])
    rng = np.random.RandomState(1)
    jmesh = from_arrays(vs, fs, face_labels=rng.randint(1, 40, len(fs)),
                        face_colors=rng.rand(len(fs), 3))
    jc, tc = _cameras([1.0, 0.5, 1.2], [0, 0, 0.5], 1.0)
    kw = dict(tile=32, cap=512, chunk=64, keypoint_blur_sigma=1.1)
    want = j_annotate_view(jc, jmesh, None, use_pallas=False, **kw)
    for use_pallas in (False, True):
        got = annotate_view(tc, port_mesh(jmesh), None, use_pallas=use_pallas, **kw)
        assert "semantic" in got and len(np.unique(got["semantic"].numpy())) > 2
        _labels_match(got, want)


def test_annotate_view_textured_quad_matches_jax(tmp_path):
    """tests/test_mesh.py:283's textured quad (2x2 checker atlas) on every
    route: the shade path's ``textured_colors`` and, with fused_attrs, the
    kernel's interpolated uvs sampled as JAX's ``_sample_texture`` does."""
    from PIL import Image

    from omnidata_tpu.mesh import load_obj

    tex = np.zeros((64, 64, 3), np.uint8)
    tex[:32, :32] = (255, 0, 0)
    tex[32:, 32:] = (0, 255, 0)
    Image.fromarray(tex).save(tmp_path / "m.png")
    (tmp_path / "m.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    jmesh = load_obj(str(tmp_path / "m.obj"))
    tmesh = port_mesh(jmesh)
    assert tmesh.texture is not None and tmesh.vertex_uvs is not None
    jc, tc = _cameras([0.5, 0.5, 2.0], [0.5, 0.5, 0.0], 0.8)
    kw = dict(tile=32, cap=256, chunk=32, modalities=("rgb", "mask_valid"))
    want = j_annotate_view(jc, jmesh, None, use_pallas=False, **kw)
    for route in (dict(use_pallas=False), dict(use_pallas=True),
                  dict(use_pallas=True, fused_attrs=True)):
        got = annotate_view(tc, tmesh, None, **kw, **route)
        rgb = got["rgb"].numpy()
        assert (rgb[..., 0] > 200).any() and (rgb[..., 1] > 200).any()
        _labels_match(got, want)


def _room_sphere_ply(d):
    """room(4.0, 2.5) with a 1,024-face sphere inside, random vertex
    colours, as mesh.ply: tiles that see the sphere hold more than
    RASTER_CAP=128 candidates."""
    from omnidata_tpu_torch.utils.convert_mesh import write_ply

    r = room(size=4.0, height=2.5)
    s = uv_sphere(radius=0.6, center=(0.3, 0.2, 1.2), n_lat=16, n_lon=32)
    v = np.concatenate([np.asarray(r.vertices), np.asarray(s.vertices)])
    f = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                        np.asarray(s.faces[: s.num_faces]) + r.vertices.shape[0]])
    os.makedirs(d, exist_ok=True)
    write_ply(os.path.join(d, "mesh.ply"), v, f,
              vertex_colors=np.random.RandomState(0).rand(v.shape[0], 3))
    return d


def test_cli_per_view_route_matches_jax_per_view_cli(tmp_path):
    """The 12 device tasks of both CLIs on the CPU without
    FORCE_BATCHED_PATH (both per view: render_view at RASTER_CAP doubled to
    cover each view), on one shared point_info of 4 views; RASTER_CAP=128
    so the probe must raise it. Every output within the integer-label rule."""
    dirs = [_room_sphere_ply(str(tmp_path / n)) for n in ("port", "jax")]
    pts = ["NUM_POINTS=2", "RESOLUTION=64", "MIN_CAMERA_SPACING=1.0",
           "MIN_VIEWS_PER_POINT=2", "MAX_VIEWS_PER_POINT=2",
           "MIN_NONFIXATED_AFTER_PRUNE=0"]
    jcli.main(["--model_path", dirs[1], "--task", "points", "with", *pts])
    shutil.copytree(os.path.join(dirs[1], "point_info"),
                    os.path.join(dirs[0], "point_info"))
    tasks = sorted(tcli.DEVICE_TASKS)
    caps = []
    view_cap = tcli.view_cap

    def recording_cap(*a):
        caps.append(view_cap(*a))
        return caps[-1]

    over = ["RESOLUTION=64", "RASTER_CAP=128", "RASTER_CHUNK=64"]
    tcli.view_cap = recording_cap
    try:
        tcli.run_device_tasks(dirs[0], tasks, t_load_settings(over), device="cpu")
    finally:
        tcli.view_cap = view_cap
    jcli.run_device_tasks(dirs[1], tasks, j_load_settings(over))
    assert len(caps) >= 2 and max(caps) > 128
    n = 0
    for t in tasks:
        names = sorted(os.listdir(os.path.join(dirs[1], t)))
        assert sorted(os.listdir(os.path.join(dirs[0], t))) == names, t
        for name in names:
            if name.endswith(".npy"):
                g, w = (np.load(os.path.join(d, t, name)) for d in dirs)
            else:
                from PIL import Image

                g, w = (np.asarray(Image.open(os.path.join(d, t, name))) for d in dirs)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            ok, dmax, frac = int_label_ok(g, w)
            assert ok, (name, dmax, frac)
            n += 1
    assert n == 11 * len(caps)  # no face labels: no semantic


def test_exports_match_jax():
    """The per-view names are exported where the JAX package exports them."""
    import omnidata_tpu.annotator as jann
    import omnidata_tpu.mesh as jmesh
    import omnidata_tpu_torch.annotator as tann
    import omnidata_tpu_torch.mesh as tmesh

    for name in ("bin_triangles", "render_view", "render_views", "Fragments",
                 "render_views_fused", "scene_pack"):
        assert hasattr(jmesh, name) and hasattr(tmesh, name), name
    assert tmesh.render_view_fused is traster.render_view_fused
    assert tmesh.tile_candidate_counts is traster.tile_candidate_counts
    for name in ("annotate_view", "annotate_views", "annotate_views_sharded",
                 "make_annotate_mesh", "DEVICE_MODALITIES"):
        assert hasattr(jann, name) and hasattr(tann, name), name
