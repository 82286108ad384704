"""Raster kernels B (compacting) and C (streamed) of omnidata_tpu_torch:
their plain versions against the JAX package's Pallas kernels (interpret
mode, as tests/test_mesh.py runs them) on identical inputs, against kernel
A within the port, and the render and annotate stages that choose them.

Tolerances:
- band decode and bbox words: exact;
- against JAX, kernel and renderer: `valid` equal, and `face` equal where
  both are valid, on >= 99.9% of pixels; t within 1e-4 where the faces
  agree; interpolated attributes within 1e-4 (float32 arithmetic that the
  two frameworks order and fuse differently);
- annotate_views: the integer-label rule of tests/test_mesh.py;
- within the port: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.annotator import annotate_views as j_annotate_views
from omnidata_tpu.cues.curvature import bake_curvature_colors
from omnidata_tpu.mesh import from_arrays, pallas_raster, room
from omnidata_tpu.mesh import raster as jraster
from omnidata_tpu_torch.annotator import annotate_views
from omnidata_tpu_torch.mesh import raster as traster
from omnidata_tpu_torch.mesh import raster_kernels as tk

from _torch_port_util import (
    both_cameras,
    chunk_major,
    int_label_ok,
    look_at_np,
    mixed_inputs,
    port_mesh,
    room_sphere_views,
    with_block_tail,
)

torch.set_num_threads(1)

RES = 64
CHUNK = 64
TILE = 16  # kernel level: 16 tiles a view, one pixel block (P = 256)


@pytest.fixture(scope="module")
def scene():
    return room_sphere_views(RES)


@pytest.fixture(scope="module")
def kernel_inputs(scene):
    """Mixed exact / scan-all / block-mode lists at tile 16, the JAX side's
    16-bit id pairs, and kernel A's decoded result (the port's plain
    version), which B and C must equal bit for bit."""
    _, tmesh, _, tcam = scene
    args, T = mixed_inputs(tmesh, tcam, TILE, CHUNK)
    ids, counts, origins, pack, words, dirs = args
    c = counts.numpy()
    assert (c >= 0).any() and (c == -1).any() and (c <= -2).any(), c
    pairs = ids.numpy().reshape(ids.shape[0], -1, 2)
    jargs = (jnp.asarray((pairs[..., 0] | (pairs[..., 1] << 16)).reshape(-1)),
             jnp.asarray(c), jnp.asarray(origins.numpy()),
             jnp.asarray(pack.numpy()))
    jdirs = tuple(jnp.asarray(d.numpy()) for d in dirs)
    want = tk.decode_winners(
        *tk.raster_tiles_chunklist_reference(ids, counts, origins, pack, dirs,
                                             CHUNK, T), origins, dirs, T)
    return args, T, jargs, jdirs, want


def _agreement(tv, tf, jv, jf):
    """Fraction of pixels where valid agrees and, if valid, face agrees."""
    tv, tf, jv, jf = (np.asarray(a) for a in (tv, tf, jv, jf))
    same = (tv == jv) & (~jv | (tf == jf))
    return float(same.mean()), jv & tv & (tf == jf)


def _assert_close_to_jax(got, want):
    tv, tt, _, _, tf, ta = (a.numpy() for a in got)
    jv, jt, _, _, jf, ja = (np.asarray(a) for a in want)
    frac, agree = _agreement(tv, tf, jv, jf)
    assert frac >= 0.999, frac
    assert agree.mean() > 0.3
    np.testing.assert_allclose(tt[agree], jt[agree], atol=1e-4)
    np.testing.assert_allclose(ta[agree], ja[agree], atol=1e-4)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _decode(out, args, T):
    return tk.decode_winners(*out, args[2], args[5], T)


def test_band_decode_matches_jax():
    """The white-box words of tests/test_mesh.py's y-skip test (tile 32,
    pixel blocks of 512 = two blocks of two 8-row bands, tile row 1), and
    random words at tile 16, against pallas_raster._band_mask_and_flags."""
    lo_by = np.array([0, 4, 6, 5, 0, 7], np.int32)
    hi_by = np.array([3, 5, 7, 6, 9, 7], np.int32)
    rng = np.random.RandomState(3)
    b = rng.randint(0, 256, (4, 200))  # hi_by >= 128: negative words
    words_r = (b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)).astype(np.int32)
    cases = [(2 | (5 << 8) | (lo_by << 16) | (hi_by << 24), 3, 1, 32, 512, 2),
             (2 | (5 << 8) | (lo_by << 16) | (hi_by << 24), 7, 1, 32, 512, 2),
             (words_r, 5, 9, 16, 128, 2), (words_r, 130, 200, 8, 64, 1)]
    for bb, tx, ty, tile, pblk, nblocks in cases:
        bb = np.asarray(bb, np.int32)[None, :]
        jm, jflags = jax.jit(lambda b: pallas_raster._band_mask_and_flags(
            b, jnp.int32(tx), jnp.int32(ty), tile, pblk, nblocks))(bb)
        m, flags = tk.band_mask_and_flags(torch.as_tensor(bb), tx, ty, tile,
                                          pblk, nblocks)
        np.testing.assert_array_equal(m.numpy().astype(np.float32), np.asarray(jm))
        np.testing.assert_array_equal(flags[:, 0].numpy().astype(np.float32),
                                      np.asarray(jflags))
    assert m.any() and not m.all()


def test_bbox_words_match_jax_formula(scene):
    """raster.bbox_words is the JAX package's expression
    (omnidata_tpu/mesh/raster.py:667-672) on the same bboxes; dead faces and
    the padding quantize to lo 255 > hi 0."""
    _, tmesh, _, tcam = scene
    lo, hi = traster.padded_bboxes(tcam, tmesh, CHUNK)
    got = traster.bbox_words(lo, hi, RES, 32).numpy()
    jlo, jhi = jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())

    def q(x, step):
        return jnp.clip(jnp.floor(x / step), 0, 255).astype(jnp.int32)

    lo_t, hi_t = q(jlo - 1.0, 32), q(jhi + 1.0, 32)
    lo_b, hi_b = q(jlo - 1.0, 8.0), q(jhi + 1.0, 8.0)
    want = (lo_t[..., 0] | (hi_t[..., 0] << 8) | (lo_b[..., 1] << 16)
            | (hi_b[..., 1] << 24))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32 and got.shape == (2, tmesh.faces.shape[0])
    assert (got[:, tmesh.num_faces:] == 255 | (255 << 16)).all()
    with pytest.raises(ValueError, match="u8"):
        traster.bbox_words(lo, hi, 4096, 8)


@pytest.mark.parametrize("stage_cap", [None, 64])
def test_compact_reference_matches_pallas(kernel_inputs, stage_cap):
    """Kernel B's plain version + decode against raster_tiles_pallas_compact
    (interpret) on identical lists and bbox words; cap 64 sends rows to the
    raw-list fallback."""
    args, T, jargs, jdirs, want = kernel_inputs
    ids, counts, origins, pack, words, dirs = args
    cap = stage_cap or tk.STAGE_CAP
    staged, _ = tk.stage_faces(ids, counts, words, pack.shape[1] // CHUNK,
                               CHUNK, T, TILE, cap)
    assert bool((staged > cap).any()) and bool((staged <= cap).any())
    out = tk.raster_tiles_compact_reference(*args, chunk=CHUNK,
                                            tiles_per_view=T, stage_cap=cap)
    got = _decode(out, args, T)
    _assert_equal(got, want)  # within the port: A's decoded outputs
    jout = pallas_raster.raster_tiles_pallas_compact(
        *jargs, jnp.asarray(words.numpy()), jdirs, chunk=CHUNK,
        interpret=True, tiles_per_view=T, n1d=RES // TILE, ccap=4,
        stage_cap=cap)
    _assert_close_to_jax(got, jout)
    assert not out[1].permute(0, 2, 1).numpy()[~got[0].numpy()].any()


@pytest.mark.parametrize("compact, stage_cap", [(False, None), (True, None),
                                                (True, 64)])
def test_streamed_reference_matches_pallas(kernel_inputs, compact, stage_cap):
    """Kernel C's plain version on the chunk-major pack against
    raster_tiles_pallas_streamed (interpret), plain and compacting bodies.
    The plain body's packed keys equal kernel A's."""
    args, T, jargs, jdirs, want = kernel_inputs
    ids, counts, origins, pack, words, dirs = args
    cap = stage_cap or tk.STREAMED_STAGE_CAP
    out = tk.raster_tiles_streamed_reference(
        ids, counts, origins, chunk_major(pack, CHUNK), dirs, chunk=CHUNK,
        tiles_per_view=T, bbox_words=words if compact else None,
        stage_cap=cap)
    got = _decode(out, args, T)
    _assert_equal(got, want)
    if not compact:
        a_packed, _ = tk.raster_tiles_chunklist_reference(
            ids, counts, origins, pack, dirs, CHUNK, T)
        assert torch.equal(out[0], a_packed)
    jout = pallas_raster.raster_tiles_pallas_streamed(
        *jargs, jdirs, chunk=CHUNK, interpret=True, tiles_per_view=T, ccap=4,
        bbox_words=jnp.asarray(words.numpy()) if compact else None,
        n1d=RES // TILE, stage_cap=cap)
    _assert_close_to_jax(got, jout)


def test_block_mode_tail_is_staged_once(kernel_inputs):
    """A block-mode row whose last block runs past the last chunk stages
    each admitted overlapping face once: the clamped duplicates of the last
    chunk are not fresh. B and C still equal kernel A on that row."""
    args, T, *_ = kernel_inputs
    args, row, n = with_block_tail(args, T, CHUNK)
    ids, counts, origins, pack, words, dirs = args
    tx, ty = (row % T) % (RES // TILE), (row % T) // (RES // TILE)
    faces = torch.arange(((n - 1) // 8) * 8 * CHUNK, n * CHUNK)
    m, _ = tk.band_mask_and_flags(words[row // T, faces], tx, ty, TILE,
                                  TILE * TILE, 1)
    last, _ = tk.band_mask_and_flags(words[row // T, faces[-CHUNK:]], tx, ty,
                                     TILE, TILE * TILE, 1)
    n_dups = 8 - n % 8
    assert int(last.sum()) > 0 and n_dups > 0
    staged, slots = tk.stage_faces(ids, counts, words, n, CHUNK, T, TILE, 10**4)
    assert int(staged[row]) == int(m.sum())  # not + n_dups * last.sum()
    s = slots[row, : int(staged[row])]
    assert torch.equal(s, faces[m])  # ascending, each face once
    want = _decode(tk.raster_tiles_chunklist_reference(
        ids, counts, origins, pack, dirs, CHUNK, T), args, T)
    _assert_equal(_decode(tk.raster_tiles_compact_reference(
        *args, chunk=CHUNK, tiles_per_view=T), args, T), want)


def test_near_plane_face_is_never_staged():
    """A face whose vertices all lie within 1e-4 m in front of the camera is
    dead to the bboxes (word lo 255 > hi 0) and never staged, though its
    chunk is admitted by its chunkmates (pallas_raster.py:899-903)."""
    r = room(size=4.0, height=2.5)
    loc = np.array([0.3, 0.2, 1.2], np.float32)
    tgt = np.array([1.5, 0.0, 1.0], np.float32)
    R = look_at_np(loc[None], tgt[None])[0]
    fwd, right, up = -R[:, 2], R[:, 0], R[:, 1]
    tiny = np.stack([loc + 5e-5 * fwd, loc + 5e-5 * fwd + 2e-5 * right,
                     loc + 5e-5 * fwd + 2e-5 * up]).astype(np.float32)
    vs = np.concatenate([np.asarray(r.vertices), tiny])
    fs = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                         np.arange(3)[None] + r.vertices.shape[0]])
    jmesh = from_arrays(vs, fs)
    _, tcam = both_cameras(loc[None], R[None], np.array([1.1], np.float32), RES)
    mesh = port_mesh(jmesh)
    tris = mesh.vertices[mesh.faces.long()]
    near = int(torch.nonzero(((tris - torch.as_tensor(loc)).norm(dim=-1) < 1e-4)
                             .all(-1))[0, 0])
    assert near < mesh.num_faces
    inp = traster.prepare_raster(tcam, mesh, 16, 16, ccap=8, compact=True)
    assert int(inp.bbox_words[0, near]) == 255 | (255 << 16)
    n_chunks = inp.pack.shape[1] // 16
    staged, slots = tk.stage_faces(inp.ids, inp.counts, inp.bbox_words,
                                   n_chunks, 16, inp.tiles_per_view, 16, 10**4)
    assert int(staged.sum()) > 0 and not bool((slots == near).any())
    trip, chunk_of, _ = tk.chunk_schedule(inp.ids, inp.counts, n_chunks)
    listed = torch.stack([torch.where(trip > i, chunk_of(i), -1)
                          for i in range(int(trip.max()))], 1)
    assert bool((listed == near // 16).any())  # kernel A sweeps it


def test_compaction_on_and_off_equal_on_horizontal_strips():
    """tests/test_mesh.py's horizontal strips (y-local staged faces): B, C
    and C's plain body render what A renders, bit for bit."""
    vs, fs = [], []
    for z in np.linspace(0.2, 2.0, 9):
        v0 = len(vs)
        vs.extend([[-2.0, 0.0, z], [2.0, 0.0, z], [2.0, 0.0, z + 0.1],
                   [-2.0, 0.0, z + 0.1]])
        fs.extend([[v0, v0 + 1, v0 + 2], [v0, v0 + 2, v0 + 3]])
    mesh = port_mesh(from_arrays(np.asarray(vs, np.float32),
                                 np.asarray(fs, np.int32)))
    loc = np.array([[0.0, 4.0, 1.1]], np.float32)
    _, tcam = both_cameras(loc, look_at_np(loc, np.array([[0.0, 0.0, 1.1]])),
                           np.array([1.0], np.float32), RES)
    ref = traster.render_views_fused(tcam, mesh, tile=32, chunk=64)
    assert int(ref.valid.sum()) > 200  # strips visible
    for kw in (dict(compact=True), dict(streamed=True),
               dict(streamed=True, compact=False)):
        _assert_equal(traster.render_views_fused(tcam, mesh, tile=32,
                                                 chunk=64, **kw), ref)


@pytest.mark.parametrize("over", [False, True], ids=["at_bound", "over_bound"])
@pytest.mark.parametrize("attrs", [False, True], ids=["no_attrs", "normals"])
def test_render_views_fused_routes_by_pack_size(scene, monkeypatch, attrs, over):
    """streamed=None takes kernel C exactly when the scene pack (JAX's
    count: 23 + 3 x attribute channels float32 words a face) exceeds
    STREAMED_PACK_BYTES, kernel A otherwise, for render_views_fused and
    annotate_views alike; an explicit streamed=False keeps A; the renders
    are bitwise equal."""
    _, tmesh, _, tcam = scene
    va = tmesh.vertex_normals if attrs else None
    size = traster.pack_bytes(tmesh.faces.shape[0], 3 if attrs else 0)
    assert size == tmesh.faces.shape[0] * (23 + (9 if attrs else 0)) * 4
    monkeypatch.setattr(traster, "STREAMED_PACK_BYTES", size - 1 if over else size)
    calls = []
    for name in ("chunklist", "compact", "streamed"):
        fn = getattr(traster, f"raster_tiles_{name}")

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(traster, f"raster_tiles_{name}", spy)
    kw = dict(tile=32, chunk=CHUNK, vertex_attrs=va)
    got = traster.render_views_fused(tcam, tmesh, **kw)
    want = traster.render_views_fused(tcam, tmesh, streamed=False, **kw)
    assert calls == ["streamed" if over else "chunklist", "chunklist"]
    if attrs:
        (got, got_attrs), (want, want_attrs) = got, want
        assert torch.equal(got_attrs, want_attrs)
    _assert_equal(got, want)
    if not attrs:  # depth and face ids interpolate no vertex attribute
        calls.clear()
        annotate_views(tcam, tmesh, tile=32, chunk=CHUNK,
                       modalities=("depth_zbuffer", "fragments"))
        assert calls == ["streamed" if over else "chunklist"]


@pytest.mark.parametrize("kw", [dict(streamed=True), dict(compact=True)],
                         ids=["streamed", "compact"])
def test_render_views_fused_matches_jax(scene, kw):
    """The render stage with kernel C (compacting) or B against the JAX
    renderer with the same kwargs (Pallas interpret)."""
    jmesh, tmesh, jcam, tcam = scene
    common = dict(tile=32, chunk=CHUNK, **kw)
    jf, ja = jraster.render_views_fused(jcam, jmesh, interpret=True,
                                        vertex_attrs=jmesh.vertex_normals,
                                        **common)
    tf, ta = traster.render_views_fused(tcam, tmesh,
                                        vertex_attrs=tmesh.vertex_normals,
                                        **common)
    assert tf.t.shape == (2, RES, RES) and ta.shape == (2, RES, RES, 3)
    frac, agree = _agreement(tf.valid.numpy(), tf.face.numpy(), jf.valid, jf.face)
    assert frac >= 0.999, frac
    assert agree.mean() > 0.9
    for name in ("t", "z", "bary"):
        np.testing.assert_allclose(getattr(tf, name).numpy()[agree],
                                   np.asarray(getattr(jf, name))[agree],
                                   atol=1e-4)
    np.testing.assert_allclose(ta.numpy()[agree], np.asarray(ja)[agree],
                               atol=1e-4)


def test_annotate_views_streamed_matches_jax():
    """annotate_views(streamed=True) against the JAX annotate_views
    (streamed, Pallas interpret): room with seeded vertex colours and baked
    curvature, K = 2 at 64², tile 32, chunk 64."""
    base = room(size=4.0, height=2.5)
    rng = np.random.RandomState(0)
    colors = rng.rand(base.vertices.shape[0], 3).astype(np.float32) * 0.6 + 0.2
    jmesh = from_arrays(np.asarray(base.vertices),
                        np.asarray(base.faces[: base.num_faces]),
                        vertex_colors=colors)
    jcurv = bake_curvature_colors(jmesh, rings=1)
    locs = np.array([[1.0, 0.5, 1.2], [-0.8, 1.1, 1.6]], np.float32)
    tgts = np.array([[0.0, 0.0, 0.5], [0.5, -0.5, 0.8]], np.float32)
    jcam, tcam = both_cameras(locs, look_at_np(locs, tgts),
                              np.array([1.0, 1.2], np.float32), RES)
    kw = dict(tile=32, chunk=64, streamed=True)
    want = j_annotate_views(jcam, jmesh, jcurv, interpret=True, **kw)
    got = annotate_views(tcam, port_mesh(jmesh), port_mesh(jcurv), **kw)
    assert set(got) == set(want)
    assert got["mask_valid"].numpy().mean() > 200
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        ok, dmax, frac = int_label_ok(g, w)
        assert ok, (k, dmax, frac)


@pytest.mark.parametrize("name", ["compact", "streamed"])
def test_wrapper_takes_plain_version_only_for_cpu_tensors(kernel_inputs, name):
    args, T, *_ = kernel_inputs
    ids, counts, origins, pack, words, dirs = args
    wrapper = getattr(tk, f"raster_tiles_{name}")
    plain = getattr(tk, f"raster_tiles_{name}_reference")

    def call(fn, ids, counts, origins, pack, words, dirs):
        if name == "compact":
            return fn(ids, counts, origins, pack, words, dirs, chunk=CHUNK,
                      tiles_per_view=T)
        return fn(ids, counts, origins, chunk_major(pack, CHUNK), dirs,
                  chunk=CHUNK, tiles_per_view=T, bbox_words=words)

    before = wrapper.launches
    _assert_equal(call(wrapper, *args), call(plain, *args))
    assert wrapper.launches == before  # no kernel launched
    meta = [t.to("meta") for t in (ids, counts, origins, pack, words)]
    with pytest.raises(ValueError, match="no kernel"):
        call(wrapper, *meta, tuple(d.to("meta") for d in dirs))
    with pytest.raises(ValueError, match="int32"):
        call(wrapper, ids, counts, origins, pack, words.long(), dirs)
    assert wrapper.launches == before
