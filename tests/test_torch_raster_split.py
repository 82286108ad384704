"""The work items of raster kernels A, B and C (omnidata_tpu_torch): the
item list ``split_schedule`` covers every (row, list position) once and
keeps a dense row whole, and the plain segmented sweep-and-fold
(``raster_tiles_split_reference``: each segment swept from scratch, the
segments folded in order) equals the sequential plain versions bit for bit
at segments of 1, 3 and 16 list positions; B's (row-major pack, stage cap
512 or 64) as C's (chunk-major pack, cap 8192 or 64). Two cases also against
the JAX package's Pallas kernels in interpret mode: C's streamed kernel, and
B's compacting kernel on the scenes of tests/test_mesh.py:554,590.

Inputs: the scenes of tests/test_mesh.py's kernel tests (:523 room, :554
room and sphere, :590 horizontal strips) and the port's room-and-sphere
views, with exact, scan-all (ccap 4) and block-mode rows given as exact
lists (``_torch_port_util.capped_as_exact``), a block-mode row whose last block runs
past the last chunk, and rows past a stage cap of 64; and the card's exact
lists (flat, at row offsets) of the room-and-sphere views, some longer rows
past their buffer.

Tolerances: within the port, bitwise; against JAX, `valid` equal and
`face` equal where both are valid on >= 99.9% of pixels, t within 1e-4
where the faces agree (float32 arithmetic that the two frameworks order and
fuse differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.mesh import from_arrays, pallas_raster, room, uv_sphere
from omnidata_tpu_torch.mesh import raster_kernels as tk

from _torch_port_util import (
    as_exact,
    both_cameras,
    chunk_major,
    exact_inputs,
    look_at_np,
    mixed_inputs,
    mixed_lists,
    port_mesh,
    room_sphere_views,
    with_block_tail,
)

torch.set_num_threads(1)

RES = 64
SEGS = [1, 3, 16]
BODIES = ["chunklist", "streamed", "streamed_compact", "streamed_compact_cap64",
          "compact", "compact_cap64"]
# the compacting bodies: kernel B (row-major pack) and C's (chunk-major)
COMPACTING = ["streamed_compact", "streamed_compact_cap64", "compact",
              "compact_cap64"]


def _views(jmesh, locs, tgts, fovs):
    locs, tgts = np.asarray(locs, np.float32), np.asarray(tgts, np.float32)
    _, tcam = both_cameras(locs, look_at_np(locs, tgts),
                           np.asarray(fovs, np.float32), RES)
    return port_mesh(jmesh), tcam


def _room_523():
    """tests/test_mesh.py:523's room and views."""
    return _views(room(size=4.0, height=2.5), [[1.0, 0.5, 1.2], [-0.8, 1.1, 1.6]],
                  [[0, 0, 0.5], [0.5, -0.5, 0.8]], [1.0, 1.2])


def _room_sphere_554():
    """tests/test_mesh.py:554's room with a sphere and views."""
    r = room(size=6.0, height=3.0)
    s = uv_sphere(radius=0.6, center=(1.0, 0.4, 0.9), n_lat=32, n_lon=64)
    vs = np.concatenate([np.asarray(r.vertices), np.asarray(s.vertices)])
    fs = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                         np.asarray(s.faces[: s.num_faces]) + r.vertices.shape[0]])
    return _views(from_arrays(vs, fs), [[1.5, 0.5, 1.2], [-0.8, 1.1, 1.6]],
                  [[0.5, 0.2, 0.8], [0.5, -0.5, 0.8]], [1.1, 1.3])


def _strips_590():
    """tests/test_mesh.py:590's horizontal strips on a wall and its view."""
    vs, fs = [], []
    for z in np.linspace(0.2, 2.0, 9):
        v0 = len(vs)
        vs.extend([[-2.0, 0.0, z], [2.0, 0.0, z], [2.0, 0.0, z + 0.1],
                   [-2.0, 0.0, z + 0.1]])
        fs.extend([[v0, v0 + 1, v0 + 2], [v0, v0 + 2, v0 + 3]])
    jmesh = from_arrays(np.asarray(vs, np.float32), np.asarray(fs, np.int32))
    return _views(jmesh, [[0.0, 4.0, 1.1]], [[0.0, 0.0, 1.1]], [1.0])


# scene -> (builder, tile, chunk, with a clamped block tail)
SCENES = {
    "room_sphere": (lambda: room_sphere_views(RES)[1::2], 16, 64, False),
    "room_sphere_block_tail": (lambda: room_sphere_views(RES)[1::2], 16, 64, True),
    "room_523": (_room_523, 16, 2, False),  # 12 faces: 6 chunks
    "room_sphere_554": (_room_sphere_554, 32, 64, False),
    "strips_590": (_strips_590, 32, 4, False),  # 18 faces: 5 chunks
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def inputs(request):
    """((ids, counts, origins, pack, bbox_words, dir_planes), offsets,
    tiles_per_view, tile, chunk) of one scene, with exact, scan-all and
    block-mode rows given as exact lists."""
    build, tile, chunk, tail = SCENES[request.param]
    mesh, cams = build()
    args, T = mixed_lists(mesh, cams, tile, chunk)
    if tail:
        args, _, _ = with_block_tail(args, T, chunk)
    return (*as_exact(args, chunk), T, tile, chunk)


def _cap(body):
    if body.endswith("64"):
        return 64
    return tk.STAGE_CAP if body == "compact" else tk.STREAMED_STAGE_CAP


def _staged(args, offsets, T, tile, chunk, cap):
    ids, counts, _, pack, words, _ = args
    return tk.stage_faces(ids, counts, words, pack.shape[1] // chunk, chunk, T,
                          tile, cap, offsets=offsets)[0]


def _assert_bitwise(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("body", ["chunklist", *COMPACTING])
def test_split_schedule_covers_every_position_once(inputs, body, seg):
    args, offsets, T, tile, chunk = inputs
    ids, counts, _, pack, _, _ = args
    n_chunks = pack.shape[1] // chunk
    staged = None if body == "chunklist" else _staged(args, offsets, T, tile,
                                                      chunk, _cap(body))
    sched = tk.split_schedule(counts, staged, n_chunks, seg, chunk, _cap(body))
    rows = counts.shape[0]
    assert torch.equal(torch.sort(sched.order.long()).values, torch.arange(rows))
    item_row, item_seg = tk.schedule_items(sched)
    assert item_row.shape[0] == int(sched.ends[-1]) and bool((sched.n_items >= 1).all())
    trip = tk.list_trips(counts, n_chunks).long()
    dense = (torch.zeros(rows, dtype=torch.bool) if staged is None
             else staged <= _cap(body))
    covered = torch.zeros(rows, n_chunks + 1, dtype=torch.int64)
    for r, s in zip(item_row.tolist(), item_seg.tolist()):
        if dense[r]:
            assert s == 0 and int(sched.n_items[r]) == 1  # one dense item
            continue
        lo, hi = s * seg, min(int(trip[r]), (s + 1) * seg)
        assert lo < hi or (lo == 0 and int(trip[r]) == 0)  # no empty split item
        covered[r, lo:hi] += 1
    for r in torch.nonzero(~dense)[:, 0].tolist():
        t = int(trip[r])
        assert bool((covered[r, :t] == 1).all()) and not covered[r, t:].any()
    # longest items first: a row's largest item is in no higher cost bucket
    # than an earlier row's, and rows of one bucket keep their order
    cost = torch.where(dense, staged.long() if staged is not None else 0,
                       torch.clamp(trip, max=seg) * chunk)
    bucket = tk.cost_bucket(cost)[sched.order.long()]
    assert bool((bucket[1:] <= bucket[:-1]).all())
    same = bucket[1:] == bucket[:-1]
    assert bool((sched.order[1:][same] > sched.order[:-1][same]).all())
    if body == "chunklist" and int(trip.max()) > seg:
        assert bool((sched.n_items > 1).any())  # some row is split


def test_cost_bucket_is_monotone_with_four_buckets_an_octave():
    """The sort key of the schedule, as schedule_kernel computes it with
    __clz: cost itself below 4, then 4 * floor(log2 cost) + the next two
    bits - 4; every int32 cost falls in 0..127."""
    cost = torch.tensor([0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 2048, 3000,
                         2**20, 2**31 - 1])
    want = [0, 1, 2, 3, 4, 5, 7, 8, 8, 11, 12, 40, 41, 76, 119]
    assert tk.cost_bucket(cost).tolist() == want
    every = tk.cost_bucket(torch.arange(1 << 16))
    assert bool((every[1:] >= every[:-1]).all()) and int(every.max()) < 128


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("body", BODIES)
def test_segmented_fold_equals_sequential_plain_versions(inputs, body, seg):
    """Each segment swept from scratch and the segments folded in order
    give the sequential sweep's packed keys and acc columns, bit for bit,
    for kernel A's function, both bodies of kernel C and kernel B."""
    args, offsets, T, tile, chunk = inputs
    ids, counts, origins, pack, words, dirs = args
    kw = dict(chunk=chunk, tiles_per_view=T, offsets=offsets)
    if body == "chunklist":
        want = tk.raster_tiles_chunklist_reference(ids, counts, origins, pack,
                                                   dirs, **kw)
        got = tk.raster_tiles_split_reference(ids, counts, origins, pack, dirs,
                                              seg=seg, **kw)
    elif body.startswith("compact"):
        want = tk.raster_tiles_compact_reference(
            ids, counts, origins, pack, words, dirs, stage_cap=_cap(body), **kw)
        got = tk.raster_tiles_split_reference(
            ids, counts, origins, pack, dirs, seg=seg, bbox_words=words,
            stage_cap=_cap(body), **kw)
    else:
        w = None if body == "streamed" else words
        cm = chunk_major(pack, chunk)
        want = tk.raster_tiles_streamed_reference(
            ids, counts, origins, cm, dirs, bbox_words=w, stage_cap=_cap(body), **kw)
        got = tk.raster_tiles_split_reference(
            ids, counts, origins, cm, dirs, seg=seg, bbox_words=w,
            stage_cap=_cap(body), **kw)
    _assert_bitwise(got, want)
    assert bool((want[0] < tk.BIG_PACKED).any())


def test_segmented_fold_matches_pallas_streamed_interpret():
    """Segments of one list position, compacting body at stage cap 64 (rows
    past the cap split into one item per chunk), decoded, against
    raster_tiles_pallas_streamed in interpret mode on the same lists."""
    _, tmesh, _, tcam = room_sphere_views(RES)
    tile, chunk = 16, 64
    capped, T = mixed_lists(tmesh, tcam, tile, chunk)
    args, offsets = as_exact(capped, chunk)
    ids, counts, origins, pack, words, dirs = args
    staged = _staged(args, offsets, T, tile, chunk, 64)
    assert bool((staged > 64).any()) and bool((counts == -1).any())
    out = tk.raster_tiles_split_reference(
        ids, counts, origins, chunk_major(pack, chunk), dirs, chunk=chunk,
        tiles_per_view=T, seg=1, bbox_words=words, stage_cap=64,
        offsets=offsets)
    tv, tt, _, _, tf, _ = (a.numpy() for a in tk.decode_winners(*out, origins,
                                                                 dirs, T))
    c_ids, c_counts = capped[:2]
    pairs = c_ids.numpy().reshape(c_ids.shape[0], -1, 2)
    jout = pallas_raster.raster_tiles_pallas_streamed(
        jnp.asarray((pairs[..., 0] | (pairs[..., 1] << 16)).reshape(-1)),
        jnp.asarray(c_counts.numpy()), jnp.asarray(origins.numpy()),
        jnp.asarray(pack.numpy()), tuple(jnp.asarray(d.numpy()) for d in dirs),
        chunk=chunk, interpret=True, tiles_per_view=T, ccap=c_ids.shape[1],
        bbox_words=jnp.asarray(words.numpy()), n1d=RES // tile, stage_cap=64)
    jv, jt, _, _, jf, _ = (np.asarray(a) for a in jout)
    same = (tv == jv) & (~jv | (tf == jf))
    assert same.mean() >= 0.999, same.mean()
    agree = jv & tv & (tf == jf)
    assert agree.mean() > 0.3
    np.testing.assert_allclose(tt[agree], jt[agree], atol=1e-4)


@pytest.mark.parametrize("scene, cap", [("room_sphere_554", 64),
                                        ("strips_590", 8)])
def test_compact_split_matches_pallas_compact_interpret(scene, cap):
    """Kernel B's items at segments of one list position (rows past the
    cap split into one item per chunk), decoded, against
    raster_tiles_pallas_compact in interpret mode on the same lists and
    bbox words. Cap 64 on tests/test_mesh.py:554's room and sphere (rows
    dense and past the cap); 8 on :590's strips, whose tiles stage at most
    10 faces."""
    build, tile, chunk, _ = SCENES[scene]
    mesh, cams = build()
    capped, T = mixed_lists(mesh, cams, tile, chunk)
    args, offsets = as_exact(capped, chunk)
    ids, counts, origins, pack, words, dirs = args
    assert bool((_staged(args, offsets, T, tile, chunk, cap) > cap).any())
    out = tk.raster_tiles_split_reference(
        ids, counts, origins, pack, dirs, chunk=chunk, tiles_per_view=T,
        seg=1, bbox_words=words, stage_cap=cap, offsets=offsets)
    tv, tt, _, _, tf, _ = (a.numpy() for a in tk.decode_winners(*out, origins,
                                                                 dirs, T))
    c_ids, c_counts = capped[:2]
    pairs = c_ids.numpy().reshape(c_ids.shape[0], -1, 2)
    jout = pallas_raster.raster_tiles_pallas_compact(
        jnp.asarray((pairs[..., 0] | (pairs[..., 1] << 16)).reshape(-1)),
        jnp.asarray(c_counts.numpy()), jnp.asarray(origins.numpy()),
        jnp.asarray(pack.numpy()), jnp.asarray(words.numpy()),
        tuple(jnp.asarray(d.numpy()) for d in dirs), chunk=chunk,
        interpret=True, tiles_per_view=T, n1d=RES // tile, ccap=c_ids.shape[1],
        stage_cap=cap)
    jv, jt, _, _, jf, _ = (np.asarray(a) for a in jout)
    same = (tv == jv) & (~jv | (tf == jf))
    assert same.mean() >= 0.999, same.mean()
    agree = jv & tv & (tf == jf)
    assert agree.mean() > 0.15  # the strips cover 18% of their view
    np.testing.assert_allclose(tt[agree], jt[agree], atol=1e-4)


@pytest.mark.parametrize("seg", [0, -2])
def test_wrappers_refuse_a_seg_below_one(seg):
    """seg is checked before any dispatch, so also for CPU tensors."""
    _, tmesh, _, tcam = room_sphere_views(RES)
    (ids, counts, origins, pack, words, dirs), offsets, T = mixed_inputs(
        tmesh, tcam, 32, 64)
    kw = dict(chunk=64, tiles_per_view=T, offsets=offsets, seg=seg)
    with pytest.raises(ValueError, match="seg"):
        tk.raster_tiles_chunklist(ids, counts, origins, pack, dirs, **kw)
    with pytest.raises(ValueError, match="seg"):
        tk.raster_tiles_streamed(ids, counts, origins, chunk_major(pack, 64),
                                 dirs, bbox_words=words, **kw)
    with pytest.raises(ValueError, match="seg"):
        tk.raster_tiles_compact(ids, counts, origins, pack, words, dirs, **kw)


@pytest.mark.parametrize("seg", [1, 16])
@pytest.mark.parametrize("body", BODIES)
def test_segmented_fold_on_exact_lists_equals_sequential(body, seg):
    """On the card's exact lists (flat at row offsets, in a buffer of two
    slots a row that some longer rows overflow, so scanning every chunk)
    the segmented fold equals the sequential plain versions bit for bit,
    and the decoded outputs equal those from the capped encoding's
    lists."""
    _, tmesh, _, tcam = room_sphere_views(RES)
    tile, chunk = 16, 64
    args, offsets, T = exact_inputs(tmesh, tcam, tile, chunk, 2)
    ids, counts, origins, pack, words, dirs = args
    assert ids.dim() == 1 and bool((counts == -1).any()) and bool((counts > 2).any())
    capped, c_offsets, _ = mixed_inputs(tmesh, tcam, tile, chunk)
    kw = dict(chunk=chunk, tiles_per_view=T)
    cap = _cap(body)
    w = None if body in ("chunklist", "streamed") else words
    p = chunk_major(pack, chunk) if body.startswith("streamed") else pack

    def sequential(ids, counts, offsets):
        if body == "chunklist":
            return tk.raster_tiles_chunklist_reference(
                ids, counts, origins, pack, dirs, offsets=offsets, **kw)
        if body.startswith("compact"):
            return tk.raster_tiles_compact_reference(
                ids, counts, origins, pack, words, dirs, stage_cap=cap,
                offsets=offsets, **kw)
        return tk.raster_tiles_streamed_reference(
            ids, counts, origins, p, dirs, bbox_words=w, stage_cap=cap,
            offsets=offsets, **kw)

    want = sequential(ids, counts, offsets)
    got = tk.raster_tiles_split_reference(ids, counts, origins, p, dirs,
                                          seg=seg, bbox_words=w, stage_cap=cap,
                                          offsets=offsets, **kw)
    _assert_bitwise(got, want)
    dec = tk.decode_winners(*want, origins, dirs, T)
    dec_capped = tk.decode_winners(*sequential(capped[0], capped[1], c_offsets),
                                   origins, dirs, T)
    for g, c in zip(dec, dec_capped):
        assert torch.equal(g, c)
    assert bool((want[0] < tk.BIG_PACKED).any())
