"""omnidata_tpu_torch.mesh.raster and mesh.raster_kernels against the JAX
package. The JAX raster kernel runs as its own tests run it on the CPU:
Pallas in interpret mode.

Tolerances, from float32 arithmetic that the two frameworks order and
fuse differently:
- admission lists: exactly equal for the same overlap matrix;
- bboxes: rtol 1e-4, atol 1e-3 px;
- kernel and renderer: `valid` equal, and `face` equal where both are
  valid, on >= 99.9% of pixels; t within 1e-4 where the faces agree;
  interpolated attributes within 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.mesh import raster as jraster
from omnidata_tpu.mesh.pallas_raster import raster_tiles_pallas_chunklist
from omnidata_tpu_torch.mesh import raster as traster
from omnidata_tpu_torch.mesh import raster_kernels as tk
from omnidata_tpu_torch.utils import profiler

from _torch_port_util import (admission_lists, as_exact, capped_as_exact,
                              clustered_overlap, mixed_lists, pack_bits,
                              room_sphere_views, tile_admission, two_pass_fits)

torch.set_num_threads(1)

RES = 64
CHUNK = 64


@pytest.fixture(scope="module")
def scene():
    return room_sphere_views(RES)


def _face_agreement(tv, tf, jv, jf):
    """Fraction of pixels where valid agrees and, if valid, face agrees."""
    tv, tf, jv, jf = (np.asarray(a) for a in (tv, tf, jv, jf))
    same = (tv == jv) & (~jv | (tf == jf))
    return float(same.mean()), jv & tv & (tf == jf)


def test_face_screen_bboxes_match_jax(scene):
    jmesh, tmesh, jcam, tcam = scene
    lo, hi, live = traster.face_screen_bboxes(tcam, tmesh)
    for k in range(2):
        cam_k = jraster.Camera(jcam.location[k], jcam.R[k], jcam.fov[k], RES)
        jlo, jhi, jlive = jraster.face_screen_bboxes(cam_k, jmesh)
        np.testing.assert_array_equal(live[k].numpy(), np.asarray(jlive))
        m = np.asarray(jlive)
        assert m.sum() > 100
        np.testing.assert_allclose(lo[k].numpy()[m], np.asarray(jlo)[m],
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(hi[k].numpy()[m], np.asarray(jhi)[m],
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("hier, ccap, expand_bcap", [
    (False, 48, None), (False, 4, None), (True, 4, None), (True, 48, 1),
])
def test_admission_lists_match_jax(hier, ccap, expand_bcap):
    """The tests' capped encoding in plain PyTorch: the same overlap matrix
    -> identical ids and counts, in every encoding (exact, scan-all, block
    mode)."""
    rng = np.random.RandomState(7)
    rows, n_chunks = 40, 70
    dens = rng.uniform(0.0, 0.3, (rows, 1))
    overlap = rng.rand(rows, n_chunks) < dens
    overlap[:5] = False  # empty rows
    counts_true = overlap.sum(-1)
    want_ids, want_counts = jraster.admission_lists(
        jnp.asarray(overlap), jnp.asarray(counts_true), ccap, hier,
        expand_bcap=expand_bcap)
    ids, counts = admission_lists(
        torch.as_tensor(overlap), torch.as_tensor(counts_true), ccap, hier,
        expand_bcap=expand_bcap)
    assert ids.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))


ADMISSION_GRID = [(hier, ccap, eb) for hier in (False, True)
                  for ccap in (8, 48, 192) for eb in (1, 32)]


@pytest.mark.parametrize("hier, ccap, expand_bcap", ADMISSION_GRID)
def test_admission_rows_reference_matches_admission_lists(hier, ccap, expand_bcap):
    """The rows kernels' algorithm in plain PyTorch, on the overlap matrix
    packed as bits, gives every row that admission_lists lists exactly
    (count >= 0) the same ascending list at its offset, and every row, the
    block-mode and scan-all ones too, its exact list; n_chunks 4,001 (not a
    multiple of 8 or 32) in a buffer of rows * ccap slots, past which only
    rows longer than ccap scan every chunk."""
    overlap = clustered_overlap(np.random.RandomState(11), 140, 4001)
    want_ids, want_counts = admission_lists(
        overlap, overlap.sum(-1), ccap, hier, expand_bcap=expand_bcap)
    ids, counts, offsets = traster.admission_rows_reference(
        pack_bits(overlap), 4001, ccap)
    assert ids.dtype == counts.dtype == offsets.dtype == torch.int32
    assert ids.shape == (140 * ccap,)
    n = overlap.sum(1)
    fits = two_pass_fits(n, ccap)
    assert torch.equal(counts, torch.where(fits, n, -1).int())
    for r in range(140):
        got = ids[offsets[r]:offsets[r] + counts[r]]
        if counts[r] >= 0:
            assert torch.equal(got, torch.nonzero(overlap[r])[:, 0].int()), r
        if want_counts[r] >= 0 and counts[r] >= 0:
            assert torch.equal(got, want_ids[r, :want_counts[r]]), r
    c = want_counts.numpy()
    assert (c >= 0).any() and (c == -1).any() and ((c <= -2).any() == hier)
    overflowing = (want_counts < 0) & (counts >= 0)  # capped: stand-ins
    assert bool(overflowing.any())


def test_exact_lists_list_every_set_chunk_in_order():
    """The card's encoding, plainly, in a buffer of rows * ccap slots: the
    rows of at most ccap chunks first, at the exclusive prefix sums of
    their counts, then the longer rows; each row's list exactly its set
    chunks ascending; the slots past the last list zero; the longer rows
    that do not fit (and every later longer row) scan all chunks and list
    nothing."""
    overlap = clustered_overlap(np.random.RandomState(5), 70, 1000)
    n = overlap.sum(1)
    for ccap in (int(n.max()), 16, 8):
        ids, counts, offsets = traster.exact_lists(overlap, ccap)
        short = n <= ccap
        fits = two_pass_fits(n, ccap)
        assert torch.equal(counts.long(), torch.where(fits, n, -1))
        assert bool(fits.all()) == (ccap == int(n.max()))
        ns, nl = torch.where(short, n, 0), torch.where(short, 0, n)
        starts = torch.where(short, ns.cumsum(0) - ns,
                             ns.sum() + nl.cumsum(0) - nl)
        assert torch.equal(offsets.long(), torch.clamp(starts, max=70 * ccap))
        used = int(torch.where(fits, n, 0).sum())
        assert not ids[used:].any()
        trip, chunk_of = tk.chunk_schedule(ids, counts, 1000, offsets)
        for r in range(70):  # rows decoded at their offsets
            seq = [int(chunk_of(i)[r]) for i in range(int(trip[r]))]
            want = (torch.nonzero(overlap[r])[:, 0].tolist() if fits[r]
                    else list(range(1000)))
            assert seq == want, r


def test_exact_lists_keep_short_rows_past_a_full_buffer():
    """A buffer that the longer rows overflow: every row of at most ccap
    chunks, those after the first refused row too, keeps its exact list,
    and only longer rows scan all chunks."""
    overlap = clustered_overlap(np.random.RandomState(5), 70, 1000)
    n = overlap.sum(1)
    ids, counts, offsets = traster.exact_lists(overlap, 8)
    refused = torch.nonzero(counts == -1)[:, 0]
    assert refused.numel() > 0 and bool((n[refused] > 8).all())
    later_short = torch.nonzero((n <= 8) & (torch.arange(70) > refused[0]))[:, 0]
    assert later_short.numel() > 0 and bool((n[later_short] > 0).any())
    for r in later_short.tolist():
        got = ids[offsets[r]:offsets[r] + counts[r]]
        assert torch.equal(got, torch.nonzero(overlap[r])[:, 0].int()), r
    # the rows kernels' plain version on the same overlap agrees
    again = traster.admission_rows_reference(pack_bits(overlap), 1000, 8)
    for g, w in zip(again, (ids, counts, offsets)):
        assert torch.equal(g, w)


def test_admission_refuses_what_no_kernel_takes(scene):
    """A device with no kernels (meta) raises rather than take the plain
    path, as does a resolution whose tiles the bbox words cannot hold;
    nothing is launched."""
    _, tmesh, _, tcam = scene
    meta = dict(vertices=tmesh.vertices.to("meta"), faces=tmesh.faces.to("meta"))
    mmesh = tmesh._replace(**meta)
    mcam = dataclasses.replace(tcam, location=tcam.location.to("meta"),
                               R=tcam.R.to("meta"), fov=tcam.fov.to("meta"))
    before = traster.admission.launches
    with pytest.raises(ValueError, match="no kernel for meta"):
        traster.admission(mcam, mmesh, 16, 64, 8)
    with pytest.raises(ValueError, match="raise the tile size"):
        traster.admission(dataclasses.replace(mcam, resolution=4096), mmesh, 8, 64,
                          8, compact=True)
    assert traster.admission.launches == before


def _jax_admission(lo, hi, res, tile, chunk, ccap, hier, expand_bcap):
    """The JAX package's admission (render_views_fused: the separable
    overlap as a bf16 einsum, then admission_lists) on the port's padded
    bboxes."""
    lo, hi = jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())
    n1d = res // tile
    K, Fp = lo.shape[:2]
    n_chunks = Fp // chunk
    txs = jnp.arange(n1d) * tile
    ov_x = (hi[..., 0:1] >= txs[None, None]) & (lo[..., 0:1] <= txs[None, None] + tile)
    ov_y = (hi[..., 1:2] >= txs[None, None]) & (lo[..., 1:2] <= txs[None, None] + tile)
    cnt = jnp.einsum("bfy,bfx->byx",
                     ov_y.reshape(K * n_chunks, chunk, n1d).astype(jnp.bfloat16),
                     ov_x.reshape(K * n_chunks, chunk, n1d).astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    overlap = (cnt > 0).reshape(K, n_chunks, n1d * n1d).transpose(0, 2, 1)
    return jraster.admission_lists(
        overlap.reshape(-1, n_chunks), overlap.sum(-1).reshape(-1), ccap, hier,
        expand_bcap=expand_bcap)


@pytest.mark.parametrize("tile, chunk, ccap, hier_min, expand_bcap, compact", [
    (16, 64, 4, 1, 1, True), (16, 64, 8, 10**9, None, True),
    (32, 64, 48, None, None, False), (8, 16, 8, 1, 32, True),
    (64, 64, 192, 1, 32, True), (32, 48, 8, 1, None, True),
])
def test_prepare_raster_admission_matches_plain_and_jax(
        scene, tile, chunk, ccap, hier_min, expand_bcap, compact):
    """prepare_raster on CPU tensors admits through the plain version of
    the card's admission (admission_exact_reference) exactly; every row that
    the JAX package's capped admission (hier_min and expand_bcap on its
    side only) lists exactly has the same chunks in the port's exact list,
    each of its block-mode rows lists the blocks of the port's list, and
    each of its scan-all rows is longer than its cap in the port's; the
    words equal the JAX package's word formula on the same bboxes; chunk 48
    leaves padding past the mesh's faces."""
    jmesh, tmesh, _, tcam = scene
    inp = traster.prepare_raster(tcam, tmesh, tile, chunk, ccap=ccap,
                                 compact=compact)
    n_chunks = -(-tmesh.faces.shape[0] // chunk)
    ccap = min(ccap, n_chunks)
    want = traster.admission_exact_reference(tcam, tmesh, tile, chunk, ccap,
                                             compact)
    for g, w in zip((inp.ids, inp.counts, inp.bbox_words, inp.offsets), want):
        assert (g is None and w is None) or torch.equal(g, w)
    lo, hi = traster.padded_bboxes(tcam, tmesh, chunk)
    assert (inp.bbox_words is None) != compact
    if compact:
        jlo, jhi = jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())

        def q(x, step):
            return jnp.clip(jnp.floor(x / step), 0, 255).astype(jnp.int32)

        words = (q(jlo - 1.0, tile)[..., 0] | (q(jhi + 1.0, tile)[..., 0] << 8)
                 | (q(jlo - 1.0, 8.0)[..., 1] << 16) | (q(jhi + 1.0, 8.0)[..., 1] << 24))
        np.testing.assert_array_equal(inp.bbox_words.numpy(), np.asarray(words))
    hier = n_chunks > (jraster.HIER_ADMISSION_MIN_CHUNKS if hier_min is None
                       else hier_min)
    want_ids, want_counts = (np.asarray(a) for a in _jax_admission(
        lo, hi, RES, tile, chunk, ccap, hier, expand_bcap))
    assert (want_counts != 0).any()
    cap = ccap  # the longest list JAX's admission holds exactly
    if hier:  # its stage 2 sorts the chunks of at most bcap2 blocks
        eb = jraster.EXPAND_BCAP if expand_bcap is None else expand_bcap
        cap = min(ccap, min(ccap, -(-n_chunks // 8), eb) * 8)
    ids, counts, offsets = (a.numpy() for a in (inp.ids, inp.counts, inp.offsets))
    for r in range(counts.size):
        mine = ids[offsets[r]:offsets[r] + counts[r]]
        if want_counts[r] >= 0:  # listed exactly: the same list
            assert counts[r] == want_counts[r], r
            np.testing.assert_array_equal(mine, want_ids[r, :want_counts[r]])
        elif want_counts[r] == -1:  # scan-all: longer than JAX's cap
            assert counts[r] == -1 or counts[r] > cap, r
        elif counts[r] >= 0:  # block mode: the same 8-chunk blocks
            np.testing.assert_array_equal(np.unique(mine // 8),
                                          want_ids[r, :-want_counts[r] - 2])


def test_admission_on_cpu_is_the_plain_version(scene):
    _, tmesh, _, tcam = scene
    before = traster.admission.launches
    got = traster.admission(tcam, tmesh, 16, 64, 8, compact=True)
    want = traster.admission_exact_reference(tcam, tmesh, 16, 64, 8,
                                             compact=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert traster.admission.launches == before


def _kernel_inputs(tmesh, tcam, tile):
    """Mixed admission lists (exact, scan-all and block-mode rows, ccap 4)
    plus rays and the scene pack with the vertex normals as attributes:
    the capped lists (for the JAX package), then the same as exact lists
    with their offsets (for the port)."""
    args, T = mixed_lists(tmesh, tcam, tile, CHUNK)
    (ids, counts, origins, pack, _, dirs), offsets = as_exact(args, CHUNK)
    return args[0], args[1], ids, counts, offsets, origins, pack, dirs, T


def test_kernel_reference_matches_pallas_interpret(scene):
    """The plain version of the raster kernel + decode against the Pallas
    chunk-list kernel (interpret mode) on identical lists and inputs."""
    _, tmesh, _, tcam = scene
    tile = 16
    capped, c_counts, ids, counts, offsets, origins, pack, dirs, T = (
        _kernel_inputs(tmesh, tcam, tile))
    c = c_counts.numpy()
    assert (c >= 0).any() and (c == -1).any() and (c <= -2).any(), c

    packed, acc = tk.raster_tiles_chunklist_reference(
        ids, counts, origins, pack, dirs, chunk=CHUNK, tiles_per_view=T,
        offsets=offsets)
    assert packed.dtype == torch.int32 and acc.dtype == torch.float32
    assert acc.shape == (counts.shape[0], pack.shape[0], tile * tile)
    tv, tt, tu, tvv, tf, ta = tk.decode_winners(packed, acc, origins, dirs, T)

    pairs = capped.numpy().reshape(capped.shape[0], -1, 2)
    clist = (pairs[..., 0] | (pairs[..., 1] << 16)).reshape(-1)
    jv, jt, ju, jvv, jf, ja = raster_tiles_pallas_chunklist(
        jnp.asarray(clist), jnp.asarray(c), jnp.asarray(origins.numpy()),
        jnp.asarray(pack.numpy()), tuple(jnp.asarray(d.numpy()) for d in dirs),
        chunk=CHUNK, interpret=True, tiles_per_view=T, ccap=4)

    frac, agree = _face_agreement(tv.numpy(), tf.numpy(), jv, jf)
    assert frac >= 0.999, frac
    assert agree.sum() > 0.3 * agree.size
    np.testing.assert_allclose(tt.numpy()[agree], np.asarray(jt)[agree], atol=1e-4)
    np.testing.assert_allclose(ta.numpy()[agree], np.asarray(ja)[agree], atol=1e-4)
    # misses carry no columns
    assert not acc.permute(0, 2, 1).numpy()[~tv.numpy()].any()


def test_chunk_schedule_decodes_every_encoding():
    """Each capped encoding given as exact lists (capped_as_exact), then
    decoded: a listed row keeps its chunks, a block-mode row lists its
    blocks' chunks below n_chunks (the tail of the last block dropped), a
    scan-all row sweeps every chunk."""
    ids = torch.tensor([[3, 5, 9, 0], [1, 2, 0, 0], [0, 0, 0, 0]],
                       dtype=torch.int32)
    counts = torch.tensor([3, -4, -1], dtype=torch.int32)  # exact, 2 blocks, all
    flat, counts, offsets = capped_as_exact(ids, counts, 20)
    assert counts.tolist() == [3, 12, -1] and offsets.tolist() == [0, 3, 15]
    trip, chunk_of = tk.chunk_schedule(flat, counts, 20, offsets)
    assert trip.tolist() == [3, 12, 20]
    seq = torch.stack([chunk_of(i) for i in range(20)], 1)
    assert seq[0, :3].tolist() == [3, 5, 9]
    assert seq[1, :12].tolist() == list(range(8, 20))
    assert seq[2].tolist() == list(range(20))


@pytest.mark.parametrize("hier_min_chunks, ccap", [(None, None), (1, 4)])
def test_render_views_fused_matches_jax(scene, hier_min_chunks, ccap):
    """The render stage end to end (bboxes, admission, kernel, decode,
    untile, z) against the JAX renderer with the Pallas kernel (interpret);
    hier_min_chunks is the JAX side's option."""
    jmesh, tmesh, jcam, tcam = scene
    kw = dict(tile=32, chunk=CHUNK, ccap=ccap)
    jf, ja = jraster.render_views_fused(
        jcam, jmesh, interpret=True, vertex_attrs=jmesh.vertex_normals,
        hier_min_chunks=hier_min_chunks, **kw)
    tf, ta = traster.render_views_fused(
        tcam, tmesh, vertex_attrs=tmesh.vertex_normals, **kw)
    assert tf.t.shape == (2, RES, RES) and ta.shape == (2, RES, RES, 3)
    frac, agree = _face_agreement(tf.valid.numpy(), tf.face.numpy(),
                                  jf.valid, jf.face)
    assert frac >= 0.999, frac
    assert agree.mean() > 0.9
    for name in ("t", "z"):
        np.testing.assert_allclose(getattr(tf, name).numpy()[agree],
                                   np.asarray(getattr(jf, name))[agree], atol=1e-4)
    np.testing.assert_allclose(tf.bary.numpy()[agree], np.asarray(jf.bary)[agree],
                               atol=1e-4)
    np.testing.assert_allclose(ta.numpy()[agree], np.asarray(ja)[agree], atol=1e-4)


def test_wrapper_takes_plain_version_only_for_cpu_tensors(scene):
    _, tmesh, _, tcam = scene
    _, _, ids, counts, offsets, origins, pack, dirs, T = _kernel_inputs(
        tmesh, tcam, 32)
    kw = dict(chunk=CHUNK, tiles_per_view=T, offsets=offsets)
    before = tk.raster_tiles_chunklist.launches
    got = tk.raster_tiles_chunklist(ids, counts, origins, pack, dirs, **kw)
    want = tk.raster_tiles_chunklist_reference(ids, counts, origins, pack, dirs,
                                               **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tk.raster_tiles_chunklist.launches == before  # no kernel launched
    meta = [t.to("meta") for t in (ids, counts, origins, pack)]
    with pytest.raises(ValueError, match="no kernel"):
        tk.raster_tiles_chunklist(*meta, tuple(d.to("meta") for d in dirs),
                                  chunk=CHUNK, tiles_per_view=T,
                                  offsets=offsets.to("meta"))
    with pytest.raises(ValueError, match="int32"):
        tk.raster_tiles_chunklist(ids.long(), counts, origins, pack, dirs, **kw)


def _capped_admission(cameras, mesh, tile, chunk, ccap, compact=False):
    """``raster.admission`` as the JAX package admits, hierarchical: the
    capped encoding (``tile_admission``, with block-mode and scan-all rows)
    given as exact lists, and the bbox words when compact."""
    ids, counts = tile_admission(cameras, mesh, tile, chunk, ccap, 1)
    n_chunks = -(-mesh.faces.shape[0] // chunk)
    ids, counts, offsets = capped_as_exact(ids, counts, n_chunks)
    lo, hi = traster.padded_bboxes(cameras, mesh, chunk)
    words = (traster.bbox_words(lo, hi, cameras.resolution, tile)
             if compact else None)
    return traster.Admission(ids, counts, words, offsets)


KERNEL_ROUTES = [{}, dict(compact=True), dict(streamed=True)]
ROUTE_IDS = ["chunklist", "compact", "streamed_compact"]


def _render_both(scene, monkeypatch, kw, ccap):
    """render_views_fused at tile 8 on the capped lists (ccap 4,
    hierarchical: the capped encoding's block-mode and scan-all rows) and on
    the port's own exact lists at ccap; -> (capped, exact, recorder counters
    of the exact run, exact counts, the rows' set counts, list slots)."""
    _, tmesh, _, tcam = scene
    args = (tcam, tmesh, 8, CHUNK, tmesh.vertex_normals)
    c = tile_admission(tcam, tmesh, 8, CHUNK, 4, 1)[1]
    assert bool((c == -1).any()) and bool((c <= -2).any())
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = traster.render_views_fused(*args, ccap=ccap, **kw)
    counters = {k: v["total"] for k, v in profiler.summary()["counters"].items()}
    profiler.reset()
    with monkeypatch.context() as m:
        m.setattr(traster, "admission", _capped_admission)
        want = traster.render_views_fused(*args, ccap=4, **kw)
    n_chunks = -(-tmesh.faces.shape[0] // CHUNK)
    lo, hi = traster.padded_bboxes(tcam, tmesh, CHUNK)
    n = traster.tile_overlap(lo, hi, tcam.resolution, 8, CHUNK).sum(1)
    counts = traster.prepare_raster(tcam, tmesh, 8, CHUNK, ccap=ccap).counts
    slots = traster.list_slots(min(ccap, n_chunks), n_chunks)
    return want, got, counters, counts, n, slots


@pytest.mark.parametrize("kw", KERNEL_ROUTES, ids=ROUTE_IDS)
def test_render_views_fused_exact_lists_equal_capped(scene, monkeypatch, kw):
    """The port's admission, every row's exact list (all fit at a ccap of
    every chunk), in place of the capped encoding's block-mode and scan-all
    stand-ins: the decoded outputs equal bit for bit, and no row is counted
    on a stand-in encoding."""
    want, got, counters, counts, _, _ = _render_both(scene, monkeypatch, kw, 64)
    assert bool((counts >= 0).all())
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(g, w)
    assert counters["raster.rows_block"] == counters["raster.rows_scan_all"] == 0
    assert counters["raster.rows_fused"] == 0  # no kernel on the CPU


@pytest.mark.parametrize("kw", KERNEL_ROUTES, ids=ROUTE_IDS)
def test_exact_lists_past_the_capacity_scan_all(scene, monkeypatch, kw):
    """The port's admission at ccap 1, a buffer of list_slots(1, 63) = 2
    slots a row, which the longer rows overflow: the rows past it, longer
    rows only, scan every chunk, are counted in raster.rows_scan_all, and
    the outputs still equal the capped encoding's."""
    want, got, counters, counts, n, slots = _render_both(
        scene, monkeypatch, kw, 1)
    assert slots == 2
    n_scan = int((counts == -1).sum())
    assert 0 < n_scan < counts.numel()
    assert bool((n[counts == -1] > slots).all())  # longer rows alone
    assert bool((counts[n <= slots] >= 0).all())
    assert counters["raster.rows_scan_all"] == n_scan
    assert counters["raster.rows_block"] == 0
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(g, w)
