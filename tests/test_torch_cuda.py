"""Card-only tests of the CUDA raster kernels: each bit-exact against its
plain PyTorch version on the same CUDA tensors, on the card's exact lists
(at row offsets; scan-all rows past the buffer) and on the JAX package's
capped lists given as exact ones (``_torch_port_util.capped_as_exact``),
and for the
pixel-per-thread layouts of tiles 8 to 64; the admission kernels against
the plain version of the card's admission, also past 2^31 rows x chunks;
the compacting bodies also at a stage cap small enough to force the
raw-list fallback and with a block-mode row whose tail runs past the last
chunk; kernels A, B and C
also with their work items cut to 1 and 3 list positions, so that every
multi-chunk row is split across CTAs and merged. A refused launch raises.
Then plain-PyTorch paths of the port on the card against the CPU: the host
cues' device prefixes, DPT's forward, and one training step each of DPT
(depth, both sides of the schedule switch) and the UNet (normals); the
evaluation metrics, normal TTA, one forward of each multi-task
architecture and of HRNet-W18, and one multi-task step with its per-task
gradient norms; each MiDaS net's forward (also midas_v21 on a transformed
640x480 image) and the refocus augmentation; the per-view renderer, the
per-view annotator on kernel A and the sharded annotator. And the keypoints2d
kernel bit for bit against its plain version on the same CUDA tensors, at
the cell's shape, at one view, on ragged and small images, past its staged
halo and at the most scales one launch takes, with its launch count, its
profiler counter and the inputs its entry point refuses.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports no JAX, so on a machine with a card
and without JAX it runs on its own:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``.
"""
import importlib

import numpy as np
import pytest
import torch

from omnidata_tpu_torch._build import call_kernel
from omnidata_tpu_torch.core.cameras import Camera, extrinsic_RT, look_at_rotation
from omnidata_tpu_torch.mesh import from_arrays, room, uv_sphere
from omnidata_tpu_torch.mesh import raster as traster
from omnidata_tpu_torch.mesh import raster_kernels as tk

from _torch_port_util import (as_exact, chunk_major, exact_inputs,
                              mixed_inputs, mixed_lists, tile_admission,
                              two_pass_fits, with_block_tail)

pytestmark = pytest.mark.cuda

RES = 64
CHUNK = 64


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernel, no CPU mode)")
    r = room(size=6.0, height=3.0)
    s = uv_sphere(radius=0.7, center=(0.6, 0.1, 1.2), n_lat=32, n_lon=64)
    vs = np.concatenate([r.vertices.numpy(), s.vertices.numpy()])
    fs = np.concatenate([r.faces[: r.num_faces].numpy(),
                         s.faces[: s.num_faces].numpy() + r.vertices.shape[0]])
    rng = np.random.RandomState(0)
    mesh = from_arrays(vs, fs, vertex_colors=rng.rand(len(vs), 3), device="cuda")
    locs = torch.tensor([[1.1, 0.5, 1.4], [-0.8, 0.9, 1.6]], device="cuda")
    tgts = torch.tensor([[0.3, 0.0, 1.0], [0.5, -0.3, 0.8]], device="cuda")
    cams = Camera(locs, look_at_rotation(locs, tgts),
                  torch.tensor([1.2, 1.0], device="cuda"), RES)
    return mesh, cams


def _tail_inputs(mesh, cams, tile):
    """``mixed_lists`` with a block-mode row whose last block runs past the
    last chunk (the scene cut to end in it), as exact lists -> (args,
    offsets, tiles_per_view, n_chunks)."""
    args, T = mixed_lists(mesh, cams, tile, CHUNK)
    args, _, n_chunks = with_block_tail(args, T, CHUNK)
    return (*as_exact(args, CHUNK), T, n_chunks)


def _assert_bitwise(got, want):
    packed, acc = got
    want_packed, want_acc = want
    assert torch.equal(packed, want_packed)
    assert torch.equal(acc.view(torch.int32), want_acc.view(torch.int32))


@pytest.mark.parametrize("tile", [8, 16, 32, 64])  # 1, 1, 4, 16 px/thread
def test_kernel_matches_plain_version_bitwise(cuda_scene, tile):
    mesh, cams = cuda_scene
    (ids, counts, origins, pack, _, dirs), offsets, T = mixed_inputs(
        mesh, cams, tile, CHUNK)
    args = (ids, counts, origins, pack, dirs)
    if tile == 16:
        c = mixed_lists(mesh, cams, tile, CHUNK)[0][1].cpu()
        assert (c >= 0).any() and (c == -1).any() and (c <= -2).any(), c
    kw = dict(chunk=CHUNK, tiles_per_view=T, offsets=offsets)
    before = tk.raster_tiles_chunklist.launches
    got = tk.raster_tiles_chunklist(*args, **kw)
    torch.cuda.synchronize()
    assert tk.raster_tiles_chunklist.launches == before + 1
    _assert_bitwise(got, tk.raster_tiles_chunklist_reference(*args, **kw))
    assert (got[0] < tk.BIG_PACKED).float().mean() > 0.9


def _staged(body: str, plain: bool, args, offsets, T):
    """Kernel B or C (plain body, compacting body, or compacting at stage
    cap 64) on mixed-list inputs, or its plain version."""
    ids, counts, origins, pack, words, dirs = args
    kw = dict(chunk=CHUNK, tiles_per_view=T, offsets=offsets)
    if body.startswith("compact"):
        fn = tk.raster_tiles_compact_reference if plain else tk.raster_tiles_compact
        cap = 64 if body.endswith("64") else tk.STAGE_CAP
        return fn(ids, counts, origins, pack, words, dirs, stage_cap=cap, **kw)
    fn = tk.raster_tiles_streamed_reference if plain else tk.raster_tiles_streamed
    cap = 64 if body.endswith("64") else tk.STREAMED_STAGE_CAP
    return fn(ids, counts, origins, chunk_major(pack, CHUNK), dirs,
              bbox_words=None if body == "streamed" else words, stage_cap=cap,
              **kw)


STAGED_BODIES = ["compact", "compact_cap64", "streamed", "streamed_compact",
                 "streamed_compact_cap64"]


@pytest.mark.parametrize("body", STAGED_BODIES)
@pytest.mark.parametrize("tile", [8, 16, 32, 64])
def test_staged_kernels_match_plain_versions_bitwise(cuda_scene, tile, body):
    """Kernels B and C with a block-mode row whose last block runs past the
    last chunk (given as exact lists, its chunks below the last one)."""
    mesh, cams = cuda_scene
    args, offsets, T, n_chunks = _tail_inputs(mesh, cams, tile)
    wrapper = tk.raster_tiles_compact if body.startswith("compact") \
        else tk.raster_tiles_streamed
    before = wrapper.launches
    got = _staged(body, False, args, offsets, T)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_bitwise(got, _staged(body, True, args, offsets, T))
    assert (got[0] < tk.BIG_PACKED).float().mean() > 0.4  # cut scene
    if body.endswith("64") and tile >= 16:  # some rows take the fallback
        staged, _ = tk.stage_faces(args[0], args[1], args[4], n_chunks, CHUNK, T,
                                   tile, 64, offsets=offsets)
        assert bool((staged > 64).any()) and bool((staged <= 64).any())


SPLIT_BODIES = ["chunklist", "streamed", "streamed_compact",
                "streamed_compact_cap64", "compact", "compact_cap64"]


@pytest.mark.parametrize("seg", [1, 3])
@pytest.mark.parametrize("body", SPLIT_BODIES)
@pytest.mark.parametrize("tile", [8, 16, 32, 64])
def test_split_items_match_plain_versions_bitwise(cuda_scene, tile, body, seg):
    """Kernels A, B and C at segments of seg list positions: rows longer
    than seg (past the cap, for the compacting bodies) are swept by several
    CTAs and merged; the result is the sequential plain version's, bit for
    bit, and the item list the launch built on the card (and the count
    pass's staged faces) equal split_schedule's (and stage_faces') bit for
    bit."""
    mesh, cams = cuda_scene
    args, offsets, T, n_chunks = _tail_inputs(mesh, cams, tile)
    ids, counts, origins, pack, words, dirs = args
    kw = dict(chunk=CHUNK, tiles_per_view=T, offsets=offsets)
    if body == "chunklist":
        wrapper = tk.raster_tiles_chunklist
        got = wrapper(ids, counts, origins, pack, dirs, seg=seg, **kw)
        want = tk.raster_tiles_chunklist_reference(ids, counts, origins, pack,
                                                   dirs, **kw)
        staged = None
    elif body.startswith("compact"):
        wrapper = tk.raster_tiles_compact
        cap = 64 if body.endswith("64") else tk.STAGE_CAP
        got = wrapper(ids, counts, origins, pack, words, dirs, stage_cap=cap,
                      seg=seg, **kw)
        want = tk.raster_tiles_compact_reference(ids, counts, origins, pack,
                                                 words, dirs, stage_cap=cap,
                                                 **kw)
        staged = tk.stage_faces(ids, counts, words, n_chunks, CHUNK, T, tile,
                                cap, offsets=offsets)[0]
    else:
        wrapper = tk.raster_tiles_streamed
        cap = 64 if body.endswith("64") else tk.STREAMED_STAGE_CAP
        w = None if body == "streamed" else words
        cm = chunk_major(pack, CHUNK)
        got = wrapper(ids, counts, origins, cm, dirs, bbox_words=w,
                      stage_cap=cap, seg=seg, **kw)
        want = tk.raster_tiles_streamed_reference(ids, counts, origins, cm,
                                                  dirs, bbox_words=w,
                                                  stage_cap=cap, **kw)
        staged = None if w is None else tk.stage_faces(
            ids, counts, words, n_chunks, CHUNK, T, tile, cap,
            offsets=offsets)[0]
    torch.cuda.synchronize()
    _assert_bitwise(got, want)
    sched = wrapper.last_schedule
    ref = tk.split_schedule(counts, staged, n_chunks, seg, CHUNK,
                            cap if staged is not None else tk.STREAMED_STAGE_CAP)
    for name in ("order", "ends", "n_items"):
        assert torch.equal(getattr(sched, name), getattr(ref, name)), name
    if staged is not None:
        assert torch.equal(sched.staged.long(), staged)
    if body in ("chunklist", "streamed") or (body.endswith("64") and tile >= 16):
        assert bool((sched.n_items > 1).any())  # some row really was split


@pytest.mark.parametrize("body", ["chunklist", "streamed_compact", "compact"])
def test_schedule_of_many_rows_matches_split_schedule(cuda_scene, body):
    """5,120 rows (the 2 views repeated 40 times at tile 8): the schedule
    CTA walks 5 tiles of 1,024 rows; its item list equals split_schedule's
    and the result the plain version's, bit for bit."""
    mesh, cams = cuda_scene
    args, offsets, T, n_chunks = _tail_inputs(mesh, cams, 8)
    ids, counts, origins, pack, words, dirs = args
    counts, offsets, origins, words = (x.repeat((40,) + (1,) * (x.dim() - 1))
                                       for x in (counts, offsets, origins, words))
    dirs = tuple(d.repeat(40, 1) for d in dirs)
    kw = dict(chunk=CHUNK, tiles_per_view=T, offsets=offsets)
    seg = 8
    staged = None
    if body == "chunklist":
        wrapper = tk.raster_tiles_chunklist
        got = wrapper(ids, counts, origins, pack, dirs, seg=seg, **kw)
        want = tk.raster_tiles_chunklist_reference(ids, counts, origins, pack,
                                                   dirs, **kw)
    elif body == "compact":
        wrapper = tk.raster_tiles_compact
        got = wrapper(ids, counts, origins, pack, words, dirs, stage_cap=64,
                      seg=seg, **kw)
        want = tk.raster_tiles_compact_reference(ids, counts, origins, pack,
                                                 words, dirs, stage_cap=64,
                                                 **kw)
        staged = tk.stage_faces(ids, counts, words, n_chunks, CHUNK, T, 8, 64,
                                offsets=offsets)[0]
    else:
        wrapper = tk.raster_tiles_streamed
        cm = chunk_major(pack, CHUNK)
        got = wrapper(ids, counts, origins, cm, dirs, bbox_words=words,
                      stage_cap=64, seg=seg, **kw)
        want = tk.raster_tiles_streamed_reference(ids, counts, origins, cm, dirs,
                                                  bbox_words=words, stage_cap=64,
                                                  **kw)
        staged = tk.stage_faces(ids, counts, words, n_chunks, CHUNK, T, 8, 64,
                                offsets=offsets)[0]
    torch.cuda.synchronize()
    assert counts.shape[0] == 5120
    _assert_bitwise(got, want)
    ref = tk.split_schedule(counts, staged, n_chunks, seg, CHUNK, 64)
    for name in ("order", "ends", "n_items"):
        assert torch.equal(getattr(wrapper.last_schedule, name),
                           getattr(ref, name)), name
    # several cost buckets to sort, and rows split
    cost = torch.clamp(tk.list_trips(counts, n_chunks), max=seg) * CHUNK
    if staged is not None:
        cost = torch.where(staged <= 64, staged, cost)
    assert tk.cost_bucket(cost).unique().numel() > 1
    assert bool((ref.n_items > 1).any())


def test_seg_below_one_is_refused(cuda_scene):
    """A split below one list position a segment is refused before any
    launch."""
    mesh, cams = cuda_scene
    (ids, counts, origins, pack, _, dirs), offsets, T = mixed_inputs(
        mesh, cams, 32, CHUNK)
    before = tk.raster_tiles_chunklist.launches
    for seg in (0, -1):
        with pytest.raises(ValueError, match="seg"):
            tk.raster_tiles_chunklist(ids, counts, origins, pack, dirs,
                                      chunk=CHUNK, tiles_per_view=T, seg=seg,
                                      offsets=offsets)
    assert tk.raster_tiles_chunklist.launches == before


def test_refused_launch_raises(cuda_scene):
    """3 pixels per thread is no kernel instantiation: the C side refuses
    the launch and the wrapper raises."""
    mesh, cams = cuda_scene
    (ids, counts, origins, pack, _, dirs), offsets, T = mixed_inputs(
        mesh, cams, 32, CHUNK)
    dirs = tuple(d[:, :768].contiguous() for d in dirs)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk.raster_tiles_chunklist(ids, counts, origins, pack, dirs,
                                  chunk=CHUNK, tiles_per_view=T, offsets=offsets)


@pytest.mark.parametrize("body", STAGED_BODIES)
def test_staged_refused_launch_raises(cuda_scene, body):
    """Tile 4 gives 16 threads, not whole warps: the C side refuses every
    body (pass 1 ballots with whole warps) and the wrapper raises."""
    mesh, cams = cuda_scene
    args, offsets, T = mixed_inputs(mesh, cams, 4, CHUNK)
    wrapper = tk.raster_tiles_compact if body.startswith("compact") \
        else tk.raster_tiles_streamed
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        _staged(body, False, args, offsets, T)
    assert wrapper.launches == before


def test_stage_cap_past_shared_memory_raises(cuda_scene):
    mesh, cams = cuda_scene
    (ids, counts, origins, pack, words, dirs), offsets, T = mixed_inputs(
        mesh, cams, 32, CHUNK)
    kw = dict(chunk=CHUNK, tiles_per_view=T, offsets=offsets)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk.raster_tiles_compact(ids, counts, origins, pack, words, dirs,
                                stage_cap=1 << 17, **kw)
    # the refusal leaves no error behind for the next launch
    tk.raster_tiles_compact(ids, counts, origins, pack, words, dirs, **kw)
    torch.cuda.synchronize()


def _admission_scene(device):
    """Room and three spheres: 32,492 faces padded to 32,493, not a multiple
    of 128 (254 chunks of 128)."""
    parts = [room(size=6.0, height=3.0),
             uv_sphere(radius=0.7, center=(0.6, 0.1, 1.2), n_lat=64, n_lon=128),
             uv_sphere(radius=0.5, center=(-1.4, 1.0, 1.5), n_lat=64, n_lon=128),
             uv_sphere(radius=0.2, center=(2.0, -2.2, 0.6), n_lat=8, n_lon=16)]
    vs, fs, base = [], [], 0
    for m in parts:
        vs.append(m.vertices.numpy())
        fs.append(m.faces[: m.num_faces].numpy() + base)
        base += m.vertices.shape[0]
    return from_arrays(np.concatenate(vs), np.concatenate(fs), pad_multiple=1,
                       device=device)


def _admission_views(k, res, device, seed=0):
    """k cameras inside the room, looking every way."""
    rng = np.random.RandomState(seed)
    locs = torch.tensor(rng.uniform([-2.4, -2.4, 0.3], [2.4, 2.4, 2.7], (k, 3)),
                        dtype=torch.float32, device=device)
    tgts = locs + torch.tensor(rng.normal(size=(k, 3)), dtype=torch.float32,
                               device=device)
    fov = torch.tensor(rng.uniform(0.6, 1.8, k), dtype=torch.float32, device=device)
    return Camera(locs, look_at_rotation(locs, tgts), fov, res)


@pytest.fixture(scope="module")
def admission_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernel, no CPU mode)")
    return _admission_scene("cuda")


def _face_kinds(mesh, cams):
    """Faces straddling the near plane, wholly behind it, and in front but
    off screen, summed over the views."""
    RT = extrinsic_RT(cams.location, cams.R)
    tris = mesh.vertices[mesh.faces[: mesh.num_faces].long()]
    z = torch.einsum("fcj,kj->kfc", tris, RT[:, 2, :3]) + RT[:, 2, 3, None, None]
    front = z > 1e-4
    _, _, live = traster.face_screen_bboxes(cams, mesh)
    live = live[:, : mesh.num_faces]
    return (int((front.any(-1) & ~front.all(-1)).sum()), int((~front.any(-1)).sum()),
            int((front.any(-1) & ~live).sum()))


def _assert_admission_equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)


ADMISSION_CCAPS = (1, 8, 48, 192)


@pytest.mark.parametrize("K", [1, 3, 32])
@pytest.mark.parametrize("tile", [8, 16, 32, 64])
def test_admission_kernels_match_plain_path_bitwise(admission_scene, tile, K):
    """The admission kernels against the plain version of the card's
    admission (padded_bboxes, tile_overlap, exact_lists, bbox_words) on the
    same CUDA tensors at 128², at ccap 1, 8, 48 and 192 (buffers of 8, 8,
    48 and 192 slots a row: ``list_slots``, at least the bit matrix's 8
    words): every slot of the flat ids, the counts, the offsets and
    the bbox words equal; faces straddle the near plane, lie behind it and
    off screen; rows end exact and, past the buffer (32 views in tiles of
    64), scan-all, only rows longer than the slots a row; none in block
    mode."""
    mesh = admission_scene
    cams = _admission_views(K, 128, "cuda")
    assert mesh.faces.shape[0] % 128 and all(_face_kinds(mesh, cams))
    kinds = set()
    for ccap in ADMISSION_CCAPS:
        before = traster.admission.launches
        got = traster.admission(cams, mesh, tile, 128, ccap, compact=True)
        torch.cuda.synchronize()
        assert traster.admission.launches == before + 1
        want = traster.admission_exact_reference(cams, mesh, tile, 128, ccap,
                                                 compact=True)
        _assert_admission_equal(got, want)
        c = got.counts
        kinds |= {k for k, m in (("exact", c >= 0), ("scan_all", c == -1),
                                 ("block", c <= -2)) if bool(m.any())}
        n_chunks = -(-mesh.faces.shape[0] // 128)
        slots = traster.list_slots(ccap, n_chunks)
        n = traster.admission_exact_reference(cams, mesh, tile, 128,
                                              n_chunks).counts  # all fit
        assert bool((n[c == -1] > slots).all())  # only longer rows fall back
        assert bool((c[n <= slots] >= 0).all())
    assert "exact" in kinds and kinds <= {"exact", "scan_all"}
    if (tile, K) == (64, 32):
        assert "scan_all" in kinds


@pytest.mark.parametrize("res, tile, K, chunk", [
    (512, 8, 3, 128),    # 4,096 tiles a view
    (2048, 8, 1, 128),   # 65,536 tiles: ranges of tile rows
    (128, 16, 3, 48),    # chunks of 48: a word column of 1,536 faces
    (64, 8, 32, 16),     # chunks of 16, 2,031 of them: seven views a CTA
])
def test_admission_kernels_match_plain_path_at_other_shapes(admission_scene, res,
                                                            tile, K, chunk):
    mesh = admission_scene
    cams = _admission_views(K, res, "cuda", seed=res + K)
    for compact in (True, False):
        got = traster.admission(cams, mesh, tile, chunk, 48, compact)
        want = traster.admission_exact_reference(cams, mesh, tile, chunk, 48,
                                                 compact)
        _assert_admission_equal(got, want)


def test_admission_refuses_what_the_kernels_do_not_take(admission_scene):
    """float64 vertices raise before any launch; a chunk count the C side
    refuses raises from the launch."""
    mesh = admission_scene
    cams = _admission_views(2, 128, "cuda")
    before = traster.admission.launches
    with pytest.raises(ValueError, match="float32"):
        traster.admission(cams, mesh._replace(vertices=mesh.vertices.double()),
                          32, 128, 48)
    assert traster.admission.launches == before
    buf = torch.zeros(64, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        call_kernel("raster_admission", "admission_launch", [buf.data_ptr()] * 9,
                    [100, 100, 1, 128, 32, 128, 2, 8])  # 100 faces: 1 chunk
    with pytest.raises(RuntimeError, match="CUDA error"):  # ids past an int
        call_kernel("raster_admission", "admission_launch", [buf.data_ptr()] * 9,
                    [100, 100, 2, 2048, 8, 128, 1, 2**15])
    traster.admission(cams, mesh, 32, 128, 48)  # no error left behind
    torch.cuda.synchronize()


def test_admission_past_two_to_the_31_rows_times_chunks(admission_scene):
    """17 views at 1024² in tiles of 4 and chunks of 16: 1,114,112 rows x
    2,031 chunks, past 2^31, which the offsets' 64-bit scan takes. Against
    the plain version view by view: every row's count, its offset in the
    two passes (the rows of at most the buffer's slots a row, then the
    longer ones) and every listed row's chunks."""
    mesh = admission_scene
    K, res, tile, chunk, ccap = 17, 1024, 4, 16, 8
    cams = _admission_views(K, res, "cuda", seed=7)
    n_chunks = -(-mesh.faces.shape[0] // chunk)
    slots = traster.list_slots(ccap, n_chunks)
    T = (res // tile) ** 2
    assert K * T * n_chunks > 2**31
    got = traster.admission(cams, mesh, tile, chunk, ccap)
    torch.cuda.synchronize()
    refs = [traster.admission_exact_reference(
        Camera(cams.location[k:k + 1], cams.R[k:k + 1], cams.fov[k:k + 1], res),
        mesh, tile, chunk, n_chunks) for k in range(K)]
    n = torch.cat([r.counts for r in refs]).long()  # every list fits there
    fits = two_pass_fits(n, slots)
    assert torch.equal(got.counts.long(), torch.where(fits, n, -1))
    short = n <= slots
    ns, nl = torch.where(short, n, 0), torch.where(short, 0, n)
    starts = torch.where(short, ns.cumsum(0) - ns, ns.sum() + nl.cumsum(0) - nl)
    assert torch.equal(got.offsets.long(), starts.clamp(max=K * T * slots))
    for k in (0, K - 1):
        rows = torch.arange(k * T, (k + 1) * T, device="cuda")[fits[k * T:(k + 1) * T]]
        lens = n[rows]
        first = torch.repeat_interleave(lens.cumsum(0) - lens, lens)
        j = torch.arange(int(lens.sum()), device="cuda") - first
        at = torch.repeat_interleave(got.offsets[rows].long(), lens) + j
        ref_at = torch.repeat_interleave(refs[k].offsets[rows - k * T].long(),
                                         lens) + j
        assert torch.equal(got.ids[at], refs[k].ids[ref_at])


def test_prepare_raster_on_the_card_admits_through_the_kernels(admission_scene):
    mesh = admission_scene
    cams = _admission_views(3, 128, "cuda")
    before = traster.admission.launches
    inp = traster.prepare_raster(cams, mesh, 32, 128, ccap=8, compact=True,
                                 streamed=True)
    assert traster.admission.launches == before + 1
    want = traster.admission_exact_reference(cams, mesh, 32, 128, 8, True)
    _assert_admission_equal((inp.ids, inp.counts, inp.bbox_words, inp.offsets),
                            want)


def test_prepare_raster_on_the_card_has_no_stand_in_rows(admission_scene):
    """Tile 8, ccap 2: the JAX package's capped encoding, hierarchical with
    expand_bcap 1 (``tile_admission``, on the same CUDA tensors), puts rows
    in block mode and scan-all; on the card prepare_raster lists every row
    exactly, and its counters record no stand-in row and every row admitted
    by the kernels."""
    from omnidata_tpu_torch.utils import profiler

    mesh = admission_scene
    cams = _admission_views(3, 128, "cuda")
    capped = tile_admission(cams, mesh, 8, 128, 2, 1, 1)[1]
    assert bool((capped == -1).any()) and bool((capped <= -2).any())
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        inp = traster.prepare_raster(cams, mesh, 8, 128, ccap=2, streamed=True)
    got = {k: v["total"] for k, v in profiler.summary()["counters"].items()}
    profiler.reset()
    assert bool((inp.counts >= 0).all())
    assert int(got["raster.rows_block"]) == int(got["raster.rows_scan_all"]) == 0
    assert int(got["raster.rows"]) == int(got["raster.rows_fused"]) == capped.numel()


EXACT_BODIES = ["chunklist", "streamed", "streamed_compact",
                "streamed_compact_cap64", "compact", "compact_cap64"]


@pytest.mark.parametrize("seg", [1, tk.SPLIT_SEG])
@pytest.mark.parametrize("body", EXACT_BODIES)
@pytest.mark.parametrize("tile", [8, 32])
def test_kernels_on_exact_lists_match_plain_versions_bitwise(cuda_scene, tile,
                                                              body, seg):
    """Kernels A, B and C on the card's exact lists (flat, at row offsets,
    in a buffer of two slots a row, past which longer rows scan every
    chunk) against their plain versions on the same lists, bit for bit,
    and their item lists against split_schedule's."""
    mesh, cams = cuda_scene
    args, offsets, T = exact_inputs(mesh, cams, tile, CHUNK, 2)
    ids, counts, origins, pack, words, dirs = args
    assert ids.dim() == 1 and bool((counts == -1).any())
    assert bool((counts > 2).any())
    n_chunks = pack.shape[1] // CHUNK
    kw = dict(chunk=CHUNK, tiles_per_view=T, offsets=offsets)
    staged = None
    if body == "chunklist":
        wrapper = tk.raster_tiles_chunklist
        got = wrapper(ids, counts, origins, pack, dirs, seg=seg, **kw)
        want = tk.raster_tiles_chunklist_reference(ids, counts, origins, pack,
                                                   dirs, **kw)
        cap = tk.STREAMED_STAGE_CAP
    elif body.startswith("compact"):
        wrapper = tk.raster_tiles_compact
        cap = 64 if body.endswith("64") else tk.STAGE_CAP
        got = wrapper(ids, counts, origins, pack, words, dirs, stage_cap=cap,
                      seg=seg, **kw)
        want = tk.raster_tiles_compact_reference(ids, counts, origins, pack,
                                                 words, dirs, stage_cap=cap,
                                                 **kw)
        staged = tk.stage_faces(ids, counts, words, n_chunks, CHUNK, T, tile,
                                cap, offsets=offsets)[0]
    else:
        wrapper = tk.raster_tiles_streamed
        cap = 64 if body.endswith("64") else tk.STREAMED_STAGE_CAP
        w = None if body == "streamed" else words
        cm = chunk_major(pack, CHUNK)
        got = wrapper(ids, counts, origins, cm, dirs, bbox_words=w,
                      stage_cap=cap, seg=seg, **kw)
        want = tk.raster_tiles_streamed_reference(ids, counts, origins, cm,
                                                  dirs, bbox_words=w,
                                                  stage_cap=cap, **kw)
        if w is not None:
            staged = tk.stage_faces(ids, counts, words, n_chunks, CHUNK, T,
                                    tile, cap, offsets=offsets)[0]
    torch.cuda.synchronize()
    _assert_bitwise(got, want)
    ref = tk.split_schedule(counts, staged, n_chunks, seg, CHUNK, cap)
    for name in ("order", "ends", "n_items"):
        assert torch.equal(getattr(wrapper.last_schedule, name),
                           getattr(ref, name)), name
    if staged is not None:
        assert torch.equal(wrapper.last_schedule.staged.long(), staged)
    assert (got[0] < tk.BIG_PACKED).float().mean() > 0.9


@pytest.mark.parametrize("kw", [{}, dict(compact=True), dict(streamed=True),
                                dict(streamed=True, compact=False)],
                         ids=["chunklist", "compact", "streamed_compact",
                              "streamed"])
def test_render_views_fused_kernel_equals_plain_raster(cuda_scene, monkeypatch,
                                                       kw):
    mesh, cams = cuda_scene
    got = traster.render_views_fused(cams, mesh, 32, CHUNK, mesh.vertex_colors,
                                     **kw)
    for name in ("chunklist", "compact", "streamed"):
        monkeypatch.setattr(traster, f"raster_tiles_{name}",
                            getattr(tk, f"raster_tiles_{name}_reference"))
    want = traster.render_views_fused(cams, mesh, 32, CHUNK, mesh.vertex_colors,
                                      **kw)
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(g, w)


def _one(cams, k):
    return Camera(cams.location[k], cams.R[k], cams.fov[k], cams.resolution)


def _on_cpu(mesh):
    return mesh._replace(**{k: v.cpu() for k, v in mesh._asdict().items()
                            if isinstance(v, torch.Tensor)})


def test_render_view_on_the_card_equals_the_cpu(cuda_scene):
    """The plain per-view renderer (no kernel) on CUDA tensors against the
    CPU: valid and faces equal, t and z within 1e-4, at a cap that covers
    every tile and at one that drops candidates."""
    mesh, cams = cuda_scene
    cpu_mesh = _on_cpu(mesh)
    for k in range(2):
        cam = _one(cams, k)
        cpu_cam = Camera(cam.location.cpu(), cam.R.cpu(), cam.fov.cpu(), RES)
        need = int(traster.tile_candidate_counts(cam, mesh, tile=32).max())
        assert need == int(traster.tile_candidate_counts(cpu_cam, cpu_mesh, 32).max())
        for cap in (128, 1 << max(7, (need - 1).bit_length())):
            got = traster.render_view(cam, mesh, tile=32, cap=cap, chunk=CHUNK)
            want = traster.render_view(cpu_cam, cpu_mesh, tile=32, cap=cap, chunk=CHUNK)
            assert got.t.device.type == "cuda"
            assert torch.equal(got.valid.cpu(), want.valid)
            assert torch.equal(got.face.cpu(), want.face)
            m = want.valid
            assert (got.t.cpu()[m] - want.t[m]).abs().max() <= 1e-4
            assert (got.z.cpu()[m] - want.z[m]).abs().max() <= 1e-4


def test_annotate_view_on_the_kernel_equals_annotate_views(cuda_scene):
    """annotate_view on CUDA tensors launches kernel A once per view (K = 1)
    and its labels meet the integer-label rule against annotate_views on
    the same views; its render_view route does too."""
    from omnidata_tpu_torch.annotator import annotate_view, annotate_views

    from _torch_port_util import int_label_ok

    mesh, cams = cuda_scene
    batched = annotate_views(cams, mesh, tile=32, chunk=CHUNK)
    for k in range(2):
        for kw in ({}, dict(fused_attrs=True), dict(use_pallas=False, cap=4096)):
            before = tk.raster_tiles_chunklist.launches
            out = annotate_view(_one(cams, k), mesh, tile=32, chunk=CHUNK, **kw)
            torch.cuda.synchronize()
            assert tk.raster_tiles_chunklist.launches == before + (
                0 if kw.get("use_pallas") is False else 1)
            assert set(out) == set(batched)
            for name, v in out.items():
                assert v.device.type == "cuda" and v.shape == batched[name].shape[1:]
                ok, dmax, frac = int_label_ok(v.cpu().numpy(),
                                              batched[name][k].cpu().numpy())
                assert ok, (name, kw, dmax, frac)


def test_sharded_annotation_on_the_card_equals_single(cuda_scene):
    """annotate_views_sharded over make_annotate_mesh(): with every card of
    the machine (one on the measured machine, where the batch is not split)
    each label equals annotate_views' bit for bit."""
    from omnidata_tpu_torch.annotator import (
        annotate_views,
        annotate_views_sharded,
        make_annotate_mesh,
    )

    mesh, cams = cuda_scene
    devices = make_annotate_mesh()
    assert devices[0] == torch.device("cuda", 0)
    n = len(devices) if 2 % len(devices) == 0 else 1
    out = annotate_views_sharded(cams, mesh, device_mesh=devices[:n], tile=32,
                                 chunk=CHUNK)
    want = annotate_views(cams, mesh, tile=32, chunk=CHUNK)
    assert set(out) == set(want)
    for name in want:
        assert out[name].device == devices[0]
        assert torch.equal(out[name], want[name]), name


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs the port on the card against "
                    "itself on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _label_batch():
    """Seeded encoded labels of 3 views at 96²: depth codes with planes,
    boxes, no-hit pixels and noise; normals; edges; rgb."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float32)
    depth = np.stack([2.0 + 0.02 * xx, 4.0 - 0.03 * yy, 3.0 + 0.5 * np.sin(xx / 9)])
    depth[0, 30:60, 10:50] = 1.2
    depth[1, :10, :12] = 0.0
    depth[2, 50:, 40:] = 1.7
    depth += 0.003 * rng.rand(*depth.shape).astype(np.float32)
    code = np.where(depth > 0, np.round(depth * 512), 65535).astype(np.uint16)
    normal = (rng.rand(3, 96, 96, 3) * 255).astype(np.uint8)
    edge = (rng.rand(3, 96, 96) * 5000).astype(np.uint16)
    rgb = (rng.rand(3, 96, 96, 3) * 255).astype(np.uint8)
    return code, normal, edge, rgb


def test_device_cue_maps_on_the_card_equal_the_cpu(card):
    """narf_border_maps, seg2d_blur_maps and seg25d_channel_maps on the card
    against the port on the CPU from the same codes: every code equal (every
    division and square root rounds as IEEE float32 on both, and the
    transcendental functions are taken in float64 and rounded once)."""
    from omnidata_tpu_torch.cues import narf_device as nd
    from omnidata_tpu_torch.cues import seg_device as sd

    code, normal, edge, rgb = _label_batch()
    depth_m = torch.from_numpy(code.astype(np.float32) * (128.0 / 65535.0))
    focal = nd.focal_px(torch.tensor([1.0, 1.2, 0.9]), 96)
    n = nd.max_levels_for(96, 96)
    cpu = nd.narf_border_maps(depth_m, focal, n)
    gpu = nd.narf_border_maps(depth_m.to(card), focal.to(card), n)
    assert len(cpu) == len(gpu) == n
    for lvl, glvl in zip(cpu, gpu):
        for m, gm in zip(lvl, glvl):
            assert gm.device.type == card.type and gm.dtype == m.dtype
            assert torch.equal(gm.cpu().int(), m.int())
    t = [torch.from_numpy(x) for x in (code, normal, edge, rgb)]
    assert torch.equal(sd.seg2d_blur_maps(t[3].to(card)).cpu().int(),
                       sd.seg2d_blur_maps(t[3]).int())
    got = sd.seg25d_channel_maps(*(x.to(card) for x in t[:3])).cpu()
    assert torch.equal(got.int(), sd.seg25d_channel_maps(*t[:3]).int())


def test_dpt_on_the_card_matches_the_cpu(card):
    """DPT-hybrid, depth and normals, seeded weights, float32 with TF32 off
    at 128²: max |card - CPU| <= 1e-3 x max |CPU|."""
    from omnidata_tpu_torch.models import create_model

    x = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 128, 128).astype(np.float32))
    for name in ("depth_dpt_hybrid_384", "surface_normal_dpt_hybrid_384"):
        cpu = create_model(name, device="cpu", generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            want = cpu(x)
            got = cpu.to(card)(x.to(card)).cpu()
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def _one_step(dev, net, tx, pred_fn, loss_fn, batch, cotangent=None, grads=None,
              dtype=torch.float32):
    """One training step of a copy of net on dev (forward, loss, backward,
    the optimizer): the loss, dL/dpred, the gradients and the parameters
    after, on the CPU. cotangent: backpropagate it from the prediction in
    place of the loss's own; grads: step the optimizer on these instead;
    dtype: the net's and the batch's floats."""
    import copy

    from omnidata_tpu_torch import train as ttrain

    state = ttrain.create_train_state(copy.deepcopy(net).to(dev, dtype), tx)
    b = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
         for k, v in batch.items()}
    pred = pred_fn(state.net, b)
    pred.retain_grad()
    loss, _ = loss_fn(pred, b)
    loss.backward() if cotangent is None else pred.backward(cotangent.to(dev, dtype))
    named = dict(state.net.named_parameters())
    got = {n: named[n].grad.detach().cpu().clone() for n in state.names
           if named[n].grad is not None}
    if grads is not None:
        for n in state.names:
            named[n].grad = grads[n].to(dev, copy=True) if n in grads else None
    state.apply_gradients()
    return (float(loss.detach()), pred.grad.detach().cpu().clone(), got,
            {n: named[n].detach().cpu().clone() for n in state.names})


def _rel(a, b):
    return float((a.double() - b.double()).norm()) / max(float(b.double().norm()), 1e-300)


def _assert_step_close(card, net, tx, pred_fn, loss_fn, batch):
    """The CPU's step against the card's, part by part: the loss within
    1e-3; from the CPU's dL/dpred, each gradient against the same
    backpropagated in float64 no further than 3 times the CPU float32's
    own error plus 1e-2 (float32 gradients of DPT's standardized convolutions
    and GroupNorms reach 2.3% from float64 on the CPU too, chip_smoke.py
    phase 16a); from the CPU's gradients, the update within 0.1 lr plus
    the rounding of p + u (a sign flip is 2 lr). (The
    whole step on the card differs more: the loss's median and
    hard-example selections pick other elements when the prediction
    differs in its last bits, and Adam's first step maps each gradient to
    ±lr by its sign.)"""
    cpu = torch.device("cpu")
    args = (tx, pred_fn, loss_fn, batch)
    l0, c0, g0, p0 = _one_step(cpu, net, *args)
    l1 = _one_step(card, net, *args)[0]
    assert abs(l1 - l0) <= 1e-3 * abs(l0)
    g1 = _one_step(card, net, *args, cotangent=c0)[2]
    gc = _one_step(cpu, net, *args, cotangent=c0)[2]
    g64 = _one_step(cpu, net, *args, cotangent=c0, dtype=torch.float64)[2]
    assert g0.keys() == g1.keys() == gc.keys() == g64.keys() and g0
    for n in g0:
        card_err, cpu_err = _rel(g1[n], g64[n]), _rel(gc[n], g64[n])
        assert card_err <= 3 * cpu_err + 1e-2, (n, card_err, cpu_err)
    p1 = _one_step(card, net, *args, grads=g0)[3]
    for n in p0:
        assert bool(((p1[n] - p0[n]).abs() <= 0.1 * tx.lr + 2**-22 * p0[n].abs()).all()), n


@pytest.mark.parametrize("late", [False, True], ids=["ssi_only", "full_loss"])
def test_dpt_depth_step_on_the_card_matches_the_cpu(card, late):
    """One DPT-hybrid depth step at 128², seeded weights and batch, fixed
    triplets, on both sides of the 15k switch, TF32 off."""
    from omnidata_tpu_torch import train as ttrain
    from omnidata_tpu_torch.losses import VNLParams, sample_triplets
    from omnidata_tpu_torch.models import DPTHybrid
    from omnidata_tpu_torch.models.registry import init_weights

    H = 128
    net = DPTHybrid(num_channels=1)
    init_weights(net, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    mask = np.ones((1, 1, H, H), bool)
    mask[..., 20:40, 50:90] = False
    batch = {"rgb": torch.from_numpy((rng.rand(1, 3, H, H) * 2 - 1).astype(np.float32)),
             "depth": torch.from_numpy((rng.rand(1, 1, H, H) * 0.5 + 0.1).astype(np.float32)),
             "mask_valid": torch.from_numpy(mask)}
    params = VNLParams(1.0, 1.0, (H, H))
    triplets = sample_triplets(torch.Generator().manual_seed(1), params)
    step = ttrain.SSI_ONLY_STEPS + 1 if late else 0

    def loss_fn(pred, b):
        return ttrain.depth_loss_fn(pred, b, step, triplets.to(pred.device), params)

    _assert_step_close(card, net, ttrain.depth_optimizer(lr=1e-5),
                       lambda n, b: n(b["rgb"])[:, 0], loss_fn, batch)


def test_unet_normal_step_on_the_card_matches_the_cpu(card):
    """One UNet (downsample 6) normal step at 128², batch 2, TF32 off."""
    from omnidata_tpu_torch import train as ttrain
    from omnidata_tpu_torch.models import UNet
    from omnidata_tpu_torch.models.registry import init_weights

    net = UNet(out_channels=3, downsample=6, remat=True)
    init_weights(net, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batch = {"rgb": torch.from_numpy(rng.rand(2, 3, 128, 128).astype(np.float32)),
             "normal": torch.from_numpy(rng.rand(2, 3, 128, 128).astype(np.float32)),
             "mask_valid": torch.from_numpy(rng.rand(2, 1, 128, 128) > 0.05)}
    _assert_step_close(card, net, ttrain.normal_optimizer(lr=1e-4),
                       lambda n, b: n(b["rgb"]), ttrain.normal_loss_fn, batch)


def test_eval_metrics_on_the_card_match_the_cpu(card):
    """normal_metrics and depth_metrics within 1e-5 relative, the masked
    median (taken on the host) within 1e-4 degrees."""
    from omnidata_tpu_torch.train.metrics import depth_metrics, normal_metrics

    rng = np.random.RandomState(4)
    mask = torch.from_numpy(rng.rand(2, 1, 40, 48) > 0.3)
    for fn, C in ((normal_metrics, 3), (depth_metrics, 1)):
        p = torch.from_numpy(rng.rand(2, C, 40, 48).astype(np.float32))
        t = torch.from_numpy(rng.rand(2, C, 40, 48).astype(np.float32) * 0.9 + 0.05)
        want, got = fn(p, t, mask), fn(p.to(card), t.to(card), mask.to(card))
        for k in want:
            tol = 1e-4 if "median" in k else 1e-5 * abs(want[k]) + 1e-9
            assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_tta_on_the_card_matches_the_cpu(card):
    """Flip and scale TTA (median of 4) around a seeded 3x3 conv."""
    from omnidata_tpu_torch.models.tta import SurfaceNormalsTTA

    conv = torch.nn.Conv2d(3, 3, 3, padding=1)
    torch.nn.init.normal_(conv.weight, 0, 0.3, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 3, 64, 48).astype(np.float32))
    with torch.no_grad():
        want = SurfaceNormalsTTA(lambda v: torch.tanh(conv(v)), scales=(0.5, 1.5))(x)
        gconv = conv.to(card)
        got = SurfaceNormalsTTA(lambda v: torch.tanh(gconv(v)), scales=(0.5, 1.5))(x.to(card))
    assert float((got.cpu() - want).abs().max()) <= 1e-4


def _seeded_mt_batch(n, H, W):
    rng = np.random.RandomState(6)
    return {"rgb": torch.from_numpy(rng.rand(n, 3, H, W).astype(np.float32)),
            "depth_zbuffer": torch.from_numpy(rng.rand(n, 1, H, W).astype(np.float32)),
            "normal": torch.from_numpy(rng.rand(n, 3, H, W).astype(np.float32)),
            "mask_valid": torch.from_numpy(rng.rand(n, 1, H, W) > 0.1)}


@pytest.mark.parametrize("arch", ["multitask", "mtan", "padnet", "crossstitch", "hrnet_lite",
                                  "hrnet_w18"])
def test_multitask_and_hrnet_forward_on_the_card_match_the_cpu(card, arch):
    """Seeded weights, float32 with TF32 off: max |card - CPU| <= 1e-3 x
    max |CPU| for every output."""
    from omnidata_tpu_torch import train_multitask as tm
    from omnidata_tpu_torch.models import HRNet, HRNetLite
    from omnidata_tpu_torch.models.registry import init_weights

    if arch.startswith("hrnet"):
        net = HRNet(5, "w18") if arch == "hrnet_w18" else HRNetLite(5)
        init_weights(net, torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.RandomState(7).rand(1, 3, 129, 129).astype(np.float32))
    else:
        net = tm.build_model(arch)
        x = _seeded_mt_batch(2, 96, 80)["rgb"]
    with torch.no_grad():
        want = net.eval()(x)
        got = net.to(card)(x.to(card))
    flat = (lambda d: {k: v for k, v in d.items() if k != "aux"} | {
        f"aux_{k}": v for k, v in d.get("aux", {}).items()}) if isinstance(want, dict) \
        else (lambda t: {"out": t})
    want, got = flat(want), flat(got)
    for k in want:
        err = float((got[k].cpu() - want[k]).abs().max())
        assert err <= 1e-3 * float(want[k].abs().max()), (k, err)


@pytest.mark.parametrize("arch", ["multitask", "padnet"])
def test_multitask_step_on_the_card_matches_the_cpu(card, arch):
    """One train_multitask step at 128², batch 2: the per-task losses and
    gradient norms within 1e-3 relative; the update from the CPU's
    gradients within 0.1 lr plus the rounding of p + u."""
    import copy

    from omnidata_tpu_torch import train_multitask as tm
    from omnidata_tpu_torch.train.state import Optimizer, create_train_state

    net = tm.build_model(arch)
    batch = _seeded_mt_batch(2, 128, 128)
    w = {"depth_zbuffer": 0.8, "normal": 1.2}
    res = []
    for dev in (torch.device("cpu"), card):
        st = create_train_state(copy.deepcopy(net).to(dev), Optimizer(lr=1e-4, grad_clip=10.0))
        b = {k: v.to(dev) for k, v in batch.items()}
        norms = {k: float(v) for k, v in tm.per_task_grad_norms(st, b).items()}
        ls = tm.losses_fn(st.net, b)
        (w["depth_zbuffer"] * ls["depth_zbuffer"] + w["normal"] * ls["normal"]).backward()
        named = dict(st.net.named_parameters())
        grads = {n: None if named[n].grad is None else named[n].grad.cpu().clone()
                 for n in st.names}
        res.append((st, {k: float(v.detach()) for k, v in ls.items()}, norms, grads, named))
    (st_c, l_c, n_c, g_c, named_c), (st_g, l_g, n_g, _, named_g) = res
    for k in l_c:
        assert abs(l_g[k] - l_c[k]) <= 1e-3 * abs(l_c[k]), (k, l_g[k], l_c[k])
        assert abs(n_g[k] - n_c[k]) <= 1e-3 * abs(n_c[k]), (k, n_g[k], n_c[k])
    for n in st_g.names:
        named_g[n].grad = None if g_c[n] is None else g_c[n].to(card, copy=True)
    st_c.apply_gradients()
    st_g.apply_gradients()
    for n in st_c.names:
        p0, p1 = named_c[n].detach(), named_g[n].detach().cpu()
        assert bool(((p1 - p0).abs() <= 0.1 * 1e-4 + 2**-22 * p0.abs()).all()), n


@pytest.mark.parametrize("name,hw", [("midas_v21", (128, 128)), ("midas_v21_small", (128, 160)),
                                     ("midas_net_small", (64, 64))])
def test_midas_forward_on_the_card_matches_the_cpu(card, name, hw):
    """Seeded weights at the published widths, float32 with TF32 off: max
    |card - CPU| <= 1e-3 x max |CPU|; (B, H, W) depth, non-negative."""
    from omnidata_tpu_torch.models import MidasNetSmall, create_model
    from omnidata_tpu_torch.models.registry import init_weights

    if name == "midas_net_small":
        net = MidasNetSmall()
        init_weights(net, torch.Generator().manual_seed(0))
        net.eval()
    else:
        net = create_model(name, device="cpu")
    x = torch.from_numpy(np.random.RandomState(8).rand(2, 3, *hw).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = net.to(card)(x.to(card)).cpu()
    assert got.shape == want.shape and float(got.min()) >= 0
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_midas_v21_on_a_transformed_photo_on_the_card(card):
    """midas_transform_v21 of a seeded 640x480 image (3 x 288 x 384), then
    midas_v21 on the card against the CPU."""
    from omnidata_tpu_torch.models import create_model, midas_transform_v21

    img = np.random.RandomState(9).rand(480, 640, 3).astype(np.float32)
    x = torch.from_numpy(midas_transform_v21()({"image": img})["image"])[None]
    assert x.shape == (1, 3, 288, 384)
    net = create_model("midas_v21", device="cpu")
    with torch.no_grad():
        want = net(x)
        got = net.to(card)(x.to(card)).cpu()
    assert got.shape == (1, 288, 384) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_refocus_on_the_card_matches_the_cpu(card):
    """refocus_image and refocus_augmentation (draws from a CPU generator of
    the same seed) at 128², 10 quantiles, on the card within 1e-5 of the
    CPU."""
    from omnidata_tpu_torch.augment import compute_quantiles, refocus_augmentation, refocus_image

    rng = np.random.RandomState(10)
    rgb = torch.from_numpy(rng.rand(2, 3, 128, 128).astype(np.float32))
    depth = torch.from_numpy((0.5 + 7 * rng.rand(2, 1, 128, 128)).astype(np.float32))
    qv = compute_quantiles(depth, 10)
    assert torch.allclose(compute_quantiles(depth.to(card), 10).cpu(), qv, rtol=1e-6, atol=0)
    focus, aperture = qv[:, 4:5], torch.tensor([[0.3], [5.0]])
    want = refocus_image(rgb, depth, focus, aperture, qv)
    got = refocus_image(*(t.to(card) for t in (rgb, depth, focus, aperture, qv))).cpu()
    assert float((got - want).abs().max()) <= 1e-5
    want = refocus_augmentation(rgb, depth, torch.Generator().manual_seed(1), n_quantiles=10)
    got = refocus_augmentation(rgb.to(card), depth.to(card), torch.Generator().manual_seed(1),
                               n_quantiles=10).cpu()
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("stage_cap", [None, 8], ids=["default_cap", "cap8"])
def test_rows_past_stage_cap_counter_equals_the_launch(cuda_scene, stage_cap):
    """Under the profiler, kernel C's compacting launch counts the rows that
    staged more faces than its cap, as its schedule's staged faces say."""
    from omnidata_tpu_torch.utils import profiler

    mesh, cams = cuda_scene
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traster.render_views_fused(cams, mesh, 32, CHUNK, streamed=True,
                                   stage_cap=stage_cap)
    got = profiler.summary()
    profiler.reset()
    staged = tk.raster_tiles_streamed.last_schedule.staged
    cap = stage_cap or tk.STREAMED_STAGE_CAP
    want = int((staged > cap).sum())
    assert got["counters"]["raster.rows_past_stage_cap"]["total"] == want
    assert got["counters"]["raster.rows"]["total"] == staged.numel()
    assert got["counters"]["raster.rows_fused"]["total"] == staged.numel()
    if stage_cap:
        assert want > 0
    for name in ("raster.prepare", "raster.render"):
        assert got["spans"][name]["device_ms"] > 0


def test_pipeline_spans_have_device_times_on_the_card(cuda_scene):
    """render_batches on the card: under the profiler every stage span has
    device times (pipeline.fetch on the side stream, from the fetch thread)
    and the fetch counters are kept; with nothing recording the recorder
    makes no CUDA event (the pipeline's own two a batch only)."""
    from omnidata_tpu_torch.annotator import cli
    from omnidata_tpu_torch.utils import profiler

    mesh, cams = cuda_scene
    kw = dict(tile=32, chunk=CHUNK, modalities=("depth_zbuffer", "rgb", "keypoints2d"))
    prefixes = {"narf": False, "seg2d": False, "seg25d": False}

    def run():
        return list(cli.render_batches(iter([cams, cams]), mesh, None, kw,
                                       kw["modalities"], None, prefixes))

    run()  # warm
    made = []
    real = torch.cuda.Event

    def counted(*a, **k):
        made.append(k.get("enable_timing", False))
        return real(*a, **k)

    torch.cuda.Event = counted
    try:
        off = run()
    finally:
        torch.cuda.Event = real
    assert made == [False] * 4  # ready and done, for each of 2 batches
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        on = run()
    got = profiler.summary()
    profiler.reset()
    for name in ("raster.prepare", "raster.render", "annotate.labels",
                 "cues.keypoints2d", "pipeline.fetch"):
        s = got["spans"][name]
        assert s["count"] == 2 and s["device_ms"] > 0, name
    assert got["spans"]["pipeline.wait"]["device_ms"] is None
    c = got["counters"]
    want = sum(a.nbytes for labels, _ in on for a in labels.values())
    assert c["fetch.bytes"]["total"] == want
    if cli._pinned_bytes() is not None:
        assert 0 <= c["fetch.pinned_alloc_bytes"]["total"]
    for (a, _), (b, _) in zip(on, off):
        for m in kw["modalities"]:
            np.testing.assert_array_equal(a[m], b[m])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_predict_batches_graphs_equal_the_eager_predictor(card, dtype):
    """models.predict on the card replays the Predictor's stages as CUDA
    graphs (one capture per batch shape): each batch equals the eager
    Predictor on the same upload, in order; under the profiler the stage
    spans around the replays have device times."""
    from omnidata_tpu_torch.models.dpt import DPTHybrid
    from omnidata_tpu_torch.models.predict import _upload, predict_batches
    from omnidata_tpu_torch.models.registry import Predictor, cast_params_bf16, init_weights
    from omnidata_tpu_torch.utils import profiler

    net = DPTHybrid(vit_dim=64, vit_heads=4, vit_blocks=4, hooks=(1, 3), features=64)
    init_weights(net, torch.Generator().manual_seed(0))
    if dtype == torch.bfloat16:
        cast_params_bf16(net)
    model = Predictor(net, True, dtype).to(card).eval()
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8) for n in (2, 2, 1)]
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        got = list(predict_batches(model, iter(batches)))
    spans = profiler.summary()["spans"]
    profiler.reset()
    for crops, out in zip(batches, got):
        with torch.inference_mode():
            want = model(_upload(crops, card, "depth")).clamp(0, 1).cpu().numpy()
        np.testing.assert_array_equal(out, want)
    for name in ("dpt.backbone", "dpt.encoder", "dpt.decoder", "predict.upload",
                 "predict.model", "pipeline.fetch"):
        assert spans[name]["count"] == 3 and spans[name]["device_ms"] > 0, name
    assert spans["dpt.encoder"]["parents"] == ["predict.model"]


def _keypoint_gray(kind, dev):
    """Seeded grey images in [0, 1]: ("rand", N, H, W) uniform, or
    ("smooth",) test_torch_cues' _smooth_gray(7), 8x8 blocks plus texture."""
    if kind[0] == "smooth":
        rng = np.random.RandomState(7)
        base = rng.rand(2, 6, 8).repeat(8, 1).repeat(8, 2)
        g = np.clip(base + 0.1 * rng.rand(2, 48, 64), 0, 1).astype(np.float32)
        return torch.as_tensor(g, device=dev)
    gen = torch.Generator(device=dev).manual_seed(sum(kind[1:]))
    return torch.rand(kind[1:], generator=gen, device=dev)


def _assert_same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert float((got - want).abs().max()) == 0.0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind", [("rand", 32, 512, 512), ("rand", 1, 512, 512),
                                  ("rand", 3, 97, 130), ("rand", 2, 40, 40),
                                  ("smooth",)],
                         ids=["cell_32x512", "k1_512", "ragged_97x130",
                              "under_reach_40", "smooth_jax_test"])
def test_keypoints2d_kernel_equals_the_plain_version_bitwise(card, kind):
    """keypoints2d on the card (the integral image's cumsums, then the
    kernel) against keypoints2d_reference on the same CUDA tensors: max abs
    error 0, every bit equal; one launch a call."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")

    gray = _keypoint_gray(kind, card)
    before = kp.keypoints2d.launches
    got = kp.keypoints2d(gray)
    assert kp.keypoints2d.launches == before + 1
    _assert_same_bits(got, kp.keypoints2d_reference(gray))


@pytest.mark.parametrize("sigmas", [(1.0, 60.0, 7), (2.0, 30.0, 16)],
                         ids=["past_the_halo", "sixteen_scales"])
def test_keypoints2d_kernel_other_scales_bitwise(card, sigmas):
    """Scales past the staged halo (reach up to 90, read from device memory)
    and the 16 scales one launch takes: bit for bit with the plain version,
    one launch a call."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")

    gray = _keypoint_gray(("rand", 2, 200, 150), card)
    before = kp.keypoints2d.launches
    got = kp.keypoints2d(gray, *sigmas)
    assert kp.keypoints2d.launches == before + 1
    _assert_same_bits(got, kp.keypoints2d_reference(gray, *sigmas))


def test_keypoints2d_kernel_counts_images_fused(card):
    """Under a recording profiler each call counts its N images in
    keypoints2d.images_fused and one launch."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")
    from omnidata_tpu_torch.utils import profiler

    gray = _keypoint_gray(("rand", 3, 64, 64), card)
    before = kp.keypoints2d.launches
    profiler.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        kp.keypoints2d(gray)
        kp.keypoints2d(gray[:2])
    got = profiler.summary()["counters"]
    profiler.reset()
    assert got["keypoints2d.images_fused"]["total"] == 5
    assert kp.keypoints2d.launches == before + 2


def test_keypoints2d_kernel_refuses_what_it_does_not_take(card):
    """The entry point called directly raises on a float64, a non-contiguous
    or a CPU integral image and on more than 16 scales, and launches
    nothing."""
    kp = importlib.import_module("omnidata_tpu_torch.cues.keypoints2d")

    ii = kp.integral_image(_keypoint_gray(("rand", 2, 64, 64), card))
    before = kp.keypoints2d.launches
    for bad in (ii.double(), ii.transpose(1, 2), ii.cpu()):
        with pytest.raises(ValueError):
            kp.keypoints2d_kernel(bad)
    with pytest.raises(ValueError, match="num_sigma 17"):
        kp.keypoints2d_kernel(ii, 1.0, 30.0, 17)
    assert kp.keypoints2d.launches == before
