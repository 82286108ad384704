"""Card-only tests of the CUDA raster kernels: each bit-exact against its
plain PyTorch version on the same CUDA tensors, for every list encoding and
for the pixel-per-thread layouts of tiles 8 to 64; the compacting bodies
also at a stage cap small enough to force the raw-list fallback and with a
block-mode row whose tail runs past the last chunk; kernels A, B and C
also with their work items cut to 1 and 3 list positions, so that every
multi-chunk row is split across CTAs and merged. A refused launch raises.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports no JAX, so on a machine with a card
and without JAX it runs on its own:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``.
"""
import numpy as np
import pytest
import torch

from omnidata_tpu_torch.core.cameras import Camera, look_at_rotation
from omnidata_tpu_torch.mesh import from_arrays, room, uv_sphere
from omnidata_tpu_torch.mesh import raster as traster
from omnidata_tpu_torch.mesh import raster_kernels as tk

from _torch_port_util import chunk_major, mixed_inputs, with_block_tail

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


def _assert_bitwise(got, want):
    packed, acc = got
    want_packed, want_acc = want
    assert torch.equal(packed, want_packed)
    assert torch.equal(acc.view(torch.int32), want_acc.view(torch.int32))


@pytest.mark.parametrize("tile", [8, 16, 32, 64])  # 1, 1, 4, 16 px/thread
def test_kernel_matches_plain_version_bitwise(cuda_scene, tile):
    mesh, cams = cuda_scene
    (ids, counts, origins, pack, _, dirs), T = mixed_inputs(mesh, cams, tile, CHUNK)
    args = (ids, counts, origins, pack, dirs)
    if tile == 16:
        c = args[1].cpu()
        assert (c >= 0).any() and (c == -1).any() and (c <= -2).any(), c
    before = tk.raster_tiles_chunklist.launches
    got = tk.raster_tiles_chunklist(*args, chunk=CHUNK, tiles_per_view=T)
    torch.cuda.synchronize()
    assert tk.raster_tiles_chunklist.launches == before + 1
    _assert_bitwise(got, tk.raster_tiles_chunklist_reference(
        *args, chunk=CHUNK, tiles_per_view=T))
    assert (got[0] < tk.BIG_PACKED).float().mean() > 0.9


def _staged(body: str, plain: bool, args, T):
    """Kernel B or C (plain body, compacting body, or compacting at stage
    cap 64) on mixed-list inputs, or its plain version."""
    ids, counts, origins, pack, words, dirs = args
    kw = dict(chunk=CHUNK, tiles_per_view=T)
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
    last chunk (its clamped duplicates are staged once)."""
    mesh, cams = cuda_scene
    args, T = mixed_inputs(mesh, cams, tile, CHUNK)
    args, _, n_chunks = with_block_tail(args, T, CHUNK)
    wrapper = tk.raster_tiles_compact if body.startswith("compact") \
        else tk.raster_tiles_streamed
    before = wrapper.launches
    got = _staged(body, False, args, T)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_bitwise(got, _staged(body, True, args, T))
    assert (got[0] < tk.BIG_PACKED).float().mean() > 0.4  # cut scene
    if body.endswith("64") and tile >= 16:  # some rows take the fallback
        staged, _ = tk.stage_faces(args[0], args[1], args[4], n_chunks, CHUNK, T,
                                   tile, 64)
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
    args, T = mixed_inputs(mesh, cams, tile, CHUNK)
    args, _, n_chunks = with_block_tail(args, T, CHUNK)
    ids, counts, origins, pack, words, dirs = args
    kw = dict(chunk=CHUNK, tiles_per_view=T)
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
                                cap)[0]
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
            ids, counts, words, n_chunks, CHUNK, T, tile, cap)[0]
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
    args, T = mixed_inputs(mesh, cams, 8, CHUNK)
    args, _, n_chunks = with_block_tail(args, T, CHUNK)
    ids, counts, origins, pack, words, dirs = args
    ids, counts, origins, words = (x.repeat((40,) + (1,) * (x.dim() - 1))
                                   for x in (ids, counts, origins, words))
    dirs = tuple(d.repeat(40, 1) for d in dirs)
    kw = dict(chunk=CHUNK, tiles_per_view=T)
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
        staged = tk.stage_faces(ids, counts, words, n_chunks, CHUNK, T, 8, 64)[0]
    else:
        wrapper = tk.raster_tiles_streamed
        cm = chunk_major(pack, CHUNK)
        got = wrapper(ids, counts, origins, cm, dirs, bbox_words=words,
                      stage_cap=64, seg=seg, **kw)
        want = tk.raster_tiles_streamed_reference(ids, counts, origins, cm, dirs,
                                                  bbox_words=words, stage_cap=64,
                                                  **kw)
        staged = tk.stage_faces(ids, counts, words, n_chunks, CHUNK, T, 8, 64)[0]
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
    (ids, counts, origins, pack, _, dirs), T = mixed_inputs(mesh, cams, 32, CHUNK)
    before = tk.raster_tiles_chunklist.launches
    for seg in (0, -1):
        with pytest.raises(ValueError, match="seg"):
            tk.raster_tiles_chunklist(ids, counts, origins, pack, dirs,
                                      chunk=CHUNK, tiles_per_view=T, seg=seg)
    assert tk.raster_tiles_chunklist.launches == before


def test_refused_launch_raises(cuda_scene):
    """3 pixels per thread is no kernel instantiation: the C side refuses
    the launch and the wrapper raises."""
    mesh, cams = cuda_scene
    (ids, counts, origins, pack, _, dirs), T = mixed_inputs(mesh, cams, 32, CHUNK)
    dirs = tuple(d[:, :768].contiguous() for d in dirs)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk.raster_tiles_chunklist(ids, counts, origins, pack, dirs,
                                  chunk=CHUNK, tiles_per_view=T)


@pytest.mark.parametrize("body", STAGED_BODIES)
def test_staged_refused_launch_raises(cuda_scene, body):
    """Tile 4 gives 16 threads, not whole warps: the C side refuses every
    body (pass 1 ballots with whole warps) and the wrapper raises."""
    mesh, cams = cuda_scene
    args, T = mixed_inputs(mesh, cams, 4, CHUNK)
    wrapper = tk.raster_tiles_compact if body.startswith("compact") \
        else tk.raster_tiles_streamed
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        _staged(body, False, args, T)
    assert wrapper.launches == before


def test_stage_cap_past_shared_memory_raises(cuda_scene):
    mesh, cams = cuda_scene
    (ids, counts, origins, pack, words, dirs), T = mixed_inputs(mesh, cams, 32, CHUNK)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk.raster_tiles_compact(ids, counts, origins, pack, words, dirs,
                                chunk=CHUNK, tiles_per_view=T, stage_cap=1 << 17)
    # the refusal leaves no error behind for the next launch
    tk.raster_tiles_compact(ids, counts, origins, pack, words, dirs,
                            chunk=CHUNK, tiles_per_view=T)
    torch.cuda.synchronize()


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
