"""Shared helpers of the tests that hold omnidata_tpu_torch against the JAX
package: numpy inputs go through both, and results come back as numpy."""
import functools

import numpy as np

from omnidata_tpu_torch.graft_entry import TINY_DPT  # JAX's dryrun DPT
from omnidata_tpu_torch.interop import camera_from_numpy, mesh_from_numpy
from omnidata_tpu_torch.mesh import TriangleMesh

MESH_FIELDS = tuple(f for f in TriangleMesh._fields if f != "num_faces")
TREE_TOL = 1e-5


def port_mesh(jmesh):
    """The JAX package's (padded, Morton-ordered) mesh as a port mesh."""
    fields = {k: np.asarray(getattr(jmesh, k)) for k in MESH_FIELDS
              if getattr(jmesh, k) is not None}
    return mesh_from_numpy(fields, jmesh.num_faces)


def look_at_np(locs, targets):
    """Rotations from the JAX package's look_at_rotation, as numpy."""
    import jax
    import jax.numpy as jnp

    from omnidata_tpu.core.cameras import look_at_rotation

    return np.array(jax.vmap(look_at_rotation)(
        jnp.asarray(locs, jnp.float32), jnp.asarray(targets, jnp.float32)))


def both_cameras(locs, Rs, fovs, res):
    """(JAX Camera, port Camera) batches from the same numpy arrays."""
    import jax.numpy as jnp

    from omnidata_tpu.core import Camera

    locs, Rs, fovs = (np.asarray(a, np.float32) for a in (locs, Rs, fovs))
    jcam = Camera(jnp.asarray(locs), jnp.asarray(Rs), jnp.asarray(fovs), res)
    return jcam, camera_from_numpy(locs, Rs, fovs, res)


def int_label_ok(got, want):
    """The integer-label rule of tests/test_mesh.py's batched-vs-single
    annotator test: max diff <= 1 on < 2% of pixels, or <= 32 on < 0.1%.
    -> (ok, max diff, fraction of differing pixels)."""
    diff = np.abs(np.asarray(got).astype(np.int64)
                  - np.asarray(want).astype(np.int64))
    frac = float((diff > 0).mean())
    dmax = int(diff.max()) if diff.size else 0
    ok = (dmax <= 1 and frac < 0.02) or (dmax <= 32 and frac < 1e-3)
    return ok, dmax, frac


def room_sphere_views(res):
    """Room + dense sphere (3,980 faces, 64 chunks of 64) and two views:
    walls give short exact lists, the sphere long ones.
    -> (JAX mesh, port mesh, JAX cameras, port cameras)."""
    from omnidata_tpu.mesh import from_arrays, room, uv_sphere

    r = room(size=6.0, height=3.0)
    s = uv_sphere(radius=0.7, center=(0.6, 0.1, 1.2), n_lat=32, n_lon=64)
    vs = np.concatenate([np.asarray(r.vertices), np.asarray(s.vertices)])
    fs = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                         np.asarray(s.faces[: s.num_faces]) + r.vertices.shape[0]])
    jmesh = from_arrays(vs, fs)
    locs = np.array([[1.1, 0.5, 1.4], [-0.8, 0.9, 1.6]], np.float32)
    tgts = np.array([[0.3, 0.0, 1.0], [0.5, -0.3, 0.8]], np.float32)
    jcam, tcam = both_cameras(locs, look_at_np(locs, tgts),
                              np.array([1.2, 1.0], np.float32), res)
    return jmesh, port_mesh(jmesh), jcam, tcam


def admission_lists(overlap, true_counts, ccap, hier, expand_bcap=None):
    """The JAX package's capped encoding
    (``omnidata_tpu.mesh.raster.admission_lists``) in plain PyTorch, on any
    device: per-tile ascending chunk-id lists from the (rows, n_chunks)
    overlap matrix -> (ids (rows, ccap) int32, counts (rows,) int32).

    counts encoding:
      >= 0  exact list of that many chunk ids;
      == -1 scan all chunks (the list overflowed ccap);
      <= -2 block mode: ids hold bcount = -count-2 ascending 8-chunk Morton
            BLOCK ids, each expanded to its 8 chunks.

    hier=False: one top-k over all chunks. hier=True: top-k over 8-chunk
    blocks, then an exact per-chunk top-k over the first expand_bcap
    (default 32) admitted blocks' chunks; rows with more admitted blocks
    take block mode when their block list fits ccap, else scan-all."""
    import torch

    from omnidata_tpu_torch.mesh.raster import _ascending_first

    rows, n_chunks = overlap.shape
    true_counts = true_counts.to(torch.int32)
    counts = torch.where(true_counts > ccap, -1, true_counts)
    pad = torch.nn.functional.pad
    if not hier:
        vals, idx = _ascending_first(overlap, min(ccap, n_chunks))
        ids = torch.where(vals > n_chunks, idx, 0)
        if n_chunks < ccap:
            ids = pad(ids, (0, ccap - n_chunks))
        return ids, counts
    ab = 8
    ncb = -(-n_chunks // ab)
    ovb_any = pad(overlap, (0, ncb * ab - n_chunks)).reshape(rows, ncb, ab).any(-1)
    bcount = ovb_any.sum(-1).to(torch.int32)
    bcap = min(ccap, ncb)
    bvals, bidx = _ascending_first(ovb_any, bcap)
    blist = torch.where(bvals > ncb, bidx, ncb)  # pad -> all-zero sentinel block
    bcap2 = min(bcap, 32 if expand_bcap is None else expand_bcap)
    lanes = torch.arange(ab, dtype=torch.int32, device=overlap.device)
    cand = (blist[:, :bcap2, None] * ab + lanes).reshape(rows, bcap2 * ab)
    ov2p = pad(overlap, (0, (ncb + 1) * ab - n_chunks))
    ovc = torch.gather(ov2p, 1, cand.long())  # (rows, bcap2*ab)
    ca = bcap2 * ab
    k2 = min(ccap, ca)
    vals2, idx2 = _ascending_first(ovc, k2)
    ids = torch.where(vals2 > ca, torch.gather(cand, 1, idx2.long()), 0)
    if k2 < ccap:
        ids = pad(ids, (0, ccap - k2))
    ids_block = torch.where(bvals > ncb, bidx, 0)
    if bcap < ccap:
        ids_block = pad(ids_block, (0, ccap - bcap))
    exact = (true_counts <= k2) & (bcount <= bcap2)
    block_mode = ~exact & (bcount <= bcap)
    ids = torch.where(block_mode[:, None], ids_block, ids)
    counts = torch.where(exact, true_counts,
                         torch.where(bcount <= bcap, -bcount - 2, -1))
    return ids.contiguous(), counts.to(torch.int32)


def tile_admission(cams, mesh, tile, chunk, ccap, hier_min_chunks=1024,
                   expand_bcap=None):
    """The capped encoding (``admission_lists``) of K views' (view, tile)
    rows, as the JAX package admits: ``raster.tile_overlap`` of the padded
    bboxes, hierarchical past hier_min_chunks chunks (the JAX package's
    default 1024), on the mesh's device -> (ids (K*T, ccap), counts
    (K*T,))."""
    from omnidata_tpu_torch.mesh import raster as traster

    lo, hi = traster.padded_bboxes(cams, mesh, chunk)
    overlap = traster.tile_overlap(lo, hi, cams.resolution, tile, chunk)
    return admission_lists(overlap, overlap.sum(-1), ccap,
                           overlap.shape[1] > hier_min_chunks, expand_bcap)


def capped_as_exact(ids, counts, n_chunks):
    """The capped encoding (``admission_lists``: ids (rows, ccap)) in the
    exact form that the port's raster kernels read (``raster_kernels``'
    module docstring) -> (ids (max(slots, 1),), counts (rows,), offsets
    (rows,)), int32. A listed row keeps its chunks; a block-mode row lists
    the chunks of its 8-chunk blocks below n_chunks, ascending; a scan-all
    row keeps count -1 and no slots. The kernels sweep the same chunks in
    the same order, less the re-sweeps of the last chunk that a block past
    it made, which change no winner."""
    import torch

    rows, ccap = ids.shape
    block = counts <= -2
    j = torch.arange(8 * ccap, device=ids.device)
    by_block = ids.repeat_interleave(8, 1) * 8 + j % 8
    listed = torch.nn.functional.pad(ids, (0, 7 * ccap))
    chunk_ids = torch.where(block[:, None], by_block, listed)
    take = torch.where(block[:, None],
                       (j // 8 < (-counts - 2)[:, None]) & (by_block < n_chunks),
                       j < counts[:, None])
    n = take.sum(1)
    flat = chunk_ids[take].to(torch.int32)  # row-major, so at the offsets
    if flat.numel() == 0:
        flat = torch.zeros(1, dtype=torch.int32, device=ids.device)
    return (flat, torch.where(counts == -1, -1, n).to(torch.int32),
            (torch.cumsum(n, 0) - n).to(torch.int32))


def mixed_lists(mesh, cams, tile, chunk):
    """Raster kernel inputs whose admission lists, in the capped form
    (``tile_admission``, on any device), hold exact, scan-all and
    block-mode rows (ccap 4), with the vertex normals as attributes:
    ((ids, counts, origins, pack, bbox_words, dir_planes), tiles_per_view).
    The JAX package's kernels take these lists; the port's take them
    through ``as_exact``."""
    import torch

    from omnidata_tpu_torch.mesh import raster as traster

    inp = traster.prepare_raster(cams, mesh, tile, chunk, mesh.vertex_normals,
                                 compact=True)
    (f_ids, f_counts), (b_ids, b_counts) = (
        tile_admission(cams, mesh, tile, chunk, 4, h) for h in (10**9, 1))
    use_blk = b_counts <= -2
    ids = torch.where(use_blk[:, None], b_ids, f_ids).contiguous()
    counts = torch.where(use_blk, b_counts, f_counts).contiguous()
    return ((ids, counts, inp.origins, inp.pack, inp.bbox_words,
             inp.dir_planes), inp.tiles_per_view)


def as_exact(args, chunk):
    """Kernel inputs with capped lists (``mixed_lists``) given as the exact
    lists the port's kernels read (``capped_as_exact``) -> (args,
    offsets)."""
    ids, counts, origins, pack, *rest = args
    n_chunks = pack.shape[0] if pack.dim() == 3 else pack.shape[1] // chunk
    ids, counts, offsets = capped_as_exact(ids, counts, n_chunks)
    return (ids, counts, origins, pack, *rest), offsets


def mixed_inputs(mesh, cams, tile, chunk):
    """``mixed_lists`` as exact lists: ((ids, counts, origins, pack,
    bbox_words, dir_planes), offsets, tiles_per_view)."""
    args, T = mixed_lists(mesh, cams, tile, chunk)
    return (*as_exact(args, chunk), T)


def exact_inputs(mesh, cams, tile, chunk, ccap=None):
    """Raster kernel inputs with the card's exact lists
    (``raster.exact_lists``, on any device) in a buffer of ``ccap`` slots a
    row (default: every list fits), with the vertex normals as attributes:
    ((ids, counts, origins, pack, bbox_words, dir_planes), offsets,
    tiles_per_view)."""
    from omnidata_tpu_torch.mesh import raster as traster

    inp = traster.prepare_raster(cams, mesh, tile, chunk, mesh.vertex_normals,
                                 compact=True)
    lo, hi = traster.padded_bboxes(cams, mesh, chunk)
    overlap = traster.tile_overlap(lo, hi, cams.resolution, tile, chunk)
    ids, counts, offsets = traster.exact_lists(
        overlap, ccap or max(int(overlap.sum(1).max()), 1))
    return ((ids, counts, inp.origins, inp.pack, inp.bbox_words,
             inp.dir_planes), offsets, inp.tiles_per_view)


def two_pass_fits(n, ccap):
    """Which rows of set counts n (rows,) a buffer of rows * ccap slots
    lists (``raster.exact_lists``): every row of at most ccap chunks, then
    the longer rows in row order while they fit."""
    import torch

    short = n <= ccap
    long_ends = torch.where(short, 0, n).cumsum(0) + torch.where(short, n, 0).sum()
    return short | (long_ends <= n.numel() * ccap)


def pack_bits(overlap):
    """(rows, n_chunks) bool -> (rows, ceil(n_chunks / 32)) int32, chunk c at
    bit c % 32 of word c // 32: the admission kernels' bit matrix
    (``raster.admission_rows_reference``)."""
    import torch

    rows, n = overlap.shape
    nw = -(-n // 32)
    p = torch.nn.functional.pad(overlap, (0, nw * 32 - n)).reshape(rows, nw, 32)
    w = (p.long() << torch.arange(32, device=p.device)).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def clustered_overlap(rng, rows, n_chunks):
    """A (rows, n_chunks) bool overlap matrix whose rows hold 0 to 450 set
    8-chunk blocks, each a random non-empty set of its chunks, so that
    every ccap from 8 to 192 meets exact, block-mode and scan-all rows."""
    import torch

    ncb = -(-n_chunks // 8)
    ov = np.zeros((rows, ncb * 8), bool)
    for r in range(rows):
        nb = min([0, 1, 2, 3, 5, 7, 8, 9, 20, 33, 60, 200, 300, 450][r % 14], ncb)
        dens = rng.uniform(0.1, 1.0)
        for b in rng.choice(ncb, nb, replace=False):
            m = rng.rand(8) < dens
            m[rng.randint(8)] = True
            ov[r, b * 8:(b + 1) * 8] = m
    return torch.as_tensor(ov[:, :n_chunks])


def chunk_major(pack, chunk):
    """(COLS, Fp) scene pack -> (Fp / chunk, COLS, chunk), kernel C's layout."""
    return pack.reshape(pack.shape[0], -1, chunk).permute(1, 0, 2).contiguous()


def with_block_tail(args, tiles_per_view, chunk):
    """Cut the scene to its first n chunks, the most with n % 8 != 0 (so the
    last 8-chunk block runs past the last chunk) and a last chunk that some
    tile overlaps, and turn the row whose tile overlaps most of its faces
    into a block-mode row listing that block alone. Capped lists
    (``mixed_lists``) in and out. -> (args, row, n)."""
    import math

    import torch

    from omnidata_tpu_torch.mesh.raster_kernels import band_mask_and_flags

    ids, counts, origins, pack, words, dirs = args
    rows, P = dirs[0].shape
    tile, n1d = math.isqrt(P), math.isqrt(tiles_per_view)
    r = torch.arange(rows, device=ids.device)
    tiv = r % tiles_per_view
    for n in range(pack.shape[1] // chunk, 0, -1):
        if n % 8 == 0:
            continue
        last = words[r // tiles_per_view, (n - 1) * chunk:n * chunk]
        m, _ = band_mask_and_flags(last, (tiv % n1d)[:, None],
                                   (tiv // n1d)[:, None], tile, P, 1)
        if bool(m.any()):
            break
    row = int(m.sum(1).argmax())
    Fp = n * chunk
    ids, counts = ids.clone(), counts.clone()
    ids[row] = 0
    ids[row, 0] = (n - 1) // 8
    counts[row] = -3  # one block
    return (ids, counts, origins, pack[:, :Fp].contiguous(),
            words[:, :Fp].contiguous(), dirs), row, n


def assert_same_tree(got, want, path="root"):
    """Nested dicts / lists / arrays equal in structure; integers, booleans
    and strings equal; floats within TREE_TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)) or (isinstance(want, np.ndarray)
                                              and want.dtype.kind == "f"):
        assert len(got) == len(want), (path, len(got), len(want))
        if isinstance(want, np.ndarray):
            assert np.asarray(got).dtype == want.dtype, path
            np.testing.assert_allclose(got, want, atol=TREE_TOL, err_msg=path)
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= TREE_TOL, (path, got, want)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def jax_mini_scene(d: str, tasks=("rgb", "normal", "depth_zbuffer", "mask_valid")) -> str:
    """Annotate the room + cube scene of tests/test_train.py:25 with the JAX
    CLI into d (8 views at 64²: point_info and each of tasks) and return
    d."""
    import os

    import omnidata_tpu.annotator.cli as cli
    from omnidata_tpu.mesh import cube, room

    r = room(size=8.0, height=3.0)
    c = cube(size=1.0, center=(1.5, 0.5, 0.5))
    v = np.concatenate([np.asarray(r.vertices), np.asarray(c.vertices)])
    f = np.concatenate([np.asarray(r.faces[: r.num_faces]),
                        np.asarray(c.faces[: c.num_faces]) + r.vertices.shape[0]])
    col = (np.random.RandomState(0).rand(len(v), 3) * 255).astype(np.uint8)
    with open(os.path.join(d, "mesh.ply"), "w") as fh:
        fh.write(
            f"ply\nformat ascii 1.0\nelement vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n")
        for vv, cc in zip(v, col):
            fh.write(f"{vv[0]} {vv[1]} {vv[2]} {cc[0]} {cc[1]} {cc[2]}\n")
        for ff in f:
            fh.write(f"3 {ff[0]} {ff[1]} {ff[2]}\n")
    cli.main(["--model_path", d, "--task", "points", "with", "NUM_POINTS=2",
              "RESOLUTION=64", "MIN_CAMERA_SPACING=2.0", "MAX_VIEWS_PER_POINT=4",
              "MIN_NONFIXATED_AFTER_PRUNE=0"])
    for task in tasks:
        cli.main(["--model_path", d, "--task", task, "with", "RESOLUTION=64",
                  "RASTER_TILE=32", "RASTER_CAP=256", "RASTER_CHUNK=64"])
    return d


@functools.lru_cache(maxsize=1)
def _tiny_dpt_shapes() -> dict:
    from omnidata_tpu_torch.models import DPTHybrid

    return {k: v.shape for k, v in DPTHybrid(num_channels=1, **TINY_DPT).state_dict().items()}


def tiny_dpt_state_dict(flax_tree) -> dict:
    """A tiny DPT's Flax tree (its params, or a param-shaped optimizer
    moment) as a port state dict; the never-run published tensors
    ('*_drop': the classifier, refinenet4's first unit) zeros of the tiny
    net's shapes."""
    import torch

    from omnidata_tpu_torch.models.convert import _dpt_mapping, state_dict_from_flax

    conv = state_dict_from_flax(_dpt_mapping(TINY_DPT["vit_blocks"]), flax_tree)
    return {k: conv[k] if conv[k].shape == shape else torch.zeros(shape)
            for k, shape in _tiny_dpt_shapes().items()}
