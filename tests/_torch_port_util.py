"""Shared helpers of the tests that hold omnidata_tpu_torch against the JAX
package: numpy inputs go through both, and results come back as numpy."""
import numpy as np

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


def mixed_inputs(mesh, cams, tile, chunk):
    """Raster kernel inputs whose admission lists hold exact, scan-all and
    block-mode rows (ccap 4), with the vertex normals as attributes:
    ((ids, counts, origins, pack, bbox_words, dir_planes), tiles_per_view)."""
    import torch

    from omnidata_tpu_torch.mesh import raster as traster

    flat, blk = (traster.prepare_raster(cams, mesh, tile, chunk,
                                        mesh.vertex_normals, ccap=4,
                                        hier_min_chunks=h, compact=True)
                 for h in (10**9, 1))
    use_blk = blk.counts <= -2
    ids = torch.where(use_blk[:, None], blk.ids, flat.ids).contiguous()
    counts = torch.where(use_blk, blk.counts, flat.counts).contiguous()
    return ((ids, counts, flat.origins, flat.pack, flat.bbox_words,
             flat.dir_planes), flat.tiles_per_view)


def chunk_major(pack, chunk):
    """(COLS, Fp) scene pack -> (Fp / chunk, COLS, chunk), kernel C's layout."""
    return pack.reshape(pack.shape[0], -1, chunk).permute(1, 0, 2).contiguous()


def with_block_tail(args, tiles_per_view, chunk):
    """Cut the scene to its first n chunks, the most with n % 8 != 0 (so the
    last 8-chunk block runs past the last chunk) and a last chunk that some
    tile overlaps, and turn the row whose tile overlaps most of its faces
    into a block-mode row listing that block alone. -> (args, row, n)."""
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


def jax_mini_scene(d: str) -> str:
    """Annotate the room + cube scene of tests/test_train.py:25 with the JAX
    CLI into d (8 views at 64²: rgb, normal, depth_zbuffer, mask_valid,
    point_info) and return d."""
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
    for task in ("rgb", "normal", "depth_zbuffer", "mask_valid"):
        cli.main(["--model_path", d, "--task", task, "with", "RESOLUTION=64",
                  "RASTER_TILE=32", "RASTER_CAP=256", "RASTER_CHUNK=64"])
    return d
