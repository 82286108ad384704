"""The port's render stage on the 39,760-face bench scene against the JAX
package's brute-force raycaster (every ray against every face, no
admission): small test meshes once hid a candidate-dropping bug, so the
chunk admission is checked at bench geometry, for each raster kernel
(chunk list, compacting, streamed, streamed + compacting; their plain
versions here). Two views at 64², the bench's tile 32 and chunk 128: at
the default ccap, where every row is listed exactly, and at ccap 1, a buffer
of list_slots(1, 312) = 10 slots a row, which the longest rows overflow, so
that the lists hold scan-all rows too. The raycast runs once per module.

Tolerance: `valid` equal everywhere; `face` equal on >= 99.9% of pixels;
where faces differ (shared-edge or coplanar ties, which the raycaster's
unfactored Möller–Trumbore breaks differently) t within 1e-4 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.mesh.mesh import TriangleMesh as JaxMesh
from omnidata_tpu.mesh.raycast import raycast as j_raycast
from omnidata_tpu_torch import scenes
from omnidata_tpu_torch.core.cameras import Camera
from omnidata_tpu_torch.mesh import raster as traster

from _torch_port_util import MESH_FIELDS

torch.set_num_threads(1)

RES = 64


@pytest.fixture(scope="module")
def bench_views():
    """The bench scene, two views, the raster inputs and the JAX brute
    raycast's (valid, face, t) images."""
    mesh, _ = scenes.build_scene()
    locs, Rs, fovs = scenes.sample_cameras_np(2, seed=1)
    cams = Camera(torch.as_tensor(locs), torch.as_tensor(Rs),
                  torch.as_tensor(fovs), RES)
    inp = traster.prepare_raster(cams, mesh, tile=32, chunk=128)
    assert (inp.counts >= 0).all()  # the main path lists every row
    jmesh = JaxMesh(num_faces=mesh.num_faces, **{
        k: None if getattr(mesh, k) is None else jnp.asarray(getattr(mesh, k).numpy())
        for k in MESH_FIELDS})
    origins = np.repeat(inp.origins.numpy(), RES * RES, 0)
    hits = j_raycast(jnp.asarray(origins),
                     jnp.asarray(inp.dirs.numpy().reshape(-1, 3)), jmesh)
    want = tuple(np.asarray(a).reshape(2, RES, RES)
                 for a in (hits.valid, hits.face, hits.t))
    return mesh, cams, want


KERNELS = pytest.mark.parametrize(
    "kw", [{}, dict(compact=True), dict(streamed=True, compact=False),
           dict(streamed=True)],
    ids=["chunklist", "compact", "streamed", "streamed_compact"])


def _check_render(bench_views, kw, **opts):
    mesh, cams, (jv, jf, jt) = bench_views
    frag = traster.render_views_fused(cams, mesh, tile=32, chunk=128,
                                      **opts, **kw)
    tv, tf, tt = frag.valid.numpy(), frag.face.numpy(), frag.t.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert tv.mean() > 0.99  # inside a closed room
    assert (tf == jf).mean() >= 0.999, (tf != jf).sum()
    differ = (tf != jf) & tv
    np.testing.assert_allclose(tt[differ], jt[differ], rtol=1e-4)


@KERNELS
def test_bench_scene_render_matches_brute_raycaster(bench_views, kw):
    _check_render(bench_views, kw)


@KERNELS
def test_bench_scene_scan_all_rows_match_brute_raycaster(bench_views, kw):
    mesh, cams, _ = bench_views
    counts = traster.prepare_raster(cams, mesh, tile=32, chunk=128,
                                    ccap=1).counts
    assert (counts == -1).any() and (counts >= 0).any()
    _check_render(bench_views, kw, ccap=1)
