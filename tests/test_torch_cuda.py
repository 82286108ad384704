"""Card-only tests of the CUDA raster kernel: bit-exact against its plain
PyTorch version on the same CUDA tensors, for every list encoding and for
two pixel-per-thread layouts, and a refused launch raises.

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


def _mixed_inputs(mesh, cams, tile):
    """Admission lists holding exact, scan-all and block-mode rows."""
    flat = traster.prepare_raster(cams, mesh, tile, CHUNK, mesh.vertex_normals,
                                  ccap=4, hier_min_chunks=10**9)
    blk = traster.prepare_raster(cams, mesh, tile, CHUNK, mesh.vertex_normals,
                                 ccap=4, hier_min_chunks=1)
    use_blk = blk.counts <= -2
    ids = torch.where(use_blk[:, None], blk.ids, flat.ids).contiguous()
    counts = torch.where(use_blk, blk.counts, flat.counts).contiguous()
    return (ids, counts, flat.origins, flat.pack, flat.dir_planes), flat.tiles_per_view


@pytest.mark.parametrize("tile", [8, 16, 32, 64])  # 1, 1, 4, 16 px/thread
def test_kernel_matches_plain_version_bitwise(cuda_scene, tile):
    mesh, cams = cuda_scene
    args, T = _mixed_inputs(mesh, cams, tile)
    if tile == 16:
        c = args[1].cpu()
        assert (c >= 0).any() and (c == -1).any() and (c <= -2).any(), c
    before = tk.raster_tiles_chunklist.launches
    packed, acc = tk.raster_tiles_chunklist(*args, chunk=CHUNK, tiles_per_view=T)
    torch.cuda.synchronize()
    assert tk.raster_tiles_chunklist.launches == before + 1
    want_packed, want_acc = tk.raster_tiles_chunklist_reference(
        *args, chunk=CHUNK, tiles_per_view=T)
    assert torch.equal(packed, want_packed)
    assert torch.equal(acc.view(torch.int32), want_acc.view(torch.int32))
    assert (packed < tk.BIG_PACKED).float().mean() > 0.9


def test_refused_launch_raises(cuda_scene):
    """3 pixels per thread is no kernel instantiation: the C side refuses
    the launch and the wrapper raises."""
    mesh, cams = cuda_scene
    args, T = _mixed_inputs(mesh, cams, 32)
    dirs = tuple(d[:, :768].contiguous() for d in args[4])
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk.raster_tiles_chunklist(*args[:4], dirs, chunk=CHUNK, tiles_per_view=T)


def test_render_views_fused_kernel_equals_plain_raster(cuda_scene, monkeypatch):
    mesh, cams = cuda_scene
    got = traster.render_views_fused(cams, mesh, 32, CHUNK, mesh.vertex_colors)
    monkeypatch.setattr(traster, "raster_tiles_chunklist",
                        tk.raster_tiles_chunklist_reference)
    want = traster.render_views_fused(cams, mesh, 32, CHUNK, mesh.vertex_colors)
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(g, w)
