"""omnidata_tpu_torch.annotator.distributed (one process, one host thread
per device) against the port's single-device ``annotate_views`` and the
JAX package's, on tests/test_train.py:315's 8-camera room.

Tolerances: over ["cpu"] * 2 and ["cpu"] * 4 every label equals the
port's ``annotate_views`` on the whole batch bit for bit (the CPU
convolutions run image by image, so a view's labels do not depend on its
batch); against JAX's ``annotate_views`` (Pallas in interpret mode) the
integer-label rule of tests/test_mesh.py:366-375.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.annotator import annotate_views as j_annotate_views
from omnidata_tpu.core import Camera as JCamera
from omnidata_tpu.core import look_at_rotation
from omnidata_tpu.mesh import from_arrays, room
from omnidata_tpu_torch.annotator import (
    DEVICE_MODALITIES,
    annotate_views,
    annotate_views_sharded,
    make_annotate_mesh,
)
from omnidata_tpu_torch.core.cameras import Camera

from _torch_port_util import int_label_ok, port_mesh

torch.set_num_threads(1)

KW = dict(tile=32, chunk=64)


@pytest.fixture(scope="module")
def room_views():
    """room() with seeded vertex colours (so the texture edges, whose
    convolutions see the batch, are compared too) and 8 cameras on a circle
    looking at the origin, 64²."""
    r = room()
    colours = np.random.RandomState(0).rand(r.vertices.shape[0], 3).astype(np.float32)
    jmesh = from_arrays(np.asarray(r.vertices), np.asarray(r.faces[: r.num_faces]),
                        vertex_colors=colours)
    locs = np.stack([[2.0 * np.cos(a), 2.0 * np.sin(a), 1.5]
                     for a in np.linspace(0, 6.2, 8)]).astype(np.float32)
    Rs = jax.vmap(lambda l: look_at_rotation(l, jnp.zeros(3)))(jnp.asarray(locs))
    jcams = JCamera(jnp.asarray(locs), Rs, jnp.full((8,), 1.0), 64)
    tcams = Camera(torch.from_numpy(locs), torch.from_numpy(np.array(Rs)),
                   torch.full((8,), 1.0), 64)
    tmesh = port_mesh(jmesh)
    return jmesh, tmesh, jcams, tcams, annotate_views(tcams, tmesh, **KW)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_equals_single_device(room_views, n):
    _, tmesh, _, tcams, single = room_views
    out = annotate_views_sharded(tcams, tmesh, device_mesh=["cpu"] * n, **KW)
    # no curvature mesh, no face labels
    assert set(out) == set(single) == set(DEVICE_MODALITIES) - {
        "principal_curvature", "semantic"}
    for k in single:
        assert out[k].shape[0] == 8 and out[k].device.type == "cpu"
        assert torch.equal(out[k], single[k]), k


def test_sharded_matches_jax(room_views):
    jmesh, tmesh, jcams, tcams, _ = room_views
    mods = ("depth_zbuffer", "mask_valid")
    out = annotate_views_sharded(tcams, tmesh, device_mesh=["cpu"] * 2,
                                 modalities=mods, cap=256, **KW)
    want = j_annotate_views(jcams, jmesh, modalities=mods, interpret=True,
                            cap=256, **KW)
    assert set(out) == set(mods)
    assert set(np.unique(out["mask_valid"].numpy())) <= {0, 255}
    for k in mods:
        g, w = out[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (8, 64, 64) and g.dtype == w.dtype
        ok, dmax, frac = int_label_ok(g, w)
        assert ok, (k, dmax, frac)


def test_sharded_rejects_an_uneven_split(room_views):
    _, tmesh, _, tcams, _ = room_views
    with pytest.raises(ValueError, match="not divisible"):
        annotate_views_sharded(tcams, tmesh, device_mesh=["cpu"] * 3, **KW)


def test_make_annotate_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_annotate_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_annotate_mesh() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert make_annotate_mesh(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="3 devices asked for, 2 present"):
        make_annotate_mesh(3)
