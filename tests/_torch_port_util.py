"""Shared helpers of the tests that hold omnidata_tpu_torch against the JAX
package: numpy inputs go through both, and results come back as numpy."""
import numpy as np

from omnidata_tpu_torch.interop import camera_from_numpy, mesh_from_numpy
from omnidata_tpu_torch.mesh import TriangleMesh

MESH_FIELDS = tuple(f for f in TriangleMesh._fields if f != "num_faces")


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
