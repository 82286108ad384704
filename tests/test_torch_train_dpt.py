"""One DPT-hybrid depth training step of the port against the JAX
package's on the CPU, at 64², past the 15k schedule switch (SSI, gradient
matching and VNL all in the loss), with JAX-initialised Flax weights
carried across by ``convert.state_dict_from_flax`` and JAX's triplets
given to the port. The JAX side is jitted (its DPT init and step compile
take most of this file's time).

Tolerances, float32: the loss terms within 1e-3 (tests/test_torch_models.py's
whole-net bound; the forward passes agree to it); after the Adam step, no
parameter more than 2 lr from JAX's (a gradient near zero may change sign)
and the parameters' moves within 5% of JAX's in L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnidata_tpu import train as jtrain
from omnidata_tpu.losses import VNLParams as JVNLParams
from omnidata_tpu.losses import sample_triplets as j_sample_triplets
from omnidata_tpu.models import DPTHybrid as JDPT
from omnidata_tpu_torch import train as ttrain
from omnidata_tpu_torch.losses import VNLParams
from omnidata_tpu_torch.models import DPTHybrid
from omnidata_tpu_torch.models.convert import _dpt_mapping, state_dict_from_flax

torch.set_num_threads(1)

NET_TOL = 1e-3
MOVE_TOL = 0.05
H = 64


def test_dpt_depth_step_equals_jax():
    rng = np.random.RandomState(0)
    mask = np.ones((1, 1, H, H), bool)
    mask[..., 8:20, 30:44] = False
    batch = {"rgb": (rng.rand(1, 3, H, H) * 2 - 1).astype(np.float32),
             "depth": (rng.rand(1, 1, H, H) * 0.5 + 0.1).astype(np.float32),
             "mask_valid": mask}
    lr = 1e-5
    step_no = jtrain.SSI_ONLY_STEPS + 1
    key = jax.random.PRNGKey(1)
    jparams = JVNLParams(1.0, 1.0, (H, H))

    jmodel = JDPT(num_channels=1)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 3)))

    def japply(v, x):
        return jmodel.apply(v, jnp.transpose(x, (0, 2, 3, 1)))[..., 0]

    jstate = jtrain.create_train_state(variables, jtrain.depth_optimizer(lr=lr))
    jstate = jstate.replace(step=jnp.asarray(step_no, jnp.int32))
    jstep = jax.jit(jtrain.make_depth_train_step(japply, jparams))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    host = jax.device_get(variables)
    net = DPTHybrid(num_channels=1)
    net.load_state_dict(state_dict_from_flax(_dpt_mapping(), host))
    start = {k: v.clone() for k, v in net.state_dict().items()}
    tstate = ttrain.create_train_state(net, ttrain.depth_optimizer(lr=lr))
    assert len(tstate.names) == len(jax.tree_util.tree_leaves(host))  # the Flax tree's
    tstate.step = step_no
    tstep = ttrain.make_depth_train_step(lambda n, x: n(x)[:, 0], VNLParams(1.0, 1.0, (H, H)))
    triplets = torch.from_numpy(np.asarray(j_sample_triplets(key, jparams))).long()
    tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, triplets=triplets)

    for k in ("loss", "ssi", "reg", "vnl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=NET_TOL, err_msg=k)
    want = state_dict_from_flax(_dpt_mapping(), jax.device_get(jnew.params))
    got = net.state_dict()
    names = tstate.names
    assert all(bool(((got[k] - want[k]).abs() <= 2 * lr + 2**-22 * want[k].abs()).all())
               for k in names)  # 2 lr, plus the rounding of p + u
    d_got = torch.cat([(got[k] - start[k]).flatten() for k in names])
    d_want = torch.cat([(want[k] - start[k]).flatten() for k in names])
    assert float(d_want.norm()) > 0
    assert float((d_got - d_want).norm() / d_want.norm()) <= MOVE_TOL
    for k in set(got) - set(names):  # never-run published tensors stay put
        assert torch.equal(got[k], start[k]), k
