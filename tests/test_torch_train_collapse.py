"""Does the depth trainer's output go to zero in the port alone? The JAX
package's and the port's depth steps, 12 of them from step 0 (SSI only,
lr 1e-5 as config/depth.yml, no augmentation), on the mini scene the JAX
CLI annotates (8 views at 64², batches of 2 in turn), with the tiny DPT's
Flax weights carried across by ``convert.state_dict_from_flax`` and JAX's
triplets given to the port. After each step the share of exactly-zero
predictions on the step's 2 views (the net ends in a ReLU) is compared.

- Each step from the same state: before every step the port takes JAX's
  parameters and Adam moments, so each comparison holds one step of each
  package; the shares agree within SHARE_TOL 0.02 after every step.
- Free-running, each package from its own previous step: after the first
  step about 40% of the outputs are zero in both; neither package
  collapses to all zeros in 12 steps (both stay under MAX_ZERO_SHARE). The
  two trajectories part after a few steps: Adam's first steps move each
  parameter by about ±lr by its gradient's sign, so where the packages'
  float32 rounding sets a small gradient's sign differently the states
  part, and later steps compound it.

Neither collapses at this size. At full width the collapse is the
reference's behaviour (tests/depth_collapse_experiment.py, CPU, 128²,
batch 2): from the port's seeded initialisation the first step leaves
99.9% of the outputs at zero in both packages, and whether a run then dies
depends on the packages' rounding alone: JAX going on from the port's
state after that step dies as the port does, the port going on from JAX's
recovers as JAX does. The last test pins the state such a run ends in: a
head whose every output is zero gets no gradient in either package, so
no step leaves it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu import train as jtrain
from omnidata_tpu.losses import VNLParams as JVNLParams
from omnidata_tpu.losses import sample_triplets as j_sample_triplets
from omnidata_tpu.models import DPTHybrid as JDPT
from omnidata_tpu_torch import train as ttrain
from omnidata_tpu_torch.data.dataset import OmnidataDataset, Options
from omnidata_tpu_torch.losses import VNLParams
from omnidata_tpu_torch.models import DPTHybrid

from _torch_port_util import TINY_DPT, jax_mini_scene, tiny_dpt_state_dict

torch.set_num_threads(1)

H, STEPS, LR = 64, 12, 1e-5
SHARE_TOL = 0.02
MAX_ZERO_SHARE = 0.99


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    d = jax_mini_scene(str(tmp_path_factory.mktemp("scene")),
                       tasks=("rgb", "depth_zbuffer", "mask_valid"))
    ds = OmnidataDataset(Options(data_path=d, tasks=("rgb", "depth_zbuffer", "mask_valid"),
                                 image_size=H, random_flip=False))
    b = next(ds.batches(8, shuffle=False))
    return {"rgb": (b["rgb"] * 2 - 1).astype(np.float32),
            "depth": b["depth_zbuffer"].astype(np.float32),
            "mask_valid": b["mask_valid"] > 0.5}


@pytest.fixture(scope="module")
def runs(views):
    """-> (per-step shares from JAX's state, free-running shares): each a
    list of (JAX share, port share) after steps 1..STEPS."""
    model = JDPT(num_channels=1, **TINY_DPT)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 3)))

    def japply(v, x):
        return model.apply(v, jnp.transpose(x, (0, 2, 3, 1)))[..., 0]

    jstep = jax.jit(jtrain.make_depth_train_step(japply, JVNLParams(1.0, 1.0, (H, H))))
    jforward = jax.jit(japply)
    tstep = ttrain.make_depth_train_step(lambda n, x: n(x)[:, 0], VNLParams(1.0, 1.0, (H, H)))

    def zero_share_jax(state, rgb):
        return float((np.asarray(jforward(state.params, rgb)) == 0).mean())

    def zero_share_port(state, rgb):
        with torch.no_grad():
            return float((state.net(rgb) == 0).float().mean())

    def new_port_state():
        net = DPTHybrid(num_channels=1, **TINY_DPT)
        net.load_state_dict(tiny_dpt_state_dict(jax.device_get(variables)))
        return ttrain.create_train_state(net, ttrain.depth_optimizer(lr=LR))

    def take_jax_state(tstate, jstate):
        tstate.net.load_state_dict(tiny_dpt_state_dict(jax.device_get(jstate.params)))
        adam = next(s for s in jax.tree_util.tree_leaves(
            jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
        for key in ("mu", "nu"):
            sd = tiny_dpt_state_dict(jax.device_get(getattr(adam, key)))
            tstate.opt_state[key] = [sd[n].clone() for n in tstate.names]
        tstate.opt_state["count"] = torch.tensor(int(adam.count), dtype=torch.int32)
        tstate.step = int(jstate.step)

    forced, free = [], []
    # one JAX trajectory: the forced port steps start from its states
    jstate = jtrain.create_train_state(variables, jtrain.depth_optimizer(lr=LR))
    tforced, tfree = new_port_state(), new_port_state()
    for s in range(STEPS):
        rows = slice(2 * (s % 4), 2 * (s % 4) + 2)
        jb = {k: jnp.asarray(v[rows]) for k, v in views.items()}
        tb = {k: torch.from_numpy(v[rows]) for k, v in views.items()}
        key = jax.random.PRNGKey(s)
        triplets = torch.from_numpy(np.array(j_sample_triplets(key, JVNLParams(1.0, 1.0, (H, H)))))
        take_jax_state(tforced, jstate)
        jstate, _ = jstep(jstate, jb, key)
        tstep(tforced, tb, triplets=triplets.long())
        share = zero_share_jax(jstate, jb["rgb"])
        forced.append((share, zero_share_port(tforced, tb["rgb"])))
        tstep(tfree, tb, triplets=triplets.long())
        free.append((share, zero_share_port(tfree, tb["rgb"])))
    return forced, free


def test_each_step_leaves_the_zero_share_of_jax(runs):
    forced, _ = runs
    gaps = [abs(j - t) for j, t in forced]
    assert max(gaps) <= SHARE_TOL, forced


def test_neither_package_collapses_in_12_steps(runs):
    _, free = runs
    assert all(j < MAX_ZERO_SHARE and t < MAX_ZERO_SHARE for j, t in free), free
    assert 0.2 < free[0][0] < 0.8 and 0.2 < free[0][1] < 0.8, free


def test_a_dead_head_stays_dead_in_both_packages(views):
    """Every output of the depth net's final ReLU at zero (the last conv's
    bias at -10): the SSI loss of a constant (1 within its epsilon) in both
    packages, no parameter moved by either package's steps, the output
    all zero after each."""
    model = JDPT(num_channels=1, **TINY_DPT)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 3)))
    params = jax.tree_util.tree_map(lambda x: x, jax.device_get(variables))
    head = params["params"]["head_conv3"]
    head["bias"] = np.full_like(head["bias"], -10.0)

    def japply(v, x):
        return model.apply(v, jnp.transpose(x, (0, 2, 3, 1)))[..., 0]

    jstep = jax.jit(jtrain.make_depth_train_step(japply, JVNLParams(1.0, 1.0, (H, H))))
    jstate = jtrain.create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                       jtrain.depth_optimizer(lr=LR))
    net = DPTHybrid(num_channels=1, **TINY_DPT)
    net.load_state_dict(tiny_dpt_state_dict(params))
    start = {k: v.clone() for k, v in net.state_dict().items()}
    tstate = ttrain.create_train_state(net, ttrain.depth_optimizer(lr=LR))
    tstep = ttrain.make_depth_train_step(lambda n, x: n(x)[:, 0], VNLParams(1.0, 1.0, (H, H)))
    for s in range(3):
        rows = slice(2 * s, 2 * s + 2)
        key = jax.random.PRNGKey(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v[rows]) for k, v in views.items()}, key)
        triplets = torch.from_numpy(np.array(j_sample_triplets(key, JVNLParams(1.0, 1.0, (H, H)))))
        tm = tstep(tstate, {k: torch.from_numpy(v[rows]) for k, v in views.items()},
                   triplets=triplets.long())
        assert abs(float(jm["loss"]) - 1.0) < 1e-3 and abs(float(tm["loss"]) - 1.0) < 1e-3
        assert abs(float(jm["loss"]) - float(tm["loss"])) < 1e-5  # float32 means
        rgb = views["rgb"][rows]
        assert (np.asarray(jax.jit(japply)(jstate.params, jnp.asarray(rgb))) == 0).all()
        with torch.no_grad():
            assert (tstate.net(torch.from_numpy(rgb)) == 0).all()
    assert all(bool((a == b).all()) for a, b in zip(
        jax.tree_util.tree_leaves(jstate.params), jax.tree_util.tree_leaves(params)))
    assert all(torch.equal(v, start[k]) for k, v in tstate.net.state_dict().items())
