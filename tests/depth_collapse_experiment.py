"""Experiment (not a tier-1 test): does the full-width DPT-hybrid-384 depth
trainer's output go to zero in both packages, or in the port alone?

Both packages take depth steps (SSI stage, lr 1e-5 as config/depth.yml,
no augmentation) from the same weights on the same batches, on the CPU,
JAX's triplets given to the port. ``--init jax``: JAX's initial
parameters (``module.init`` at PRNGKey(0)) carried to the port by
``models.convert.state_dict_from_flax``; ``--init port``: the port's
(``init_weights`` from seed 0, as ``train_depth`` starts) carried to JAX
by its ``models.convert.convert_dpt``. After each step, the share of
exactly-zero predictions (the net ends in a ReLU) on the step's batch:

- ``jax``: JAX free-running;
- ``port_forced``: the port's step taken from JAX's state before it
  (parameters and Adam moments), so each value holds one step of each
  package against the same state;
- ``port_free``: the port free-running from the same weights;
- ``port_own_init``: the port free-running from its own seeded
  initialisation (``init_weights``, as ``train_depth`` starts);
- ``port_from_jax`` and ``jax_from_port``, after ``--swap_after`` steps:
  each package free-running from the other's state at that step
  (parameters and Adam moments), which differ by the packages' rounding
  alone.

The batches are the first views of an annotated directory (rgb,
depth_zbuffer, mask_valid; e.g. a scene of the accuracy chain), resized to
``--size``, ``--batch`` at a time in turn.

    python tests/depth_collapse_experiment.py --data DIR --size 128 --batch 2 \\
        [--init jax|port] [--steps 12] [--swap_after 1] [--out result.json]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def load_views(data: str, size: int, n: int) -> dict:
    from omnidata_tpu_torch.data.dataset import OmnidataDataset, Options

    ds = OmnidataDataset(Options(data_path=data, tasks=("rgb", "depth_zbuffer", "mask_valid"),
                                 image_size=size, random_flip=False))
    b = next(ds.batches(n, shuffle=False))
    return {"rgb": (b["rgb"] * 2 - 1).astype(np.float32),
            "depth": b["depth_zbuffer"].astype(np.float32),
            "mask_valid": b["mask_valid"] > 0.5}


def run(data: str, size: int, batch: int, steps: int, n_views: int,
        init: str = "jax", swap_after: int = 1) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from omnidata_tpu import train as jtrain
    from omnidata_tpu.losses import VNLParams as JVNLParams
    from omnidata_tpu.losses import sample_triplets as j_sample_triplets
    from omnidata_tpu.models import DPTHybrid as JDPT
    from omnidata_tpu.models import convert_dpt
    from omnidata_tpu_torch import train as ttrain
    from omnidata_tpu_torch.losses import VNLParams
    from omnidata_tpu_torch.models import DPTHybrid
    from omnidata_tpu_torch.models.convert import _dpt_mapping, state_dict_from_flax
    from omnidata_tpu_torch.models.registry import init_weights

    views = load_views(data, size, n_views)
    n_batches = n_views // batch
    model = JDPT(num_channels=1)
    if init == "jax":
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    else:
        own = DPTHybrid(num_channels=1)
        init_weights(own, torch.Generator().manual_seed(0))
        variables = jax.tree.map(jnp.asarray, convert_dpt(
            {k: v.numpy() for k, v in own.state_dict().items()}))

    def japply(v, x):
        return model.apply(v, jnp.transpose(x, (0, 2, 3, 1)))[..., 0]

    jvnl = JVNLParams(1.0, 1.0, (size, size))
    jstep = jax.jit(jtrain.make_depth_train_step(japply, jvnl))
    jforward = jax.jit(japply)
    tstep = ttrain.make_depth_train_step(lambda n, x: n(x)[:, 0], VNLParams(1.0, 1.0, (size, size)))

    def sd(tree):
        return state_dict_from_flax(_dpt_mapping(), jax.device_get(tree))

    def port_state(own_init: bool):
        net = DPTHybrid(num_channels=1)
        if own_init:
            init_weights(net, torch.Generator().manual_seed(0))
        else:
            net.load_state_dict(sd(variables))
        return ttrain.create_train_state(net, ttrain.depth_optimizer(lr=1e-5))

    def take_jax_state(tstate, jstate):
        tstate.net.load_state_dict(sd(jstate.params))
        adam = next(s for s in jax.tree_util.tree_leaves(
            jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
        for key in ("mu", "nu"):
            m = sd(getattr(adam, key))
            tstate.opt_state[key] = [m[n].clone() for n in tstate.names]
        tstate.opt_state["count"] = torch.tensor(int(adam.count), dtype=torch.int32)
        tstate.step = int(jstate.step)

    def jax_tree(tstate, values) -> dict:
        """Port tensors by parameter name -> a tree shaped as JAX's params."""
        full = {k: np.zeros(tuple(v.shape), np.float32)  # tensors no step trains
                for k, v in tstate.net.state_dict().items()}
        full.update({n: v.detach().numpy() for n, v in zip(tstate.names, values)})
        conv = convert_dpt(full)
        conv = conv if "params" in jstate.params else conv["params"]
        return jax.tree.map(lambda ref, new: jnp.asarray(new, ref.dtype), jstate.params, conv)

    def with_moments(opt_state, mu, nu, count):
        if hasattr(opt_state, "mu"):
            return opt_state._replace(mu=mu, nu=nu, count=jnp.asarray(count, opt_state.count.dtype))
        if isinstance(opt_state, tuple):
            items = [with_moments(x, mu, nu, count) for x in opt_state]
            return type(opt_state)(*items) if hasattr(opt_state, "_fields") else tuple(items)
        return opt_state

    def take_port_state(tstate):
        o = tstate.opt_state
        return jstate.replace(
            step=jnp.asarray(tstate.step, jnp.int32),
            params=jax_tree(tstate, [dict(tstate.net.named_parameters())[n]
                                     for n in tstate.names]),
            opt_state=with_moments(jstate.opt_state, jax_tree(tstate, o["mu"]),
                                   jax_tree(tstate, o["nu"]), int(o["count"])))

    def share_port(state, rgb):
        with torch.no_grad():
            return float((state.net(rgb) == 0).float().mean())

    jstate = jtrain.create_train_state(variables, jtrain.depth_optimizer(lr=1e-5))
    ports = {"port_forced": port_state(False), "port_free": port_state(False),
             "port_own_init": port_state(True)}
    rgb0 = torch.from_numpy(views["rgb"][:batch])
    out = {"size": size, "batch": batch, "init": init, "steps": [], "start": {
        "jax": float((np.asarray(jforward(variables, jnp.asarray(views["rgb"][:batch]))) == 0).mean()),
        **{k: share_port(v, rgb0) for k, v in ports.items() if k != "port_forced"}}}
    print(json.dumps(out["start"]), flush=True)
    swapped = {}
    for s in range(steps):
        rows = slice(batch * (s % n_batches), batch * (s % n_batches) + batch)
        jb = {k: jnp.asarray(v[rows]) for k, v in views.items()}
        tb = {k: torch.from_numpy(v[rows]) for k, v in views.items()}
        key = jax.random.PRNGKey(s)
        triplets = torch.from_numpy(np.array(j_sample_triplets(key, jvnl))).long()
        t0 = time.perf_counter()
        take_jax_state(ports["port_forced"], jstate)
        jstate, jm = jstep(jstate, jb, key)
        row = {"step": s + 1,
               "jax": float((np.asarray(jforward(jstate.params, jb["rgb"])) == 0).mean()),
               "jax_loss": float(jm["loss"])}
        if "jax_from_port" in swapped:
            swapped["jax_from_port"], m = jstep(swapped["jax_from_port"], jb, key)
            row["jax_from_port"] = float(
                (np.asarray(jforward(swapped["jax_from_port"].params, jb["rgb"])) == 0).mean())
            row["jax_from_port_loss"] = float(m["loss"])
        for name, state in ports.items():
            m = tstep(state, tb, triplets=triplets)
            row[name] = share_port(state, tb["rgb"])
            row[name + "_loss"] = float(m["loss"])
        if s + 1 == swap_after:
            ports["port_from_jax"] = port_state(False)
            take_jax_state(ports["port_from_jax"], jstate)
            swapped["jax_from_port"] = take_port_state(ports["port_free"])
        row["s"] = time.perf_counter() - t0
        out["steps"].append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--init", choices=("jax", "port"), default="jax",
                   help="whose initial weights both packages start from")
    p.add_argument("--views", type=int, default=8, help="views loaded, batches taken in turn")
    p.add_argument("--swap_after", type=int, default=1,
                   help="the step after which each package goes on from the other's state")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    res = run(args.data, args.size, args.batch, args.steps, args.views, args.init,
              args.swap_after)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
