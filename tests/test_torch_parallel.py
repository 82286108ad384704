"""The port's sharded training (omnidata_tpu_torch.train.parallel) on the
CPU: gloo groups of 2 and 4 worker processes (tests/_torch_dist_worker.py,
started as torchrun starts them) against the one-process step on the
global batch, and against the JAX package's jitted step on its 8-device
mesh with ``param_sharding``.

Cases, at 64², global batch 8 (2 images a data rank at 4x1), grids 2x1,
1x2, 4x1 and 2x2: the tiny DPT (JAX's dryrun_multichip config,
Flax-initialised weights carried across) depth step from fresh moments at
step 0 and past the 15k switch, both with the in-step augmentation; the
UNet (downsample 2) normal step with augmentation; and the warm step: the
DPT's second step past the switch from the state JAX's mesh step leaves
(its params and Adam moments carried across), augmentation off, JAX's
triplets, the clip at WARM_CLIP, below the gradient's norm, so it acts.

Tolerances, float32. Against one process (same weights, same draws):

- the gradients the optimizer is given (the data group's sum) within
  GRAD_RTOL 1e-5 of the one-process gradients in L2, all of them as one
  vector, and each tensor within TENSOR_RTOL 1e-3 (an output bias's
  gradient sums 8·64² pixel terms that nearly cancel: 1.1e-4 measured);
  the clip's global norm within GRAD_RTOL of the unsharded norm, of all
  the tensors and of the model-split ones alone. Where VNL is in the loss
  and the ViT is split, within VNL_CUT_RTOL 1e-2: the place of VNL's 25%
  cut is not continuous in the prediction, and the model split's partial
  sums round the prediction otherwise, which can move a triplet across
  the cut. This batch's random mask moves none (all within 1e-5); with
  one 12x14 hole instead, the 1x2 and 2x2 grids' gradients moved 2.5e-4
  past the switch and 2.3e-5 on the warm step, every step without VNL
  staying within 1e-5, and that fresh step's moves went 1.2% from the
  one-process step's, past MOVE_RTOL (see below); on an H100 at 128² the
  2x2 step past the switch moves 1.0e-3 (chip_smoke.py phase 20c). A
  gradient averaged over the data group instead of summed is off by
  1 - 1/n_data; a split tensors' norm without the model group's sum by
  far more than either bound (checked on every model split: the split
  tensors hold a small share of the whole norm, so only their own norm
  shows it);
- the loss and each term within LOSS_RTOL 1e-5 relative;
- after the step every parameter within 2 lr plus the rounding of p + u,
  and the parameters' moves within MOVE_RTOL 1% in L2. From fresh moments
  an Adam step moves each parameter by about ±lr by its gradient's sign,
  so these two bounds see little more than sign flips there; the warm
  step's moves follow the gradient's size, the clip and the moments.

Against JAX, on the warm step: tests/test_torch_train_dpt.py's NET_TOL
1e-3 on each term, 2 lr on every parameter and MOVE_TOL 5% on the moves,
for the one-process step (its distance printed) and for every grid. A
fresh step's moves are not held to JAX's: with zero moments every gradient
near zero whose sign the two packages' float32 rounding sets differently
moves 2 lr apart, and the tiny DPT's weight-standardised backbone has many.
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
from omnidata_tpu_torch.models import DPTHybrid, UNet
from omnidata_tpu_torch.models.convert import _dpt_mapping
from omnidata_tpu_torch.models.registry import init_weights
from omnidata_tpu_torch.train import parallel

import _torch_dist_worker as W
from _torch_port_util import tiny_dpt_state_dict

torch.set_num_threads(1)

H, B = 64, 8
LOSS_RTOL, GRAD_RTOL, TENSOR_RTOL, MOVE_RTOL = 1e-5, 1e-5, 1e-3, 0.01
VNL_CUT_RTOL = 1e-2
NET_TOL, MOVE_TOL = 1e-3, 0.05
WARM_CLIP = 0.05
LATE = jtrain.SSI_ONLY_STEPS + 1
GRIDS = {2: [(2, 1), (1, 2)], 4: [(4, 1), (2, 2)]}
STEP_CASES = ("depth_early", "depth_late", "depth_warm", "normal")


@pytest.fixture(scope="module")
def flax_dpt():
    model = JDPT(num_channels=1, **W.TINY_DPT)
    return model, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 3)))


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.RandomState(0)
    mask = rng.rand(B, 1, H, H) > 0.1
    rgb = rng.rand(B, 3, H, H).astype(np.float32)
    depth = (rng.rand(B, 1, H, H) * 0.5 + 0.1).astype(np.float32)
    return {"rgb": rgb, "depth": depth, "mask_valid": mask, "rng": rng}


@pytest.fixture(scope="module")
def jax_mesh_steps(flax_dpt, arrays):
    """JAX's jitted depth step on make_mesh(4, 2) of the 8 CPU devices,
    params placed by param_sharding and the batch by batch_sharding, as
    its trainers and dryrun_multichip run it: two steps past the switch
    (keys 1, 2) with the clip at WARM_CLIP. -> the state after the first
    (as port state dicts), the second's metrics, params and triplets."""
    model, variables = flax_dpt
    mesh = jtrain.make_mesh(n_data=4, n_model=2)
    variables = jax.device_put(variables, jtrain.param_sharding(variables, mesh))
    state = jtrain.create_train_state(
        variables, jtrain.depth_optimizer(lr=1e-5, grad_clip=WARM_CLIP))
    state = state.replace(step=jnp.asarray(LATE, jnp.int32))
    batch = {"rgb": arrays["rgb"] * 2 - 1, "depth": arrays["depth"],
             "mask_valid": arrays["mask_valid"]}
    batch = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                           jtrain.batch_sharding(mesh))

    def apply_fn(v, x):
        return model.apply(v, jnp.transpose(x, (0, 2, 3, 1)))[..., 0]

    step = jax.jit(jtrain.make_depth_train_step(apply_fn, JVNLParams(1.0, 1.0, (H, H))))
    with mesh:
        first, _ = step(state, batch, jax.random.PRNGKey(1))
        second, metrics = step(first, batch, jax.random.PRNGKey(2))
    adam = jax.device_get(first.opt_state[1][0])
    return {"params1": tiny_dpt_state_dict(jax.device_get(first.params)),
            "mu1": tiny_dpt_state_dict(adam.mu), "nu1": tiny_dpt_state_dict(adam.nu),
            "count1": int(adam.count),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": tiny_dpt_state_dict(jax.device_get(second.params)),
            "triplets": torch.from_numpy(np.array(j_sample_triplets(
                jax.random.PRNGKey(2), JVNLParams(1.0, 1.0, (H, H))))).long()}


@pytest.fixture(scope="module")
def cases(flax_dpt, arrays, jax_mesh_steps):
    rgb, mask = arrays["rgb"], arrays["mask_valid"]
    dpt_sd = tiny_dpt_state_dict(jax.device_get(flax_dpt[1]))
    unet = UNet(out_channels=3, downsample=2)
    init_weights(unet, torch.Generator().manual_seed(0))
    with torch.no_grad():  # targets near the prediction: the cosine term far from 0
        pred = unet(torch.from_numpy(rgb)).clamp(0, 1).numpy()
    normal = np.clip(pred + 0.1 * arrays["rng"].standard_normal(pred.shape), 0, 1)
    depth_batch = {"rgb": rgb, "depth": arrays["depth"], "mask_valid": mask}
    dpt = dict(kind="depth", state_dict=dpt_sd, lr=1e-5, augment=True)
    j = jax_mesh_steps
    return {
        "depth_early": dict(dpt, batch=depth_batch, step=0),
        "depth_late": dict(dpt, batch=depth_batch, step=LATE),
        "depth_warm": dict(dpt, state_dict=j["params1"], batch=dict(depth_batch, rgb=rgb * 2 - 1),
                           step=LATE + 1, augment=False, triplets=j["triplets"],
                           grad_clip=WARM_CLIP,
                           opt_state={"count": j["count1"], "mu": j["mu1"], "nu": j["nu1"]}),
        "normal": dict(kind="normal", state_dict=unet.state_dict(), lr=1e-4, augment=True,
                       step=0, batch={"rgb": rgb, "normal": normal.astype(np.float32),
                                      "mask_valid": mask}),
    }


@pytest.fixture(scope="module")
def one_process(cases):
    return {name: W.run_case(case) for name, case in cases.items()}


@pytest.fixture(scope="module")
def sharded(cases, one_process, tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    want = d / "want_grads.pt"
    torch.save({name: res["grads"] for name, res in one_process.items()}, want)
    out = {}
    for world, grids in GRIDS.items():
        out.update(W.launch("steps", world, {"grids": grids, "cases": cases,
                                             "want_grads": str(want)},
                            d / f"world{world}.pt"))
    return out


def _moves(got, want, start, names):
    d_got = torch.cat([(got[k] - start[k]).flatten() for k in names])
    d_want = torch.cat([(want[k] - start[k]).flatten() for k in names])
    assert float(d_want.norm()) > 0
    return float((d_got - d_want).norm() / d_want.norm())


def _assert_step_close(got, want, start, lr, loss_rtol, move_tol):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=loss_rtol, err_msg=k)
    names = list(got["params"])
    for k in names:  # 2 lr, plus the rounding of p + u
        w = want["params"][k]
        assert bool(((got["params"][k] - w).abs() <= 2 * lr + 2**-22 * w.abs()).all()), k
    move = _moves(got["params"], want["params"], start, names)
    assert move <= move_tol, move
    return move


GRID_IDS = [f"{d}x{m}" for grids in GRIDS.values() for d, m in grids]


@pytest.mark.parametrize("grid", GRID_IDS)
@pytest.mark.parametrize("name", STEP_CASES)
def test_sharded_step_equals_one_process(sharded, one_process, cases, grid, name):
    d, m = map(int, grid.split("x"))
    got, want = sharded[(d, m, name)], one_process[name]
    vnl_cut = m > 1 and cases[name]["kind"] == "depth" and cases[name]["step"] >= jtrain.SSI_ONLY_STEPS
    rtol = VNL_CUT_RTOL if vnl_cut else GRAD_RTOL
    rel = dict(got["grad_rel"])
    assert rel.pop("all") <= rtol
    worst = max(rel.items(), key=lambda kv: kv[1])
    assert worst[1] <= max(rtol, TENSOR_RTOL), worst
    for k in ("norm", "norm_split"):
        if k in want:  # the UNet has no model-split tensor
            assert abs(got[k] - want[k]) <= rtol * want[k], (k, got[k], want[k])
    if m > 1 and "norm_split" in want:  # one rank's shards alone are far off
        assert abs(got["norm_split_unreduced"] - want["norm_split"]) > 0.1 * want["norm_split"]
    _assert_step_close(got, want, want["start"], cases[name]["lr"], LOSS_RTOL, MOVE_RTOL)


def test_one_process_step_equals_jax_mesh_step(jax_mesh_steps, one_process, cases):
    """The port's one-process warm step against JAX's mesh step from the
    same state: the distance every grid is held to below, printed."""
    one, j = one_process["depth_warm"], jax_mesh_steps
    assert one["norm"] > WARM_CLIP  # the clip acts
    assert set(j["metrics"]) == set(one["metrics"])
    move = _assert_step_close(one, j, one["start"], cases["depth_warm"]["lr"], NET_TOL,
                              MOVE_TOL)
    print(f"one-process warm step against JAX's mesh step: moves {move:.3e} of L2")


@pytest.mark.parametrize("grid", GRID_IDS)
def test_sharded_step_equals_jax_mesh_step(sharded, jax_mesh_steps, one_process, cases, grid):
    d, m = map(int, grid.split("x"))
    got = sharded[(d, m, "depth_warm")]
    assert set(jax_mesh_steps["metrics"]) == set(got["metrics"])
    _assert_step_close(got, jax_mesh_steps, one_process["depth_warm"]["start"],
                       cases["depth_warm"]["lr"], NET_TOL, MOVE_TOL)


def test_tp_rules_pick_jax_tensors_on_jax_axes(flax_dpt):
    """tests/test_train.py:281 on the tiny DPT: the port's rules shard the
    tensors JAX's param_sharding shards on make_mesh(4, 2), on the axis a
    Flax (in, out) kernel maps to in a torch (out, in) weight."""
    from torch.distributed.tensor import Replicate, Shard

    _, variables = flax_dpt
    jsh = jtrain.param_sharding(variables, jtrain.make_mesh(n_data=4, n_model=2))
    net = DPTHybrid(num_channels=1, **W.TINY_DPT)
    tsh = parallel.param_sharding(net, parallel.Mesh(n_data=4, n_model=2))
    flax_axis = {"kernel": {0: 1, 1: 0}, "bias": {0: 0}}  # Flax axis -> torch dim
    n_split = 0
    for fpath, key, kind in _dpt_mapping(2):
        if fpath is None or kind not in ("linear", "conv", "conv_nobias", "ln", "norm", "raw"):
            continue
        node = jsh["params"]
        for part in fpath.split("/"):
            node = node[part]
        leaves = {"raw": {None: node}}.get(kind) or {
            leaf: node[name] for leaf, name in (("weight", "kernel"), ("bias", "bias"),
                                                ("weight", "scale")) if name in node}
        for leaf, sh in leaves.items():
            tkey = key if leaf is None else f"{key}.{leaf}"
            spec = tuple(sh.spec)
            want = (Replicate(), Replicate())
            if "model" in spec:
                kind_key = "kernel" if leaf == "weight" else "bias"
                want = (Replicate(), Shard(flax_axis[kind_key][spec.index("model")]))
                n_split += 1
            assert tsh[tkey] == want, (tkey, spec, tsh[tkey])
    assert n_split == 6 * 2  # qkv w+b, proj w, fc1 w+b, fc2 w: 6 a block
    assert all(p == (Replicate(), Replicate()) for p in parallel.param_sharding(
        net, parallel.Mesh(n_data=8, n_model=1)).values())
    assert parallel.batch_sharding(None) == (Shard(0), Replicate())
    assert parallel.replicated(None) == (Replicate(), Replicate())


def test_qkv_shards_hold_their_heads_and_round_trip():
    """Each model rank's qkv shard is [q_r; k_r; v_r] of its heads (a local
    reshape(B, N, 3, heads / n, hd) is right); the shards put back by
    position give the unsharded tensor bit for bit, for every split rule."""
    dim, heads, n = 128, 4, 2
    hd = dim // heads
    full = torch.arange(3 * dim * 5, dtype=torch.float32).reshape(3 * dim, 5)
    for r in range(n):
        shard = parallel.shard_tensor("blocks.0.attn.qkv.weight", full, n, r)
        per = shard.reshape(3, heads // n, hd, 5)
        for p in range(3):  # q, k, v
            rows = full[p * dim + r * (heads // n) * hd:p * dim + (r + 1) * (heads // n) * hd]
            assert torch.equal(per[p].reshape(-1, 5), rows)
    for name, shape in (("a.attn.qkv.weight", (3 * dim, dim)), ("a.attn.qkv.bias", (3 * dim,)),
                        ("a.attn.proj.weight", (dim, dim)), ("a.mlp.fc1.weight", (4 * dim, dim)),
                        ("a.mlp.fc1.bias", (4 * dim,)), ("a.mlp.fc2.weight", (dim, 4 * dim))):
        full = torch.randn(shape)
        dim_split = parallel.split_dim(name)
        back = torch.zeros_like(full)
        for r in range(n):
            idx = parallel._shard_index(name, shape[dim_split], n, r)
            back.index_copy_(dim_split, idx, parallel.shard_tensor(name, full, n, r))
        assert torch.equal(back, full), name
    for name in ("a.attn.proj.bias", "a.mlp.fc2.bias", "a.norm1.weight"):
        assert parallel.split_dim(name) is None


def test_make_mesh_and_shard_refusals():
    """One process is world 1: any other grid names all three numbers; a
    head count that the model axis does not divide is refused."""
    assert parallel.make_mesh().shape == {"data": 1, "model": 1}
    for n_data, n_model in ((2, 1), (1, 2), (None, 2), (2, 2)):
        with pytest.raises(ValueError, match="world size 1"):
            parallel.make_mesh(n_data, n_model)
    net = DPTHybrid(num_channels=1, **dict(W.TINY_DPT, vit_heads=2, vit_dim=64))
    with pytest.raises(ValueError, match="heads"):
        parallel.shard_module(net, parallel.Mesh(n_data=1, n_model=4, rank=0))


def test_loss_shares_sum_to_the_one_process_loss(tmp_path):
    """Each batch-global reduction split over 2 data ranks: the shares sum
    to the one-process value and their gradients are its gradient (within
    1e-6). The VNL batch puts the 25% cut across the rank boundary: image 0
    (rank 0) fits its depth far better than image 1, so the global cut
    drops more than a quarter of rank 0's valid triplets and fewer of
    rank 1's, and no per-rank cut gives its keep-set."""
    from omnidata_tpu_torch.losses import VNLParams, vnl_from_indices
    from omnidata_tpu_torch.losses import virtual_normal as vn

    Hs = 32
    rng = np.random.RandomState(3)
    gt = torch.from_numpy((rng.rand(2, 1, Hs, Hs) * 0.5 + 0.1).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 1, Hs, Hs)).astype(np.float32))
    pred = gt * (1 + noise * torch.tensor([0.01, 0.3]).reshape(2, 1, 1, 1))
    mask = torch.from_numpy(rng.rand(2, 1, Hs, Hs) > 0.2)
    params = VNLParams(1.0, 1.0, (Hs, Hs))
    triplets = vn.sample_triplets(torch.Generator().manual_seed(0), params)
    inputs = {"pred": pred, "gt": gt, "mask": mask, "triplets": triplets}

    # where the global cut falls: per image, valid triplets and kept ones
    g_gt = vn._form_groups(vn.transfer_xyz(pred, params), triplets)
    g_pr = vn._form_groups(vn.transfer_xyz(gt, params), triplets)
    valid = vn._valid_mask(g_gt, params)
    lpg = torch.abs(vn._unit_normals(g_gt) - vn._unit_normals(g_pr)).sum(-1)
    cut = torch.sort(lpg[valid], stable=True)[0][int(int(valid.sum()) * 0.25)]
    kept = [int((lpg[b][valid[b]] >= cut).sum()) for b in range(2)]
    per_rank = [int(valid[b].sum()) - int(int(valid[b].sum()) * 0.25) for b in range(2)]
    assert kept[0] < per_rank[0] and kept[1] > per_rank[1], (kept, per_rank)

    want = W.loss_shares(inputs)
    got = W.launch("shares", 2, {"inputs": inputs}, tmp_path / "shares.pt")
    assert set(got) == set(want)
    for name, (value, grad) in want.items():
        np.testing.assert_allclose(got[name][0], float(value), rtol=1e-6, err_msg=name)
        err = float((got[name][1] - grad).norm() / grad.norm())
        assert err <= 1e-6, (name, err)
    assert float(want["vnl"][0]) == float(vnl_from_indices(pred, gt, triplets, params))
