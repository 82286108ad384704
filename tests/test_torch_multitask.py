"""The port's multi-task path (omnidata_tpu_torch.models.{attention_blocks,
multitask,hrnet} and ``train_multitask``) against the JAX package's on the
CPU, with JAX-initialised Flax weights carried across by
``convert.state_dict_from_flax_tree`` (HRNet: ``state_dict_from_flax`` on
``hrnet_mapping``), biases, norm parameters and BatchNorm statistics
perturbed from their init with seeded numpy noise, inputs made with numpy
from a seed.

Tolerances, float32: a forward within 1e-4 x max |JAX| + 1e-5; the losses
and per-task gradient norms within 1e-4 relative of ``jax.grad``'s; an
Adam update from the same gradients within 1e-6 lr of optax's;
``grad_norm_weights`` within 1e-6.
"""
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnidata_tpu import models as jm
from omnidata_tpu.losses import masked_cosine_angular_loss as j_cos
from omnidata_tpu.losses import masked_l1_loss as j_l1
from omnidata_tpu.models.hrnet import HRNet as JHRNet
from omnidata_tpu_torch import train_multitask as ttm
from omnidata_tpu_torch.models import attention_blocks as tab
from omnidata_tpu_torch.models import create_model
from omnidata_tpu_torch.models import multitask as tmt
from omnidata_tpu_torch.models.convert import state_dict_from_flax, state_dict_from_flax_tree
from omnidata_tpu_torch.models.hrnet import HRNet, hrnet_mapping
from omnidata_tpu_torch.train.state import Optimizer, create_train_state

from _torch_port_util import jax_mini_scene

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL = 1e-4
UPDATE_TOL = 1e-6  # x lr
TASKS = {"depth_zbuffer": 1, "normal": 3}
JARCHS = {"multitask": jm.MultiTaskModel, "mtan": jm.MTAN, "padnet": jm.PADNet,
          "crossstitch": jm.CrossStitch}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= FWD_RTOL * np.abs(want).max() + FWD_ATOL, (err, np.abs(want).max())


def _perturbed(variables, seed):
    """Flax variables as nested numpy dicts: 1-D params (biases, norm
    scales and shifts) plus N(0, 0.05) noise; BatchNorm means plus N(0,
    0.05) and variances times U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    host = jax.device_get(variables)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if name == "var":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim == 1:
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return walk(dict(host))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def _from_nhwc(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def _load(net, v):
    net.load_state_dict(state_dict_from_flax_tree(v), strict=True)
    return net.eval()


# ---- attention blocks ----------------------------------------------------

@pytest.mark.parametrize("name", ["eca", "channel", "cbam"])
@pytest.mark.parametrize("size", [(7, 9), (8, 8)])
def test_attention_block_matches_jax(name, size):
    C = 32
    x = np.random.RandomState(0).standard_normal((2, C) + size).astype(np.float32)
    jmod, tmod = {"eca": (jm.ECA(kernel_size=5), tab.ECA(5)),
                  "channel": (jm.ChannelAttention(reduction=4), tab.ChannelAttention(C, 4)),
                  "cbam": (jm.CBAM(reduction=4), tab.CBAM(C, 4))}[name]
    v = _perturbed(jmod.init(jax.random.PRNGKey(0), _nhwc(x)), 1)
    want = _from_nhwc(jmod.apply(_jtree(v), _nhwc(x)))
    with torch.no_grad():
        got = _load(tmod, v)(torch.from_numpy(x)).numpy()
    _close(got, want)


# ---- the multi-task architectures ----------------------------------------

@pytest.fixture(scope="module")
def carried():
    """arch -> (Flax module, perturbed Flax variables)."""
    out = {}
    for i, (arch, cls) in enumerate(JARCHS.items()):
        mod = cls(tasks=TASKS)
        v = jax.jit(mod.init)(jax.random.PRNGKey(i), jnp.zeros((1, 32, 32, 3)))
        out[arch] = (mod, _perturbed(v, 10 + i))
    return out


def _outs_nchw(y):
    return {k: (_outs_nchw(v) if isinstance(v, dict) else _from_nhwc(v)) for k, v in y.items()}


def _compare_outs(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _compare_outs(got[k], want[k])
        else:
            _close(got[k].numpy(), want[k])


@pytest.mark.parametrize("arch", list(JARCHS))
@pytest.mark.parametrize("hw", [(33, 31), (40, 36)])
def test_multitask_forward_matches_jax(carried, arch, hw):
    """Odd and even sizes: Flax SAME pads (2, 3) for the 7x7 stem and
    (0, 1) for the strided 3x3 on even sizes; the ASPP rates exceed the
    top feature map."""
    mod, v = carried[arch]
    x = np.random.RandomState(2).rand(2, 3, *hw).astype(np.float32)
    want = _outs_nchw(jax.jit(mod.apply)(_jtree(v), _nhwc(x)))
    with torch.no_grad():
        got = _load(tmt.ARCHS[arch](TASKS), v)(torch.from_numpy(x))
    _compare_outs(got, want)


@pytest.mark.parametrize("hw", [(33, 31), (40, 36)])
def test_hrnet_lite_matches_jax(hw):
    mod = jm.HRNetLite(out_channels=5)
    x = np.random.RandomState(3).rand(1, 3, *hw).astype(np.float32)
    v = _perturbed(jax.jit(mod.init)(jax.random.PRNGKey(0), _nhwc(x)), 3)
    want = _from_nhwc(jax.jit(mod.apply)(_jtree(v), _nhwc(x)))
    with torch.no_grad():
        got = _load(tmt.HRNetLite(5), v)(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_cross_stitch_initial_mix():
    net = tmt.CrossStitch(TASKS)
    want = np.eye(2) * 0.9 + 0.05
    for i in range(4):
        np.testing.assert_allclose(getattr(net, f"stitch{i}").detach().numpy(), want,
                                   rtol=1e-7)
    net = ttm.build_model("crossstitch")  # the seeded init keeps the mix
    np.testing.assert_allclose(net.stitch0.detach().numpy(), want, rtol=1e-7)


@pytest.mark.parametrize("initial", [None, {"depth_zbuffer": 0.3, "normal": 1.7}])
def test_grad_norm_weights_match_jax(initial):
    losses = {"depth_zbuffer": 0.21, "normal": 0.93}
    norms = {"depth_zbuffer": 3.5, "normal": 0.42}
    want = jm.grad_norm_weights(losses, norms, initial_losses=initial)
    got = tmt.grad_norm_weights(losses, norms, initial_losses=initial)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-6, (k, got[k], float(want[k]))
    assert abs(sum(got.values()) - 2.0) <= 1e-6


def test_grad_norm_weights_of_a_sign_change_are_nan_in_both():
    """A loss that changed sign since the first step (the normal loss's
    cosine term is -cos) gives a negative training rate: NaN weights in
    JAX and here alike; train_multitask then keeps its weights."""
    losses = {"depth_zbuffer": 0.3, "normal": -0.1}
    norms = {"depth_zbuffer": 1.0, "normal": 2.0}
    initial = {"depth_zbuffer": 1.4, "normal": 1.1}
    want = jm.grad_norm_weights(losses, norms, initial_losses=initial)
    got = tmt.grad_norm_weights(losses, norms, initial_losses=initial)
    assert all(np.isnan(float(want[k])) and np.isnan(got[k]) for k in want)


# ---- HRNet ---------------------------------------------------------------

def test_hrnet_w18_matches_jax():
    """The published seg_hrnet key schema: the port's seeded state dict
    (BatchNorm statistics perturbed) goes into the JAX HRNet through the
    JAX package's own convert_hrnet, which accounts for every key, and
    comes back through the port's hrnet_mapping unchanged."""
    from omnidata_tpu.models.hrnet import convert_hrnet

    from omnidata_tpu_torch.models.registry import init_weights

    net = HRNet(5, "w18")
    init_weights(net, torch.Generator().manual_seed(4))
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for name, b in net.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(0.05 * rng.standard_normal(b.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    v = convert_hrnet({k: t.numpy() for k, t in net.state_dict().items()}, "w18")
    back = state_dict_from_flax(hrnet_mapping("w18"), v)
    sd = net.state_dict()
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(back[k], sd[k]) for k in back)
    net.load_state_dict(back, strict=True)  # num_batches_tracked: torch fills it in
    x = np.random.RandomState(4).rand(1, 3, 65, 65).astype(np.float32)
    want = _from_nhwc(jax.jit(JHRNet(out_channels=5, variant="w18").apply)(
        _jtree(v), _nhwc(x)))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("variant", ["w32", "w48"])
def test_hrnet_wide_variants_shapes(variant):
    net = HRNet(3, variant)
    with torch.no_grad():
        y = net.eval()(torch.zeros(1, 3, 33, 41))
    assert y.shape == (1, 3, 33, 41)
    with pytest.raises(ValueError):
        net(torch.zeros(1, 3, 32, 33))


def test_registry_hrnet_w18():
    m = create_model("hrnet_w18", device="cpu")
    with torch.no_grad():
        y = m(torch.rand(2, 3, 33, 33, generator=torch.Generator().manual_seed(0)))
    assert y.shape == (2, 21, 33, 33) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    b = create_model("hrnet_w18", device="cpu", dtype="bfloat16")
    assert b.net.conv1.weight.dtype == torch.bfloat16
    assert b.net.bn1.weight.dtype == torch.float32
    with pytest.raises(KeyError, match="hrnet_w48.*midas_v21_small"):
        create_model("midas_v30", device="cpu")


# ---- the multi-task step -------------------------------------------------

def _jax_losses(mod, params, batch):
    """train_multitask.py's losses_fn."""
    x = jnp.transpose(batch["rgb"], (0, 2, 3, 1))
    out = mod.apply(params, x)
    mask = batch["mask_valid"] > 0.5
    pred_d = jnp.transpose(out["depth_zbuffer"], (0, 3, 1, 2))
    pred_n = jnp.clip(jnp.transpose(out["normal"], (0, 3, 1, 2)), 0.0, 1.0)
    ld = j_l1(pred_d, batch["depth_zbuffer"], mask)
    m3 = jnp.repeat(mask, 3, 1)
    ln = j_cos(pred_n, batch["normal"], m3) + j_l1(pred_n, batch["normal"], m3)
    return {"depth_zbuffer": ld, "normal": ln}


@pytest.fixture(scope="module")
def step_batch():
    """A batch of 2 at 32x30 from seeded numpy: rgb, depth in [0, 1],
    normals in [0, 1], a partial mask."""
    rng = np.random.RandomState(5)
    H, W = 32, 30
    mask = np.ones((2, 1, H, W), bool)
    mask[0, :, :8] = False
    mask[1, :, :, 20:] = False
    return {"rgb": rng.rand(2, 3, H, W).astype(np.float32),
            "depth_zbuffer": rng.rand(2, 1, H, W).astype(np.float32),
            "normal": rng.rand(2, 3, H, W).astype(np.float32),
            "mask_valid": mask}


@pytest.mark.parametrize("arch", list(JARCHS))
def test_multitask_step_matches_jax(carried, step_batch, arch):
    """One step from carried weights: the per-task losses and gradient
    norms against jax.grad; then optax's chain(clip_by_global_norm(10),
    adam(lr)) and the port's Optimizer on JAX's gradients of the weighted
    loss — PADNet's aux heads get zeros in JAX and None here."""
    mod, v = carried[arch]
    jb = {k: jnp.asarray(a) for k, a in step_batch.items()}
    assert list(TASKS) == ["depth_zbuffer", "normal"]
    tb = {k: torch.from_numpy(a) for k, a in step_batch.items()}
    params = _jtree(v)
    w = {"depth_zbuffer": 0.7, "normal": 1.3}

    @jax.jit
    def jstep(params):
        def losses(p):
            ls = _jax_losses(mod, p, jb)
            return jnp.stack([ls[t] for t in TASKS])

        jac = jax.jacrev(losses)(params)  # each leaf (T,) + its shape
        leaves = jax.tree_util.tree_leaves(jac)
        norms = {t: jnp.sqrt(sum(jnp.sum(a[i] * a[i]) for a in leaves))
                 for i, t in enumerate(TASKS)}
        total = jax.tree.map(lambda a: w["depth_zbuffer"] * a[0] + w["normal"] * a[1], jac)
        return dict(zip(TASKS, losses(params))), norms, total

    jls, jnorms, jgrads = jstep(params)
    net = _load(tmt.ARCHS[arch](TASKS), v)
    lr = 1e-3
    state = create_train_state(net, Optimizer(lr=lr, grad_clip=10.0))
    with torch.no_grad():
        tls = ttm.losses_fn(net, tb)
    tnorms = ttm.per_task_grad_norms(state, tb)
    for t in TASKS:
        np.testing.assert_allclose(float(tls[t]), float(jls[t]), rtol=GRAD_RTOL, err_msg=t)
        np.testing.assert_allclose(float(tnorms[t]), float(jnorms[t]), rtol=GRAD_RTOL,
                                   err_msg=t)

    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr))
    upd, _ = tx.update(jgrads, tx.init(params), params)
    want = state_dict_from_flax_tree(jax.device_get(optax.apply_updates(params, upd)))
    grads = state_dict_from_flax_tree(jax.device_get(jgrads))
    untouched = 0
    for name, p in net.named_parameters():
        if arch == "padnet" and "aux_" in name and "_out." in name:
            assert not grads[name].any()  # JAX's zeros
            p.grad, untouched = None, untouched + 1
        else:
            p.grad = grads[name].clone()
    before = {k: t.clone() for k, t in net.state_dict().items()}
    state.apply_gradients()
    got = net.state_dict()
    assert untouched == (4 if arch == "padnet" else 0)
    for k in want:
        err = float((got[k] - want[k]).abs().max())
        assert err <= UPDATE_TOL * lr + 2**-23 * float(want[k].abs().max()), (k, err)
        if arch == "padnet" and "aux_" in k and "_out." in k:
            assert torch.equal(got[k], before[k])
    assert int(state.opt_state["count"]) == 1


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jax_mini_scene(str(tmp_path_factory.mktemp("mt_scene")))


def test_train_multitask_end_to_end(scene):
    """--device cpu, 4 steps, GradNorm at steps 2 and 4: the JAX driver's
    lines, finite losses, weights summing to 2."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        state = ttm.main(["--data_path", scene, "--device", "cpu", "--arch", "padnet",
                          "--image_size", "32", "--batch_size", "2", "--max_steps", "4",
                          "--balance_every", "2"])
    lines = buf.getvalue().splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [int(re.match(r"step (\d+):", ln).group(1)) for ln in steps] == [2, 4]
    for ln in steps:
        weights = eval(ln.split("weights=", 1)[1].rsplit(" (", 1)[0])
        losses = eval(ln.split("losses=", 1)[1].split(" weights=")[0])
        assert set(weights) == set(losses) == set(TASKS)
        assert all(np.isfinite(v) for v in losses.values())
        assert abs(sum(weights.values()) - 2.0) <= 1e-5
    assert lines[-1] == "done: 4 steps"
    assert state.step == 4 and int(state.opt_state["count"]) == 4


def test_train_multitask_refuses_cuda_without_a_card(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttm.main(["--data_path", scene, "--max_steps", "1"])
