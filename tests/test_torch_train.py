"""The port's training (omnidata_tpu_torch.train and the trainers) against
the JAX package's on the CPU: both optimizer chains against optax over 5
steps, with clipping triggered and not; the depth step on both sides of
the 15k schedule switch with JAX's triplets; 3 UNet normal steps with Flax
weights carried across; the trainers' driver (validation, top-k
checkpoints, bit-for-bit resume) on the mini scene the JAX CLI annotates;
checkpoints, callbacks, the experiment logger and the dataset plumbing.
DPT's step is in tests/test_torch_train_dpt.py.

Tolerances, float32. Optimizer moments within rtol 1e-5; parameters move
by about lr a step, so their bound scales with lr: within 1e-4 lr of
optax's after 5 steps on equal gradients. Losses within rtol 1e-5 (VNL
1e-4). After UNet steps on gradients that differ in the last bits, Adam's
first step maps each gradient to about ±lr by its sign, so an element
whose gradient is near zero can move the other way, and an element's
update error is its gradient error relative to its own gradient. The
UNet's gradients agree to tests/test_torch_models.py's whole-net bound
(1e-3 of the largest entry), so: losses after the first update within
1e-3 of the loss, no element more than 2 lr a step apart, and the
parameters' moves over 3 steps within 5% of JAX's in L2.
"""
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from omnidata_tpu import train as jtrain
from omnidata_tpu.losses import VNLParams as JVNLParams
from omnidata_tpu.losses import sample_triplets as j_sample_triplets
from omnidata_tpu.models import UNet as JUNet
from omnidata_tpu_torch import train_normal as t_train_normal
from omnidata_tpu_torch import train_depth as t_train_depth
from omnidata_tpu_torch import train as ttrain
from omnidata_tpu_torch.cues.encode import load_png
from omnidata_tpu_torch.losses import VNLParams
from omnidata_tpu_torch.models import UNet
from omnidata_tpu_torch.models.convert import _unet_mapping, state_dict_from_flax
from omnidata_tpu_torch.train.checkpoints import CheckpointManager
from omnidata_tpu_torch.utils.experiment import ExperimentLogger

from _torch_port_util import jax_mini_scene

torch.set_num_threads(1)

MOMENT_RTOL = 1e-5
LOSS_RTOL, VNL_RTOL = 1e-5, 1e-4
NET_TOL = 1e-3  # tests/test_torch_models.py's whole-net bound
MOVE_TOL = 0.05  # relative L2 difference of the parameters' moves over 3 steps


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jax_mini_scene(str(tmp_path_factory.mktemp("scene")))


# ---------------- optimizers ----------------

@pytest.mark.parametrize("chain", ["depth", "normal"])
@pytest.mark.parametrize("grad_scale", [1e-2, 30.0], ids=["unclipped", "clipped"])
def test_optimizer_chain_equals_optax_over_5_steps(chain, grad_scale):
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), ()]
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    lr = 1e-3
    if chain == "depth":
        jtx, ttx = jtrain.depth_optimizer(lr=lr), ttrain.depth_optimizer(lr=lr)
    else:
        jtx, ttx = (jtrain.normal_optimizer(lr=lr, weight_decay=0.05),
                    ttrain.normal_optimizer(lr=lr, weight_decay=0.05))
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tp)
    update = jax.jit(lambda g, s, p: jtx.update(g, s, p))
    norms = []
    for step in range(5):
        grads = [np.asarray(rng.standard_normal(s) * grad_scale * (1 + step), np.float32)
                 for s in shapes]
        norms.append(float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))))
        upd, jstate = update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.step(tp, [torch.from_numpy(g) for g in grads], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2**-22, atol=1e-4 * lr)
    assert (min(norms) > 10.0) == (grad_scale > 1)  # the clip did / did not trigger
    adam = jstate[-1][0]
    assert int(tstate["count"]) == int(adam.count) == 5
    for key in ("mu", "nu") + (("nu_max",) if chain == "normal" else ()):
        for a, b in zip(tstate[key], getattr(adam, key)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=MOMENT_RTOL,
                                       atol=1e-12)


def test_amsgrad_keeps_the_maximum_of_the_corrected_moment():
    """optax's AMSGrad differs from torch.optim.Adam(amsgrad=True) from the
    second step on; the port follows optax."""
    p = torch.zeros(1)
    tx = ttrain.Optimizer(lr=1.0, grad_clip=1e9, amsgrad=True)
    state = tx.init([p])
    for g in (1.0, 0.1):
        tx.step([p], [torch.tensor([g])], state)
    nu2 = 0.999 * 0.001 * 1.0 + 0.001 * 0.01
    nu_hat2 = nu2 / (1 - 0.999**2)
    # float32 bias corrections put nu_hat1 = 1.0000129, not 1: rtol 1e-4
    np.testing.assert_allclose(float(state["nu_max"][0]), max(1.0, nu_hat2), rtol=1e-4)
    q = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([q], lr=1.0, amsgrad=True)
    for g in (1.0, 0.1):
        q.grad = torch.tensor([g])
        opt.step()
    assert abs(float(q) - float(p)) > 1e-3


# ---------------- steps ----------------

class Toy(torch.nn.Module):
    """tests/test_train.py:197's linear "model": mean(x, 1) * w."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        return x.mean(1) * self.w


def _toy_batch(B=2, H=32):
    rng = np.random.RandomState(0)
    return {"rgb": rng.rand(B, 3, H, H).astype(np.float32),
            "depth": (rng.rand(B, 1, H, H) * 0.5 + 0.1).astype(np.float32),
            "mask_valid": np.ones((B, 1, H, H), bool)}


@pytest.mark.parametrize("late", [False, True], ids=["ssi_only", "full_loss"])
def test_depth_step_schedule_equals_jax(late):
    """tests/test_train.py:185 on both sides of the switch, JAX's triplets
    given to the port."""
    H = 32
    batch = _toy_batch(H=H)
    key = jax.random.PRNGKey(0)
    jparams = JVNLParams(1.0, 1.0, (H, H))
    step_no = jtrain.SSI_ONLY_STEPS + 1 if late else 0
    jstate = jtrain.create_train_state({"w": jnp.asarray(1.0)}, jtrain.depth_optimizer(lr=1e-3))
    jstate = jstate.replace(step=jnp.asarray(step_no, jnp.int32))
    jstep = jax.jit(jtrain.make_depth_train_step(lambda p, x: jnp.mean(x, 1) * p["w"], jparams))
    js, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    tstate = ttrain.create_train_state(Toy(), ttrain.depth_optimizer(lr=1e-3))
    tstate.step = step_no
    tstep = ttrain.make_depth_train_step(lambda net, x: net(x), VNLParams(1.0, 1.0, (H, H)))
    triplets = torch.from_numpy(np.asarray(j_sample_triplets(key, jparams))).long()
    tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, triplets=triplets)
    for k in ("loss", "ssi", "reg", "vnl"):
        rtol = VNL_RTOL if k in ("loss", "vnl") and late else LOSS_RTOL
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, err_msg=k)
    if not late:
        assert float(tm["loss"]) == float(tm["ssi"])
    else:
        expect = float(tm["ssi"]) + 0.1 * float(tm["reg"]) + 10.0 * float(tm["vnl"])
        np.testing.assert_allclose(float(tm["loss"]), expect, rtol=1e-6)
    assert tstate.step == step_no + 1
    np.testing.assert_allclose(float(tstate.net.w.detach()), float(js.params["w"]),
                               rtol=2**-22, atol=1e-4 * 1e-3)


def test_depth_step_augment_path_runs():
    """tests/test_train.py:419 on the port: rgb arrives in [0,1] and is
    resized, augmented and normalized in the step."""
    H = 32
    state = ttrain.create_train_state(Toy(), ttrain.depth_optimizer(lr=1e-3))
    step = ttrain.make_depth_train_step(lambda net, x: net(x), VNLParams(1.0, 1.0, (H, H)),
                                        augment=True, image_size=H)
    m = step(state, {k: torch.from_numpy(v) for k, v in _toy_batch(H=H).items()},
             torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and state.step == 1


def _normal_batch(scene):
    from omnidata_tpu_torch.data.dataset import OmnidataDataset, Options

    ds = OmnidataDataset(Options(data_path=scene, tasks=("rgb", "normal", "mask_valid"),
                                 random_flip=False))
    b = next(ds.batches(2, shuffle=False))
    return {"rgb": b["rgb"], "normal": b["normal"], "mask_valid": b["mask_valid"] > 0.5}


def test_unet_normal_steps_equal_jax(scene):
    """3 normal steps of the UNet (downsample 2, 64²), Flax weights carried
    by convert.state_dict_from_flax; the batch from the JAX CLI's scene."""
    batch = _normal_batch(scene)
    jmodel = JUNet(out_channels=3, downsample=2)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))

    def japply(v, x):
        return jnp.transpose(jmodel.apply(v, jnp.transpose(x, (0, 2, 3, 1))), (0, 3, 1, 2))

    lr = 1e-3
    jstate = jtrain.create_train_state(variables, jtrain.normal_optimizer(lr=lr))
    jstep = jax.jit(jtrain.make_normal_train_step(japply))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    net = UNet(out_channels=3, downsample=2)
    net.load_state_dict(state_dict_from_flax(_unet_mapping(2), jax.device_get(variables)))
    tstate = ttrain.create_train_state(net, ttrain.normal_optimizer(lr=lr))
    tstep = ttrain.make_normal_train_step(lambda n, x: n(x))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        tm = tstep(tstate, tb)
        for k in ("loss", "cos", "l1"):
            if i == 0:  # equal weights
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
            else:  # after updates from gradients that agree to NET_TOL
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                           atol=NET_TOL * float(jm["loss"]), err_msg=k)
    start = state_dict_from_flax(_unet_mapping(2), jax.device_get(variables))
    want = state_dict_from_flax(_unet_mapping(2), jax.device_get(jstate.params))
    got = net.state_dict()
    assert all(bool(((got[k] - want[k]).abs() <= 2 * lr * 3 + 2**-22 * want[k].abs()).all())
               for k in want)  # 2 lr a step, plus the rounding of p + u
    d_got = torch.cat([(got[k] - start[k]).flatten() for k in want])
    d_want = torch.cat([(want[k] - start[k]).flatten() for k in want])
    assert float((d_got - d_want).norm() / d_want.norm()) <= MOVE_TOL
    assert int(tstate.opt_state["count"]) == 3 and tstate.step == 3


def test_unet_remat_gives_the_same_step():
    """remat recomputes the blocks on the backward pass: same loss and
    parameters, bit for bit on the CPU."""
    rng = np.random.RandomState(1)
    batch = {"rgb": torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32)),
             "normal": torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32)),
             "mask_valid": torch.from_numpy(rng.rand(2, 1, 32, 32) > 0.2)}
    out = []
    for remat in (False, True):
        net = UNet(out_channels=3, downsample=2, remat=remat)
        torch.manual_seed(0)
        for p in net.parameters():
            torch.nn.init.normal_(p, std=0.1)
        state = ttrain.create_train_state(net, ttrain.normal_optimizer(lr=1e-3))
        m = ttrain.make_normal_train_step(lambda n, x: n(x))(state, batch)
        out.append((float(m["loss"]), [p.detach().clone() for p in net.parameters()]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------- checkpoints, callbacks, logger ----------------

def test_checkpoint_manager_topk(tmp_path):
    """tests/test_train.py:229 on the port."""
    cm = CheckpointManager(str(tmp_path / "ck"), save_top_k=2)
    w = torch.ones(4)
    cm.save({"w": w}, 1, metric=5.0)
    cm.save({"w": w * 2}, 2, metric=3.0)
    cm.save({"w": w * 3}, 3, metric=4.0)
    cm.save({"w": w * 4}, 4, metric=10.0)  # worse than the top 2: evicted
    assert cm.best() == "step_2"
    assert torch.equal(cm.restore("step_2")["w"], w * 2)
    assert torch.equal(cm.restore("last")["w"], w * 4)
    assert not os.path.exists(str(tmp_path / "ck" / "step_4"))
    assert json.load(open(tmp_path / "ck" / "scores.json")) == {"step_2": 3.0, "step_3": 4.0}
    again = CheckpointManager(str(tmp_path / "ck"), save_top_k=2)  # scores reload
    assert again.best() == "step_2"


def test_checkpoint_last_rotation(tmp_path):
    """tests/test_train.py:246's rotation on the port: 'last' is a symlink
    flipped to a complete directory, the previous one removed."""
    d = str(tmp_path / "ck")
    cm = CheckpointManager(d, save_top_k=1)
    cm.save({"w": torch.ones(4)}, 1)
    cm.save({"w": torch.ones(4) * 2}, 2)
    assert os.path.islink(os.path.join(d, "last"))
    assert os.readlink(os.path.join(d, "last")) == "last.1"
    assert not os.path.exists(os.path.join(d, "last.0"))
    assert torch.equal(cm.restore()["w"], torch.ones(4) * 2)
    cm2 = CheckpointManager(d)  # a restarted run continues the serials
    cm2.save({"w": torch.ones(4) * 3}, 3)
    assert os.readlink(os.path.join(d, "last")) == "last.2"
    assert sorted(n for n in os.listdir(d) if n.startswith("last")) == ["last", "last.2"]


def test_crash_dump_and_validation_images_equal_jax(tmp_path):
    """tests/test_train.py:299 on the port; its validation PNGs hold the
    pixels of the JAX package's (written with PIL)."""
    d = ttrain.save_crash_dump(str(tmp_path / "crash"), {"w": torch.ones(3)},
                               {"rgb": torch.zeros(1, 3, 4, 4)}, ValueError("boom"))
    assert torch.equal(torch.load(os.path.join(d, "crash_model.pth"))["w"], torch.ones(3))
    assert os.path.exists(os.path.join(d, "crash_batch.pth"))
    assert open(os.path.join(d, "crash_error.txt")).read() == "ValueError('boom')"
    rgb = np.random.RandomState(0).rand(2, 3, 8, 8)
    pred = np.random.RandomState(1).rand(2, 1, 8, 8)
    ttrain.save_validation_images(str(tmp_path / "val"), 100, rgb, pred, pred)
    jtrain.save_validation_images(str(tmp_path / "jval"), 100, rgb, pred, pred)
    for i in (0, 1):
        name = f"step100_sample{i}.png"
        np.testing.assert_array_equal(load_png(str(tmp_path / "val" / name)),
                                      load_png(str(tmp_path / "jval" / name)))


def test_experiment_logger_jsonl(tmp_path):
    """tests/test_train.py:956 on the port."""
    with ExperimentLogger(str(tmp_path / "run"), config={"lr": 1e-4}) as lg:
        lg.log(1, {"loss": 0.5})
        lg.log(2, {"loss": torch.tensor(0.25), "cos": 0.9})
    run = tmp_path / "run"
    assert json.loads((run / "config.json").read_text())["lr"] == 1e-4
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2] and recs[1]["cos"] == 0.9
    with ExperimentLogger(str(run)) as lg:  # append on reopen (resume)
        lg.log(3, {"loss": 0.1})
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]


# ---------------- driver ----------------

def test_build_datasets_equal_jax(scene):
    """tests/test_train.py:649 toggles, and the holdout split, as JAX's."""
    from omnidata_tpu.train.driver import build_datasets as j_build
    from omnidata_tpu_torch.train.driver import build_datasets as t_build

    tasks = ("rgb", "mask_valid")
    for cfg in ({"data_paths": {"scene": scene}, "val_fraction": 0.4},
                {"data_paths": {"scene": scene}, "train_datasets": {"scene": True},
                 "val_datasets": {"scene": False}},
                {"data_paths": {"scene": scene}, "train_datasets": {"scene": False},
                 "val_datasets": {"scene": False}},
                {"data_paths": {"scene": scene}, "train_datasets": {"scene": False}},
                {"data_paths": {"taskonomy": scene}, "taskonomy_variant": "debug"}):
        tt, tv = t_build(cfg, tasks, 64)
        jt, jv = j_build(cfg, tasks, 64)
        assert [d.index for d in tt] == [d.index for d in jt]
        assert [d.index for d in tv] == [d.index for d in jv]
        assert all(not d.o.random_flip for d in tv)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _normal_cfg(tmp_path, scene, **kw):
    cfg = {"model": "unet", "unet_downsample": 2, "image_size": 64, "batch_size": 2,
           "lr": 1.0e-3, "max_steps": 4, "log_step": 2, "val_step": 2, "ckpt_step": 100,
           "save_top_k": 2, "val_fraction": 0.4, "num_workers": 2,
           "checkpoint_dir": str(tmp_path / "ck"), "data_paths": {"scene": scene}, **kw}
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def test_train_normal_driver_validates_checkpoints_and_resumes_bitwise(scene, tmp_path):
    """tests/test_train.py:375 and :694 on the port, --device cpu: val loss
    logged, val images dumped, top-k checkpoints keyed on the validation
    loss; --resume restores params, optimizer state and step bit for bit."""
    path = _normal_cfg(tmp_path, scene)
    out = _run(t_train_normal.main, ["--config_file", path, "--device", "cpu"])
    ck = tmp_path / "ck"
    assert "val_normal_loss" in out and "step 4:" in out
    scores = json.load(open(ck / "scores.json"))
    assert sorted(scores) == ["step_2", "step_4"]
    assert any(f.endswith(".png") for f in os.listdir(ck / "val_images"))
    saved = torch.load(ck / "last" / "state.pt", weights_only=True)
    assert int(saved["step"]) == 4 and int(saved["opt_state"]["count"]) == 4
    out = _run(t_train_normal.main, ["--config_file", path, "--device", "cpu", "--resume"])
    assert "resumed from" in out and "at step 4" in out
    again = torch.load(ck / "last" / "state.pt", weights_only=True)
    for k, v in saved["params"].items():
        assert torch.equal(again["params"][k], v), k
    for k in ("mu", "nu", "nu_max"):
        assert all(torch.equal(a, b) for a, b in zip(again["opt_state"][k], saved["opt_state"][k]))
    # warm start from the port's own checkpoint directory
    net = UNet(out_channels=3, downsample=2)
    from omnidata_tpu_torch.train.driver import load_pretrained

    load_pretrained(net, str(ck / "step_2"))
    step2 = torch.load(ck / "step_2" / "state.pt", weights_only=True)["params"]
    assert all(torch.equal(net.state_dict()[k], v) for k, v in step2.items())


def test_load_pretrained_from_a_published_layout_checkpoint(tmp_path):
    from omnidata_tpu_torch.train.driver import load_pretrained

    src = UNet(out_channels=3, downsample=2)
    torch.save({"state_dict": {"model." + k: v for k, v in src.state_dict().items()}},
               tmp_path / "unet.ckpt")
    net = UNet(out_channels=3, downsample=2)
    load_pretrained(net, str(tmp_path / "unet.ckpt"))
    assert all(torch.equal(net.state_dict()[k], v) for k, v in src.state_dict().items())


@pytest.mark.parametrize("extra,error", [
    ({"data_parallel": 2}, ValueError), ({"model_parallel": 2}, ValueError),
    ({"data_parallel": 2, "model_parallel": 2, "packed_cache": "/tmp/pack"}, ValueError),
    ({}, RuntimeError)])
def test_trainers_refuse_what_is_not_ported(scene, tmp_path, monkeypatch, extra, error):
    """A grid of data_parallel x model_parallel ranks needs a process group
    of that size: in one process it raises the grid's ValueError (the
    packed cache beside it is no reason to refuse); --device cuda without a
    card (the default device) raises RuntimeError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _normal_cfg(tmp_path, scene, **extra)
    for main in (t_train_normal.main, t_train_depth.main):
        with pytest.raises(error, match="world size 1" if error is ValueError else None):
            main(["--config_file", path])
