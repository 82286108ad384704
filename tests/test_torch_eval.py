"""The port's evaluation path against the JAX package's on the CPU: the
metrics (``train.metrics``), normal TTA (``models.tta``), PIL's float
resizes (``utils.pil_image``), the OASIS and NYU readers and protocol
(``data.external_eval``) and the two drivers (``eval_depth``,
``eval_normal``) against the root scripts on the same weights and the
same annotated scene; and the registry's reading of a checkpoint
directory that the port's trainers wrote.

Tolerances: metric means within 1e-5 relative, the masked median within
1e-4 degrees; TTA within 1e-5; PIL's float resizes and the datasets'
samples bit for bit; ``evaluate_normals`` within 1e-4; the drivers'
JSON within 1e-4 relative (DPT's within 1e-3: its float32 rounding
compounds over 50 layers, tests/test_torch_models.py's whole-net bound).
"""
import contextlib
import io
import json
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.data import external_eval as jext
from omnidata_tpu.models.tta import SurfaceNormalsTTA as JTTA
from omnidata_tpu.train.metrics import depth_metrics as j_depth_metrics
from omnidata_tpu.train.metrics import normal_metrics as j_normal_metrics
from omnidata_tpu_torch import demo as tdemo
from omnidata_tpu_torch import eval_depth as t_eval_depth
from omnidata_tpu_torch import eval_normal as t_eval_normal
from omnidata_tpu_torch.cues.encode import load_png, save_png
from omnidata_tpu_torch.data import external_eval as text
from omnidata_tpu_torch.models import DPTHybrid, UNet, create_model
from omnidata_tpu_torch.models.convert import _dpt_mapping, state_dict_from_flax
from omnidata_tpu_torch.models.registry import init_weights
from omnidata_tpu_torch.models.tta import SurfaceNormalsTTA, median
from omnidata_tpu_torch.train import create_train_state, normal_optimizer
from omnidata_tpu_torch.train.checkpoints import CheckpointManager
from omnidata_tpu_torch.train.driver import state_tree
from omnidata_tpu_torch.train.metrics import depth_metrics, normal_metrics
from omnidata_tpu_torch.utils.pil_image import pil_float_resize

from _torch_port_util import jax_mini_scene

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
METRIC_RTOL, MEDIAN_ATOL = 1e-5, 1e-4
TTA_TOL = 1e-5
EXT_TOL = 1e-4
DRIVER_RTOL, DPT_RTOL = 1e-4, 1e-3
BF16_RTOL = 0.05  # bfloat16's 8-bit mantissa over DPT's ~100 layers (0.54% seen, si_log)


def _close_dict(got, want, rtol, atol=1e-12, median_atol=None):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        tol = atol
        if median_atol is not None and "median" in k:
            tol = median_atol
        assert isinstance(got[k], float), (k, type(got[k]))
        assert abs(got[k] - float(want[k])) <= tol + rtol * abs(float(want[k])), \
            (k, got[k], float(want[k]))


# ---- metrics -------------------------------------------------------------

def _mask(kind, shape):
    if kind == "full":
        return np.ones(shape, bool)
    if kind == "empty":
        return np.zeros(shape, bool)
    m = np.random.RandomState(9).rand(*shape) > 0.4
    return m


@pytest.mark.parametrize("mask_kind", ["full", "partial", "empty"])
def test_normal_metrics_match_jax(mask_kind):
    rng = np.random.RandomState(0)
    pred = rng.uniform(-1, 1, (2, 3, 9, 11)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 3, 9, 11)).astype(np.float32)
    target[:, :, :4] = pred[:, :, :4] + 0.05 * rng.standard_normal((2, 3, 4, 11))
    mask = _mask(mask_kind, (2, 1, 9, 11))
    want = j_normal_metrics(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = normal_metrics(torch.from_numpy(pred), torch.from_numpy(target),
                         torch.from_numpy(mask))
    _close_dict(got, want, METRIC_RTOL, median_atol=MEDIAN_ATOL)
    got64 = normal_metrics(torch.from_numpy(pred).double(),
                           torch.from_numpy(target).double(), torch.from_numpy(mask))
    _close_dict(got64, want, METRIC_RTOL, atol=1e-6, median_atol=MEDIAN_ATOL)


@pytest.mark.parametrize("mask_kind", ["full", "partial", "empty"])
def test_depth_metrics_match_jax(mask_kind):
    rng = np.random.RandomState(1)
    pred = rng.rand(2, 1, 9, 11).astype(np.float32)
    target = (rng.rand(2, 1, 9, 11) * 0.9 + 0.05).astype(np.float32)
    mask = _mask(mask_kind, (2, 1, 9, 11))
    want = j_depth_metrics(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = depth_metrics(torch.from_numpy(pred), torch.from_numpy(target),
                        torch.from_numpy(mask))
    _close_dict(got, want, METRIC_RTOL)


def test_metrics_perfect_and_degraded():
    """tests/test_train.py:213 on the port."""
    rng = np.random.RandomState(0)
    n = rng.rand(1, 3, 8, 8).astype(np.float32) * 2 - 1
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    mask = torch.ones((1, 1, 8, 8), dtype=torch.bool)
    m = normal_metrics(torch.from_numpy(n), torch.from_numpy(n), mask)
    assert m["ang_error_mean"] < 0.1
    assert m["percentage_within_11.25_degrees"] == 1.0
    d = torch.from_numpy(rng.rand(1, 1, 8, 8).astype(np.float32) + 0.1)
    md = depth_metrics(d, d, mask)
    assert md["eval_L1"] == 0.0 and md["rel_error"] == 0.0
    md2 = depth_metrics(d * 1.5, d, mask)
    assert md2["eval_L1"] > 0 and md2["si_log"] > 0


# ---- TTA -----------------------------------------------------------------

_W = np.random.RandomState(3).standard_normal((3, 3)).astype(np.float32)


def _jmodel(x):
    """A deterministic model that is not mirror-symmetric: a 1x1 conv, a
    horizontal ramp over the image's own width, tanh."""
    ramp = jnp.linspace(-1.0, 1.0, x.shape[3], dtype=jnp.float32)
    return jnp.tanh(jnp.einsum("oc,bchw->bohw", jnp.asarray(_W), x) + ramp)


def _tmodel(x):
    ramp = torch.linspace(-1.0, 1.0, x.shape[3], dtype=torch.float32)
    return torch.tanh(torch.einsum("oc,bchw->bohw", torch.from_numpy(_W), x) + ramp)


@pytest.mark.parametrize("scales", [(), (0.5, 1.5)])
@pytest.mark.parametrize("merger", ["median", "mean"])
def test_tta_matches_jax(scales, merger):
    x = np.random.RandomState(4).rand(2, 3, 32, 32).astype(np.float32)
    want = np.asarray(JTTA(_jmodel, hflip=True, scales=scales, merger=merger)(
        jnp.asarray(x)))
    got = SurfaceNormalsTTA(_tmodel, hflip=True, scales=scales, merger=merger)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TTA_TOL)


def test_two_member_median_is_the_mean_of_the_pair():
    """jnp.median of identity + flip averages the pair; torch.median
    would return the lower member on every pixel where they differ."""
    rng = np.random.RandomState(5)
    stack = rng.standard_normal((2, 1, 3, 4, 5)).astype(np.float32)
    want = np.asarray(jnp.median(jnp.asarray(stack), axis=0))
    got = median(torch.from_numpy(stack)).numpy()
    np.testing.assert_array_equal(got, want)
    lower = torch.median(torch.from_numpy(stack), 0).values.numpy()
    assert (np.abs(lower - want) > 1e-3).mean() > 0.9
    for n in (3, 4):
        s = rng.standard_normal((n, 2, 3)).astype(np.float32)
        np.testing.assert_allclose(median(torch.from_numpy(s)).numpy(),
                                   np.asarray(jnp.median(jnp.asarray(s), axis=0)),
                                   rtol=0, atol=1e-7)


def test_tta_inverts_flip_exactly():
    """tests/test_models.py:466 on the port: a mirror-equivariant oracle
    passes through flip TTA unchanged; scale TTA keeps shapes and unit norm."""
    H = W = 16
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    N = np.stack([(xx - W / 2) / W, (yy - H / 2) / H, np.ones_like(xx)])
    N = N / np.linalg.norm(N, axis=0, keepdims=True)
    base = np.random.RandomState(0).rand(1, 3, H, W).astype(np.float32)

    def oracle(x):
        out = N.copy()
        if not np.allclose(x.numpy(), base):
            out = out[:, :, ::-1].copy()
            out[0] *= -1
        return torch.from_numpy(out[None])

    got = SurfaceNormalsTTA(oracle, hflip=True)(torch.from_numpy(base)).numpy()[0]
    np.testing.assert_allclose(got, N, atol=1e-5)

    def const(x):
        src = N[None] if x.shape[2] == H else N[:, :1, :1][None]
        return torch.from_numpy(np.broadcast_to(src, (1, 3, x.shape[2], x.shape[3])).copy())

    out = SurfaceNormalsTTA(const, hflip=False, scales=(0.5, 2.0))(torch.from_numpy(base))
    assert out.shape == (1, 3, H, W)
    np.testing.assert_allclose(torch.linalg.norm(out, dim=1).numpy(), 1.0, atol=1e-5)


# ---- PIL's float resizes -------------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("src,dst", [((37, 53), (11, 13)), ((37, 53), (101, 97)),
                                     ((7, 5), (64, 3)), ((40, 60), (40, 61))])
def test_pil_float_resize_bit_for_bit(method, src, dst):
    from PIL import Image

    a = (np.random.RandomState(6).standard_normal(src) * 100).astype(np.float32)
    m = Image.BILINEAR if method == "bilinear" else Image.NEAREST
    want = np.asarray(Image.fromarray(a, mode="F").resize(dst[::-1], m))
    got = pil_float_resize(a, dst[::-1], method)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---- OASIS / NYU ---------------------------------------------------------

def _oasis_fixture(d: Path, H=40, W=60):
    """tests/test_components.py:202's OASIS layout, the PNG written by the
    port's encoder."""
    rng = np.random.RandomState(0)
    save_png(str(d / "im0.png"), (rng.rand(H, W, 3) * 255).astype(np.uint8))
    n = np.array([0.6, 0.0, 0.8], np.float32)
    roi = np.zeros((10, 20, 3), np.float32)
    roi[:, :] = n
    roi[0, 0] = 0  # a hole -> masked out
    with open(d / "n0.pkl", "wb") as fh:
        pickle.dump({"min_y": 5, "max_y": 14, "min_x": 7, "max_x": 26, "normal": roi}, fh)
    (d / "oasis.csv").write_text("Image,unused1,unused2,Normal\n"
                                 "im0.png,,,n0.pkl\nim0.png,,,\n")
    return n


def _nyu_fixture(d: Path, H=48, W=64):
    """tests/test_components.py:294's NYU layout: two .h5 files, normal and
    mask PNGs."""
    import h5py

    rng = np.random.RandomState(0)
    (d / "normals_gt" / "normals").mkdir(parents=True)
    (d / "normals_gt" / "masks").mkdir(parents=True)
    for i in (3, 7):
        with h5py.File(d / f"{i:04}.h5", "w") as f:
            f["rgb"] = (rng.rand(3, H, W) * 255).astype(np.uint8)
            f["depth"] = (rng.rand(H, W) * 12).astype(np.float32)
        save_png(str(d / "normals_gt" / "normals" / f"{i:04}.png"),
                 (rng.rand(H, W, 3) * 255).astype(np.uint8))
        mask = np.zeros((H, W), np.uint8)
        mask[10:30, 10 + i:50] = 255
        save_png(str(d / "normals_gt" / "masks" / f"{i:04}.png"), mask)


def _same_sample(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_oasis_datasets_equal_jax(tmp_path):
    _oasis_fixture(tmp_path)
    csv = str(tmp_path / "oasis.csv")
    for jds, tds in ((jext.OASISNormalDatasetVal(csv, root=str(tmp_path), short_side_size=64),
                      text.OASISNormalDatasetVal(csv, root=str(tmp_path), short_side_size=64)),
                     (jext.OASISNormalDataset(csv, root=str(tmp_path), img_size=33),
                      text.OASISNormalDataset(csv, root=str(tmp_path), img_size=33))):
        assert len(tds) == len(jds) == 1
        _same_sample(tds[0], jds[0])


def test_nyu_datasets_equal_jax(tmp_path):
    _nyu_fixture(tmp_path)
    for cls in ("NYUNormalDataset", "NYUDepthDataset"):
        jds = getattr(jext, cls)(str(tmp_path), short_side_size=32)
        tds = getattr(text, cls)(str(tmp_path), short_side_size=32)
        assert len(tds) == len(jds) == 2
        for i in range(2):
            _same_sample(tds[i], jds[i])


def test_nyu_without_h5py_says_so(tmp_path, monkeypatch):
    _nyu_fixture(tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py -> ImportError
    with pytest.raises(ImportError, match="h5py"):
        text.NYUNormalDataset(str(tmp_path))[0]


_WN = np.random.RandomState(7).standard_normal((3, 3)).astype(np.float32)


def _j_apply(variables, x):
    return jax.nn.sigmoid(jnp.einsum("oc,bchw->bohw", variables, x) - 0.2)


class _TNet(torch.nn.Module):
    def forward(self, x):
        return torch.sigmoid(torch.einsum("oc,bchw->bohw", torch.from_numpy(_WN), x) - 0.2)


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("data", ["oasis", "nyu"])
def test_evaluate_normals_matches_jax(tmp_path, tta, data):
    if data == "oasis":
        _oasis_fixture(tmp_path)
        jds = jext.OASISNormalDatasetVal(str(tmp_path / "oasis.csv"), root=str(tmp_path),
                                         short_side_size=64)
        tds = text.OASISNormalDatasetVal(str(tmp_path / "oasis.csv"), root=str(tmp_path),
                                         short_side_size=64)
    else:
        _nyu_fixture(tmp_path)
        jds, tds = jext.NYUNormalDataset(str(tmp_path), 32), text.NYUNormalDataset(str(tmp_path), 32)
    jfn = jext.make_oasis_model_fn(_j_apply, jnp.asarray(_WN))
    tfn = text.make_oasis_model_fn(_TNet())
    if tta:
        jfn, tfn = JTTA(jfn), SurfaceNormalsTTA(tfn)
    want = jext.evaluate_normals(jfn, jds, fixed_input_size=(32, 48))
    got = text.evaluate_normals(tfn, tds, fixed_input_size=(32, 48))
    _close_dict(got, want, 0.0, atol=EXT_TOL)


def test_evaluate_normals_known_answers(tmp_path):
    """tests/test_components.py:225 on the port: ~0 error for the exact
    normal, the analytic 30 degrees for a rotated one."""
    n = _oasis_fixture(tmp_path)
    ds = text.OASISNormalDatasetVal(str(tmp_path / "oasis.csv"), root=str(tmp_path),
                                    short_side_size=64)
    s = ds[0]
    assert s["orig_size"] == (40, 60) and s["mask"].sum() == 10 * 20 - 1

    def const(v):
        return lambda x: np.broadcast_to(v[None, :, None, None], (1, 3) + tuple(x.shape[2:]))

    r = text.evaluate_normals(const(n), ds, fixed_input_size=None)
    assert r["MAE"] < 0.5 and r["11.25"] > 0.99
    th = np.deg2rad(30.0)
    m = np.array([np.cos(th) * n[0] - np.sin(th) * n[2], 0.0,
                  np.sin(th) * n[0] + np.cos(th) * n[2]], np.float32)
    r = text.evaluate_normals(const(m), ds, fixed_input_size=(32, 32))
    assert abs(r["MAE"] - 30.0) < 0.5 and r["22.5"] < 0.01 and abs(r["MDAE"] - 30.0) < 0.5


# ---- the drivers ---------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jax_mini_scene(str(tmp_path_factory.mktemp("eval_scene")))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Published-layout checkpoints of the port's seeded UNet and of a DPT
    depth net whose residual branches start small (tests/test_torch_demo.py's
    weights), and the JAX bundles read from them (each jitted once)."""
    from omnidata_tpu.models import create_model as j_create_model

    from test_torch_demo import _flax_params

    d = tmp_path_factory.mktemp("eval_weights")
    unet = UNet(out_channels=3)
    init_weights(unet, torch.Generator().manual_seed(3))
    paths = {"unet": str(d / "unet.pth"), "dpt": str(d / "dpt.ckpt")}
    torch.save(unet.state_dict(), paths["unet"])
    torch.save(state_dict_from_flax(_dpt_mapping(), _flax_params(1, 1)), paths["dpt"])
    bundles = {"surface_normal_unet": j_create_model("surface_normal_unet",
                                                     checkpoint=paths["unet"]),
               "depth_dpt_hybrid_384": j_create_model("depth_dpt_hybrid_384",
                                                      checkpoint=paths["dpt"])}
    return paths, bundles


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue())


def _jax_driver(name, argv, bundles, monkeypatch):
    """The root script's main on the prebuilt bundle (create_model
    monkeypatched, so its jitted apply compiles once per module)."""
    import omnidata_tpu.models as jmodels

    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(jmodels, "create_model", lambda n, **kw: bundles[n])
    mod = __import__(name)
    return _run(mod.main, argv)


@pytest.mark.parametrize("align", ["none", "ssi"])
def test_eval_depth_matches_jax(scene, weights, align, monkeypatch):
    paths, bundles = weights
    argv = ["--data_path", scene, "--checkpoint", paths["dpt"], "--image_size", "64",
            "--batch_size", "3", "--align", align]
    want = _jax_driver("eval_depth", argv, bundles, monkeypatch)
    got = _run(t_eval_depth.main, argv + ["--device", "cpu"])
    _close_dict(got, want, DPT_RTOL, atol=1e-7)


def test_eval_depth_in_bfloat16(scene, weights, monkeypatch):
    """--dtype bfloat16 builds the model in bfloat16 (norms in float32) and
    gives the float32 run's metrics within bfloat16's rounding."""
    paths, _ = weights
    argv = ["--data_path", scene, "--checkpoint", paths["dpt"], "--image_size", "64",
            "--batch_size", "3", "--device", "cpu"]
    dtypes = []
    import omnidata_tpu_torch.models as tmodels

    real = tmodels.create_model

    def spy(name, **kw):
        model = real(name, **kw)
        dtypes.append(model.net.pretrained.model.blocks[0].attn.qkv.weight.dtype)
        return model

    monkeypatch.setattr(tmodels, "create_model", spy)
    want = _run(t_eval_depth.main, argv)
    got = _run(t_eval_depth.main, argv + ["--dtype", "bfloat16"])
    assert dtypes == [torch.float32, torch.bfloat16]
    _close_dict(got, want, BF16_RTOL, atol=1e-4)


@pytest.mark.parametrize("extra", [[], ["--tta"], ["--oasis"], ["--oasis", "--tta"]])
def test_eval_normal_unet_matches_jax(scene, weights, extra, tmp_path, monkeypatch):
    paths, bundles = weights
    argv = ["--checkpoint", paths["unet"], "--model", "unet", "--image_size", "64",
            "--batch_size", "3"]
    if "--oasis" in extra:
        _oasis_fixture(tmp_path)
        argv += ["--oasis_csv", str(tmp_path / "oasis.csv"), "--oasis_root", str(tmp_path)]
    else:
        argv += ["--data_path", scene]
    argv += [a for a in extra if a == "--tta"]
    want = _jax_driver("eval_normal", argv, bundles, monkeypatch)
    got = _run(t_eval_normal.main, argv + ["--device", "cpu"])
    keys = {"MAE", "MDAE", "11.25", "22.5", "30"} if "--oasis" in extra else {
        "ang_error_mean", "ang_error_median", "percentage_within_11.25_degrees",
        "percentage_within_22.5_degrees", "percentage_within_30_degrees", "eval_L1",
        "eval_mse"}
    assert set(got) == keys
    _close_dict(got, want, DRIVER_RTOL, atol=1e-7, median_atol=MEDIAN_ATOL)


@pytest.mark.parametrize("driver", ["eval_depth", "eval_normal"])
def test_nyu_protocols_match_jax(weights, driver, tmp_path, monkeypatch):
    """--nyu_root: eval_depth's NYU depth protocol (DPT) and eval_normal's
    NYU normal protocol (UNet), on tests/test_components.py:294's layout."""
    paths, bundles = weights
    _nyu_fixture(tmp_path)
    argv = ["--nyu_root", str(tmp_path), "--image_size", "64"]
    if driver == "eval_depth":
        argv += ["--checkpoint", paths["dpt"]]
        main, rtol = t_eval_depth.main, DPT_RTOL
    else:
        argv += ["--checkpoint", paths["unet"], "--model", "unet"]
        main, rtol = t_eval_normal.main, DRIVER_RTOL
    want = _jax_driver(driver, argv, bundles, monkeypatch)
    got = _run(main, argv + ["--device", "cpu"])
    _close_dict(got, want, rtol, atol=1e-7, median_atol=MEDIAN_ATOL)


def test_eval_drivers_refuse_cuda_without_a_card(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (t_eval_depth.main, t_eval_normal.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--data_path", scene])


# ---- checkpoint directories in the registry ------------------------------

def test_create_model_reads_a_trainer_checkpoint_directory(tmp_path):
    """A CheckpointManager directory (step_<N> and last) through
    create_model gives the trained net's outputs bit for bit."""
    net = UNet(out_channels=3)
    init_weights(net, torch.Generator().manual_seed(0))
    state = create_train_state(net, normal_optimizer(lr=1e-3))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(1, 3, 64, 64).astype(np.float32))
    loss = (net(x) - 0.5).abs().mean()
    loss.backward()
    state.apply_gradients()
    ckpt = CheckpointManager(str(tmp_path / "run"), save_top_k=1)
    ckpt.save(state_tree(state), 1, metric=0.5)
    with torch.no_grad():
        want = net.eval()(x)
        for name in ("step_1", "last"):
            m = create_model("surface_normal_unet", checkpoint=str(tmp_path / "run" / name),
                             device="cpu")
            assert torch.equal(m(x), want), name


def test_demo_reads_a_checkpoint_directory(tmp_path):
    """demo --checkpoint DIR equals demo --checkpoint FILE on the same
    weights (seed 1, not the demo's seeded default)."""
    net = DPTHybrid(num_channels=3)
    init_weights(net, torch.Generator().manual_seed(1))
    CheckpointManager(str(tmp_path / "run")).save(
        {"step": torch.tensor(5), "params": net.state_dict(), "opt_state": {}}, 5)
    torch.save(net.state_dict(), tmp_path / "dpt.pth")
    del net
    png = str(tmp_path / "im.png")
    save_png(png, (np.random.RandomState(2).rand(96, 80, 3) * 255).astype(np.uint8))
    for ck, out in ((tmp_path / "run" / "last", "a"), (tmp_path / "dpt.pth", "b")):
        tdemo.main(["--task", "normal", "--img_path", png, "--output_path",
                    str(tmp_path / out), "--checkpoint", str(ck), "--image_size", "64",
                    "--device", "cpu"])
    a, b = (load_png(str(tmp_path / o / "im_normal.png")) for o in "ab")
    np.testing.assert_array_equal(a, b)
    assert a.std() > 0
