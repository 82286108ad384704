"""The port's offline accuracy benchmark (``omnidata_tpu_torch.accuracy_benchmark``)
against the JAX package's tool (``tools/accuracy_benchmark.py``, loaded by
path, unedited), on the CPU:

- ``make_scene``: the same mesh and vertex colours for two seeds at a
  coarse ``edge`` (1.0): faces equal, vertices and colours within 1e-6,
  the PLY files' headers and faces equal;
- ``annotate_scene`` at 64² on one coarse scene: the same cameras
  (point_info within 1e-5, the same view count) and every label within
  the integer-label rule. Both run with the tools' settings plus
  FORCE_BATCHED_PATH=1: at 64² some views of these scenes need more than
  the per-view route's 8192 candidates, and both CLIs stop there
  (``raster.render_view``'s cap), so both take the batched route;
- the trainer configs: what ``utils.config.loads`` reads back from the
  port's file equals ``yaml.safe_load`` of the JAX tool's, for both;
- both untrained evaluation suites on 3 held-out views, with JAX's initial
  weights (``module.init`` at PRNGKey(0)) carried to the port by
  ``models.convert.state_dict_from_flax``: every metric within 1e-3
  relative;
- a tiny ``main`` on the CPU (1 train and 1 held-out scene, 64², 2 steps
  each at batch 2, NUM_POINTS=2, the depth half on ``graft_entry.TINY_DPT``
  patched into the registry and the trainer): ACCURACY_TORCH.md with
  finite rows, and no ACCURACY.md; ``--out`` naming ACCURACY.md and
  ``--device cuda`` without a card raise.
"""
import functools
import importlib.util
import math
import os
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from omnidata_tpu_torch import accuracy_benchmark as tab
from omnidata_tpu_torch.utils.config import dumps, loads

from _torch_port_util import TINY_DPT, assert_same_tree, int_label_ok

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EDGE = 1.0
RES = 64
FORCE = "FORCE_BATCHED_PATH=1"
SUITE_RTOL = 1e-3
SUITE_VIEWS = 3


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_benchmark", ROOT / "tools" / "accuracy_benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jab = _jax_tool()


# ---- utils/config.dumps --------------------------------------------------

def test_dumps_round_trips_through_loads_and_pyyaml():
    cfg = {"model": "unet", "lr": 1e-5, "wd": 2.0e-6, "big": 1e20, "steps": 600,
           "on": True, "off": False, "none": None, "colon": "a: b", "quote": "it's",
           "hash": "a #b", "true": "yes", "word": "no",
           "nested": {"replica": "/data/x", "deeper": {"k": 0.5}}}
    text = dumps(cfg)
    assert loads(text) == cfg
    assert yaml.safe_load(text) == cfg


@pytest.mark.parametrize("bad", [{"a": [1, 2]}, {"a": {}}, {"a": float("nan")},
                                 {"a": float("inf")}, {1: 2}])
def test_dumps_refuses_what_loads_cannot_read(bad):
    with pytest.raises(ValueError):
        dumps(bad)


def _stub_trainer(seen):
    def main(argv):
        seen.append(Path(argv[argv.index("--config_file") + 1]).read_text())
        cfg = yaml.safe_load(seen[-1])
        os.makedirs(cfg["checkpoint_dir"], exist_ok=True)
    return main


@pytest.mark.parametrize("which", ["normal", "depth"])
def test_trainer_configs_equal_jax(which, tmp_path, monkeypatch):
    """Each tool's train_*_model writes its config and starts the trainer
    (a stub here): the port's file read by loads equals the JAX tool's
    read by yaml.safe_load."""
    from omnidata_tpu_torch import train_depth, train_normal

    got, want = [], []
    mod = {"normal": train_normal, "depth": train_depth}[which]
    monkeypatch.setattr(mod, "main", _stub_trainer(got))
    monkeypatch.setitem(sys.modules, f"train_{which}",
                        types.SimpleNamespace(main=_stub_trainer(want)))
    for fn, root, sink in ((getattr(tab, f"train_{which}_model"), tmp_path / "port", got),
                           (getattr(jab, f"train_{which}_model"), tmp_path / "jax", want)):
        os.makedirs(root)
        args = (str(root), "/data/train", "/data/val", 300)
        args += (512, 16) if which == "normal" else (8,)
        extra = ("cpu",) if sink is got else ()
        fn(*args, *extra)
    g, w = loads(got[0]), yaml.safe_load(want[0])
    for cfg, root in ((g, "port"), (w, "jax")):
        for key in ("checkpoint_dir", "packed_cache"):
            cfg[key] = os.path.relpath(cfg[key], tmp_path / root)
    assert g == w
    assert isinstance(g["lr"], float) and g["max_steps"] == 300


# ---- make_scene ----------------------------------------------------------

def _recording(write_ply, sink):
    def rec(path, v, f, vertex_colors=None, **kw):
        sink.append((np.asarray(v), np.asarray(f), np.asarray(vertex_colors)))
        return write_ply(path, v, f, vertex_colors=vertex_colors, **kw)
    return rec


def _ply_parts(path):
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    nv = int(raw[:end].split(b"element vertex ")[1].split(b"\n")[0])
    return raw[:end], raw[end + nv * 15:]  # header; faces (vertex: 3 f4 + 3 u1)


@pytest.mark.parametrize("seed", [1, 100])
def test_make_scene_equals_jax(seed, tmp_path, monkeypatch):
    import omnidata_tpu.utils.convert_mesh as jconv
    import omnidata_tpu_torch.utils.convert_mesh as tconv

    got, want = [], []
    monkeypatch.setattr(tconv, "write_ply", _recording(tconv.write_ply, got))
    monkeypatch.setattr(jconv, "write_ply", _recording(jconv.write_ply, want))
    for name, fn in (("port", tab.make_scene), ("jax", jab.make_scene)):
        os.makedirs(tmp_path / name)
        fn(str(tmp_path / name), seed, EDGE)
    (gv, gf, gc), (wv, wf, wc) = got[0], want[0]
    assert gf.shape == wf.shape and len(gf) > 10_000
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-6)
    assert _ply_parts(tmp_path / "port" / "mesh.ply") == _ply_parts(
        tmp_path / "jax" / "mesh.ply")


# ---- annotate_scene ------------------------------------------------------

def _point_info(d):
    out = {}
    for p in sorted((Path(d) / "point_info").glob("*.json")):
        out[p.name] = yaml.safe_load(p.read_text())  # JSON is YAML
    return out


def _labels(d, task):
    from PIL import Image

    return {p.name: np.asarray(Image.open(p)) for p in sorted((Path(d) / task).glob("*.png"))}


@pytest.fixture(scope="module")
def annotated(tmp_path_factory):
    """One coarse scene (seed 0, edge 1.0) annotated at 64² by both tools'
    annotate_scene -> (port dir, JAX dir)."""
    import omnidata_tpu.annotator.settings as jsettings

    base = tmp_path_factory.mktemp("annotated")
    dirs = [str(base / "port"), str(base / "jax")]
    for d in dirs:
        os.makedirs(d)
    jab.make_scene(dirs[1], 0, EDGE)
    shutil.copy(os.path.join(dirs[1], "mesh.ply"), dirs[0])
    tab.annotate_scene(dirs[0], RES, 32, "cpu", (FORCE,))
    load = jsettings.load_settings
    jsettings.load_settings = lambda argv=None, *a, **kw: load(
        list(argv or []) + [FORCE], *a, **kw)
    try:
        jab.annotate_scene(dirs[1], RES, 32)
    finally:
        jsettings.load_settings = load
    return tuple(dirs)


def test_annotate_scene_cameras_equal_jax(annotated):
    got, want = (_point_info(d) for d in annotated)
    assert len(want) >= 20 and list(got) == list(want)
    assert_same_tree(got, want)


@pytest.mark.parametrize("task", tab.RENDER_TASKS)
def test_annotate_scene_labels_equal_jax(annotated, task):
    got, want = (_labels(d, task) for d in annotated)
    assert list(got) == list(want) and len(want) == len(_point_info(annotated[1]))
    for name in want:
        assert got[name].shape[:2] == (RES, RES) and got[name].dtype == want[name].dtype
        ok, dmax, frac = int_label_ok(got[name], want[name])
        assert ok, (name, dmax, frac)


# ---- the untrained evaluation suites on JAX's initial weights ------------

def _jax_untrained_bundles():
    """JAX's registry models as its create_model builds them without a
    checkpoint (module.init at PRNGKey(0); jitted here, which gives the
    same parameters), keyed by name."""
    from omnidata_tpu.models import DPTHybrid as JDPT
    from omnidata_tpu.models import UNet as JUNet
    from omnidata_tpu.models.registry import ModelBundle, _nchw_to_nhwc

    unet, dpt = JUNet(out_channels=3), JDPT(num_channels=1)
    key = jax.random.PRNGKey(0)
    vu = jax.jit(unet.init)(key, jnp.zeros((1, 64, 64, 3)))
    vd = jax.jit(dpt.init)(key, jnp.zeros((1, 384, 384, 3)))

    @jax.jit
    def apply_unet(variables, x):
        return jnp.transpose(unet.apply(variables, _nchw_to_nhwc(x)), (0, 3, 1, 2))

    @jax.jit
    def apply_dpt(variables, x):
        return dpt.apply(variables, _nchw_to_nhwc(x)).astype(jnp.float32)[..., 0]

    return {"surface_normal_unet": ModelBundle(unet, vu, apply_unet),
            "depth_dpt_hybrid_384": ModelBundle(dpt, vd, apply_dpt)}


def _close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        assert math.isfinite(got[k]) and abs(got[k] - want[k]) <= rtol * abs(want[k]), (
            k, got[k], want[k])


def test_untrained_suites_equal_jax_on_carried_weights(annotated, tmp_path, monkeypatch):
    import omnidata_tpu.models as jmodels
    from omnidata_tpu_torch.models.convert import (
        _dpt_mapping,
        _unet_mapping,
        state_dict_from_flax,
    )

    val = tmp_path / "val" / "scene_00"
    for task in tab.RENDER_TASKS:
        os.makedirs(val / task)
        for p in sorted((Path(annotated[1]) / task).glob("*.png"))[:SUITE_VIEWS]:
            shutil.copy(p, val / task)
    val_root = str(tmp_path / "val")
    bundles = _jax_untrained_bundles()

    def j_create_model(name, checkpoint=None, **kw):
        assert checkpoint is None  # the untrained suite
        return bundles[name]

    monkeypatch.setattr(jmodels, "create_model", j_create_model)
    monkeypatch.syspath_prepend(str(ROOT))
    paths = {"unet": str(tmp_path / "unet.pth"), "dpt": str(tmp_path / "dpt.pth")}
    torch.save(state_dict_from_flax(_unet_mapping(), jax.device_get(
        bundles["surface_normal_unet"].variables)), paths["unet"])
    torch.save(state_dict_from_flax(_dpt_mapping(), jax.device_get(
        bundles["depth_dpt_hybrid_384"].variables)), paths["dpt"])

    want = jab.eval_normal_suite(val_root, RES, None)
    got = tab.eval_normal_suite(val_root, RES, paths["unet"], "cpu")
    assert len(want) == 7 and want["ang_error_mean"] > 45.0  # untrained
    _close(got, want, SUITE_RTOL)
    want = jab.eval_depth_suite(val_root, None)
    got = tab.eval_depth_suite(val_root, paths["dpt"], "cpu")
    assert len(want) == 7
    _close(got, want, SUITE_RTOL)


# ---- main ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    from omnidata_tpu_torch import train_depth
    from omnidata_tpu_torch.models import DPTHybrid, registry

    root = tmp_path_factory.mktemp("tiny_main")
    jax_record = (ROOT / "ACCURACY.md").read_bytes()
    tiny = functools.partial(DPTHybrid, **TINY_DPT)
    saved = registry.DPTHybrid, train_depth.DPTHybrid
    registry.DPTHybrid = train_depth.DPTHybrid = tiny
    try:
        out = tab.main([
            "--device", "cpu", "--root", str(root / "run"), "--out",
            str(root / "ACCURACY_TORCH.md"), "--train_scenes", "1", "--val_scenes", "1",
            "--res", str(RES), "--edge", str(EDGE), "--normal_steps", "2",
            "--depth_steps", "2", "--normal_batch", "2", "--depth_batch", "2",
            "--settings", FORCE, "NUM_POINTS=2"])
    finally:
        registry.DPTHybrid, train_depth.DPTHybrid = saved
    yield root, out, jax_record
    shutil.rmtree(root / "run")  # the full UNet's checkpoints: ~1 GB each


def test_tiny_main_writes_a_finite_report(tiny_run):
    root, out, _ = tiny_run
    text = (root / "ACCURACY_TORCH.md").read_text()
    rows = tab.report_rows(text)
    for section in ("Surface", "Depth"):
        for model in ("untrained init", "trained"):
            vals = rows[(section, model)]
            assert len(vals) == 7 and all(map(math.isfinite, vals)), (section, model)
    assert out["n_train_views"] > 0 and out["n_val_views"] > 0
    assert out["n_train_views"] == len(os.listdir(root / "run/train/scene_00/rgb"))
    assert out["device"] == "cpu" and "- device: cpu" in text
    for k in ("depth_untrained_zero_share", "depth_trained_zero_share"):
        assert 0.0 <= out[k] <= 1.0
    assert set(out["seconds"]) == {
        "render", "eval_normal_untrained", "train_normal", "eval_normal_trained",
        "eval_depth_untrained", "zero_share_untrained", "train_depth",
        "eval_depth_trained", "zero_share_trained", "total"}
    assert (root / "run/ckpt_normal/.done").exists() and (root / "run/ckpt_depth/.done").exists()


def test_tiny_main_never_writes_accuracy_md(tiny_run):
    root, _, jax_record = tiny_run
    assert (ROOT / "ACCURACY.md").read_bytes() == jax_record
    assert not list(root.rglob("ACCURACY.md"))
    with pytest.raises(ValueError, match="ACCURACY.md"):
        tab.main(["--device", "cpu", "--root", str(root / "other"),
                  "--out", str(ROOT / "ACCURACY.md")])
    assert not (root / "other").exists()


def test_jax_record_rows_are_accuracy_md_s():
    rows = tab.report_rows((ROOT / "ACCURACY.md").read_text())
    keys = sorted(tab.JAX_NORMAL_RECORD["trained"])
    for model, rec in tab.JAX_NORMAL_RECORD.items():
        assert rows[("Surface", model)] == [rec[k] for k in keys]


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tab.main(["--root", str(tmp_path / "run"), "--out", str(tmp_path / "A.md")])
    assert not (tmp_path / "run").exists() and not (tmp_path / "A.md").exists()
