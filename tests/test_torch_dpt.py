"""DPT-Hybrid against its plain reference, and the batched predict route.

- ``tools/dpt_reference.py`` (plain torch, float32, a functional forward
  over the published key schema) against the port's ``DPTHybrid`` in
  float32, at a small width and at the published widths, within 1e-4
  relative: the two compute the same function in a different order of
  operations, and float32 rounding through ~100 layers stays near 1e-6
  (3e-6 measured); a wrong padding, scale or tap is off by far more.
- the port in bfloat16 (``registry.cast_params_bf16``) against the
  reference in float32, on the benchmark's seeded weights, within the
  benchmark cell's relative L2 limit (``benchmark/limits``); the reference
  with its operands rounded to float8 e4m3 lands far outside it;
- every key of the state dict is read by the reference, or is one of the
  tensors DPT holds and never runs; the benchmark's weight generator lays
  out exactly the port's keys and shapes;
- the reference imports nothing of the port or of JAX;
- ``models.predict.predict_batches`` yields each batch in order, equal to
  the ``Predictor`` called directly, and records its spans and counters
  (and the model's) only while a profiler runs; ``Predictor.stages``, which
  the route replays as CUDA graphs on a card, compose to ``forward``; the
  resized position embedding is kept only while no gradient is taken;
- ``demo --batch_size 2 --dtype bfloat16`` runs; batched float32 agrees
  with one image a batch;
- ``benchmark.dpt_work`` equals ``utils.flops.model_flops``.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import dpt_work
from benchmark.gen import dpt_weights
from omnidata_tpu_torch import demo as tdemo
from omnidata_tpu_torch.cues.encode import load_png, save_png
from omnidata_tpu_torch.models.dpt import DPTHybrid
from omnidata_tpu_torch.models.predict import predict_batches
from omnidata_tpu_torch.models.registry import Predictor, cast_params_bf16, init_weights
from omnidata_tpu_torch.utils import profiler
from omnidata_tpu_torch.utils.flops import model_flops
from tools import dpt_reference as ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark" / "configs" / "dpt-hybrid-384.json").read_text())
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "dpt.infer-bf16-b8.json").read_text())
SMALL = dict(vit_dim=64, vit_heads=4, vit_blocks=4, hooks=(1, 3), features=64)
SMALL_CFG = {**CFG, "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 4,
             "intermediate_size": 256, "fusion_features": 64, "head_widths": [32, 32]}
F32_RTOL = 1e-4
DPT_SPANS = ("dpt.backbone", "dpt.encoder", "dpt.decoder")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _net(kw, seed=0):
    net = DPTHybrid(**kw).eval()
    init_weights(net, torch.Generator().manual_seed(seed))
    return net


def _images(n, size, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)


def _normalised(crops, task="depth"):
    x = torch.from_numpy(crops.transpose(0, 3, 1, 2).astype(np.float32) / np.float32(255))
    return (x - 0.5) / 0.5 if task == "depth" else x


@pytest.fixture(autouse=True)
def empty_recorder():
    profiler.reset()
    yield
    profiler.reset()


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "published"])
def test_reference_matches_the_port_in_float32(kw):
    net = _net(kw)
    x = _normalised(_images(2, 64))
    with torch.no_grad():
        got = net(x)
        want = ref.dpt_forward(net.state_dict(), x, heads=kw.get("vit_heads", 12),
                               hooks=kw.get("hooks", (8, 11)))
    assert got.shape == want.shape == (2, 1, 64, 64)
    assert _rel(got, want) < F32_RTOL
    assert float((got - want).abs().max()) < F32_RTOL * float(want.abs().max())


def test_bfloat16_port_within_the_cells_limit_and_e4m3_outside_it():
    sd = dpt_weights.draw(CFG, CFG["weight_seed"])
    net = DPTHybrid().eval()
    net.load_state_dict(sd, strict=True)
    net = cast_params_bf16(net)
    x = _normalised(_images(2, 64))
    with torch.no_grad():
        got = net(x.bfloat16()).float().clamp(0, 1)
        want = ref.dpt_forward(sd, x).clamp(0, 1)
        e4m3 = ref.dpt_forward(sd, x, rnd=ref.rounder(torch.float8_e4m3fn)).clamp(0, 1)
    limit = LIMITS["depth_rel_l2"]["limit"]
    assert float((want > 0).float().mean()) > 0.9 and float((want < 1).float().mean()) > 0.9
    for i in range(2):
        assert _rel(got[i], want[i]) < limit
        assert _rel(e4m3[i], want[i]) > 2 * limit


class _Reads(dict):
    """A state dict that notes every key read."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_every_key_is_read_or_held_unused():
    sd = _Reads(_net({}).state_dict())
    with torch.no_grad():
        ref.dpt_forward(sd, _normalised(_images(1, 64)))
    held = {k for k in sd if k.startswith(ref.HELD_UNUSED)}
    assert held and not held & sd.read
    assert sd.read | held == set(sd)
    assert {k.split(".weight")[0] for k in held if k.endswith(".weight")} == {
        "pretrained.model.head", "pretrained.model.norm",
        "scratch.refinenet4.resConfUnit1.conv1", "scratch.refinenet4.resConfUnit1.conv2"}


@pytest.mark.parametrize("cfg,kw", [(CFG, {}), (SMALL_CFG, SMALL)], ids=["published", "small"])
def test_weight_generator_lays_out_the_ports_keys(cfg, kw):
    want = {k: tuple(v.shape) for k, v in DPTHybrid(**kw).state_dict().items()}
    got = dict(dpt_weights.schema(cfg))
    assert got == want


def test_reference_loads_nothing_of_the_port():
    probe = ("import json, sys; import tools.dpt_reference; "
             "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    mods = set(json.loads(out.stdout))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "omnidata_tpu", "omnidata_tpu_torch"}


@pytest.mark.parametrize("task", ["depth", "normal"])
def test_predict_batches_yields_in_order_the_predictors_output(task):
    model = Predictor(_net({**SMALL, "num_channels": 1 if task == "depth" else 3}),
                      task == "depth", torch.float32).eval()
    batches = [_images(2, 64, seed=s) for s in (1, 2, 3)]
    got = list(predict_batches(model, iter(batches), task))
    assert len(got) == 3
    for crops, out in zip(batches, got):
        with torch.no_grad():
            want = model(_normalised(crops, task)).clamp(0, 1).numpy()
        assert out.dtype == np.float32 and out.shape == want.shape
        assert out.shape == ((2, 64, 64) if task == "depth" else (2, 3, 64, 64))
        np.testing.assert_array_equal(out, want)
    assert not torch.is_inference_mode_enabled()


def test_predict_records_spans_and_counters_only_while_profiling():
    model = Predictor(_net(SMALL), True, torch.float32).eval()
    batches = [_images(2, 64, seed=s) for s in (1, 2)]
    list(predict_batches(model, iter(batches)))
    got = profiler.summary()
    assert got["spans"] == {} and got["counters"] == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        list(predict_batches(model, iter(batches)))
    got = profiler.summary()
    spans = ("predict.upload", "predict.model", "pipeline.fetch", "pipeline.wait") + DPT_SPANS
    assert set(got["spans"]) == set(spans)
    ids = got["spans"]["predict.upload"]["batches"]
    assert len(ids) == 2
    for name in spans:
        assert got["spans"][name]["count"] == 2 and got["spans"][name]["batches"] == ids
    for name in DPT_SPANS:
        assert got["spans"][name]["parents"] == ["predict.model"]
    c = got["counters"]
    assert c["fetch.bytes"]["total"] == 4 * 64 * 64 * 4


@pytest.mark.parametrize("kind", ["dpt", "unet"])
def test_predictor_stages_compose_to_its_forward(kind):
    """``Predictor.stages`` (what the route captures as CUDA graphs on a
    card) run in turn give ``forward``: DPT's three named stages, another
    net whole under no name; the cast and the output convention folded in."""
    from omnidata_tpu_torch.models.unet import UNet

    net = _net(SMALL) if kind == "dpt" else UNet(out_channels=3).eval()
    if kind == "unet":
        init_weights(net, torch.Generator().manual_seed(0))
    model = Predictor(net, kind == "dpt", torch.float32).eval()
    x = _normalised(_images(2, 64))
    with torch.no_grad():
        want = model(x)
        out = (x,)
        for _, fn in model.stages():
            out = fn(*out)
    assert [n for n, _ in model.stages()] == (list(DPT_SPANS) if kind == "dpt" else [None])
    assert len(out) == 1 and torch.equal(out[0], want)


def test_resized_position_embedding_is_kept_only_without_grad():
    net = _net(SMALL)
    with torch.no_grad():
        a = net._pos_embed(4, 4)
        assert net._pos_embed(4, 4) is a  # no copy to the device to capture
        net.pretrained.model.pos_embed.add_(1.0)  # a new version: recomputed
        b = net._pos_embed(4, 4)
    assert b is not a and torch.allclose(b, a + 1.0, atol=1e-5)
    c = net._pos_embed(4, 4)
    assert c.requires_grad and c is not b


def test_demo_batches_in_float32_and_bfloat16(tmp_path):
    src = tmp_path / "photos"
    src.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        save_png(str(src / f"p{i}.png"), rng.randint(0, 256, (48, 72, 3)).astype(np.uint8))
    runs = {}
    for name, extra in (("one", []), ("two", ["--batch_size", "2"]),
                        ("bf16", ["--batch_size", "2", "--dtype", "bfloat16"])):
        out = tmp_path / name
        tdemo.main(["--task", "depth", "--img_path", str(src), "--output_path", str(out),
                    "--image_size", "64", "--device", "cpu", *extra])
        runs[name] = out
    for i in range(3):
        for name in runs:
            assert load_png(str(runs[name] / f"p{i}_depth.png")).shape == (512, 512, 4)
        np.testing.assert_array_equal(load_png(str(runs["one"] / f"p{i}_rgb.png")),
                                      load_png(str(runs["two"] / f"p{i}_rgb.png")))
        a = load_png(str(runs["one"] / f"p{i}_depth.png"))
        b = load_png(str(runs["two"] / f"p{i}_depth.png"))
        assert (a == b).all(-1).mean() >= 0.999


@pytest.mark.parametrize("cfg,kw,size", [(CFG, {}, 64), (SMALL_CFG, SMALL, 64),
                                         (SMALL_CFG, SMALL, 96)],
                         ids=["published-64", "small-64", "small-96"])
def test_dpt_work_equals_model_flops(cfg, kw, size):
    net = DPTHybrid(**kw).eval()
    assert dpt_work.image_flops(cfg, size) == model_flops(net, torch.zeros(1, 3, size, size))


def test_dpt_work_at_384_is_255_23_gflop():
    assert round(dpt_work.image_flops(CFG, 384) / 1e7) == 25523
