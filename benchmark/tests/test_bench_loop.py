"""A whole run of the harness on the CPU at a tiny size (a 39,760-face
scene, 32^2, two views a batch, the port's plain CPU paths): sound, it is
correct; with the
reference in bfloat16 in the program's place (the control), or with the
timed path broken underneath, ``correct`` comes out false."""
import time
from argparse import Namespace

import pytest
import torch

from benchmark import run as harness

CELL = "xl.annotate10"
SCALE = {"scene": {"spheres": 4, "boxes": 5, "sphere_lat": 48, "edge_m": 0.8},
         "annotator": {"resolution": 32, "views_per_batch": 2},
         "traffic": {"pool_batches": 3, "warm_s": 0.5, "sample_views": 2}}


def run_cell(workload, control=None, device="cpu", seconds=6.0):
    torch.set_num_threads(2)
    args = Namespace(workload=workload, seed=2**31 + 11, seconds=seconds, trace=0,
                     control=control, scale=SCALE, t0=time.perf_counter())
    return harness.run(args, device=device)


def test_sound_run_is_correct():
    r = run_cell(CELL)
    assert r["correct"], r["checks"]
    assert r["checks"]["views_compared"]["value"] >= 1
    assert list(r)[-1] == "checks"
    assert r["metrics"]["views_per_s"]["value"] > 0


def test_control_in_bfloat16_is_not_correct():
    r = run_cell(CELL, control="bfloat16")
    assert not r["correct"]


def _stale(real):
    first = {}

    def fn(cams, *a, **k):  # a step that returns its state unchanged
        if not first:
            first.update(real(cams, *a, **k))
        return dict(first)
    return fn


def _half(real):
    def fn(cams, *a, **k):  # half of the batch left out
        out = real(cams, *a, **k)
        n = cams.location.shape[0] // 2
        return {m: x[:n] for m, x in out.items()}
    return fn


def _altered(real):
    def fn(cams, *a, **k):  # an answer altered where it is produced
        out = real(cams, *a, **k)
        out["depth_zbuffer"] = (out["depth_zbuffer"].to(torch.int32) - 7).clamp(
            min=0).to(torch.uint16)
        return out
    return fn


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["stale", "half", "altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from omnidata_tpu_torch.annotator import pipeline

    monkeypatch.setattr(pipeline, "annotate_views", fault(pipeline.annotate_views))
    r = run_cell(CELL)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_tiny_run_on_the_card(card):
    r = run_cell(CELL, device="cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
