"""The DPT cell on the CPU at a tiny size (64^2, two images a batch, a pool
of three batches; the published widths): sound, it is correct; with the
reference's operands rounded to float8 e4m3 in the program's place (the
control), or with the timed path broken underneath, ``correct`` comes out
false. The reference's copy is the repository's, byte for byte, and the
cell's files load no JAX."""
import time
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from benchmark import run as harness
from benchmark.gen import dpt_weights
from benchmark.metrics import dpt_mfu

from test_bench_imports import top_level

ROOT = Path(__file__).resolve().parents[2]
CELL = "dpt.infer-bf16-b8"
SCALE = {"traffic": {"image_size": 64, "views_per_batch": 2, "pool_batches": 3,
                     "warm_s": 0.5, "sample_views": 2}}


@pytest.fixture(autouse=True)
def weights_in_tmp(tmp_path_factory, monkeypatch):
    """The 490 MB of seeded weights go to a temporary cache, not the
    checkout's."""
    monkeypatch.setattr(dpt_weights, "CACHE", tmp_path_factory.getbasetemp() / "dpt-cache")


def run_cell(control=None, device="cpu", seconds=4.0):
    torch.set_num_threads(2)
    args = Namespace(workload=CELL, seed=2**31 + 29, seconds=seconds, trace=0,
                     control=control, scale=SCALE, t0=time.perf_counter())
    return harness.run(args, device=device)


def test_sound_run_is_correct():
    r = run_cell()
    assert r["correct"], r["checks"]
    assert r["checks"]["views_compared"]["value"] == 2
    assert r["checks"]["nonzero_share"]["value"] > 0.5
    assert set(r["metrics"]) == {"views_per_s", "setup_s"}
    assert r["metrics"]["views_per_s"]["value"] > 0


def test_control_in_e4m3_is_not_correct():
    r = run_cell(control="float8_e4m3fn")
    assert not r["correct"]
    assert r["checks"]["depth_rel_l2"]["value"] > r["checks"]["depth_rel_l2"]["limit"]


def _stale(real):
    first = []

    def forward(self, x):  # a forward pass that returns its first answer again
        if not first:
            first.append(real(self, x))
        return first[0].clone()
    return forward


def _half(real):
    def forward(self, x):  # half of the batch left out
        return real(self, x)[: x.shape[0] // 2]
    return forward


def _altered(real):
    def forward(self, x):  # an answer altered where it is produced
        return real(self, x) * 0.9
    return forward


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["stale", "half", "altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from omnidata_tpu_torch.models import registry

    monkeypatch.setattr(registry.Predictor, "forward", fault(registry.Predictor.forward))
    r = run_cell()
    assert not r["correct"], r["checks"]


def test_reference_copy_is_the_repositorys():
    assert (ROOT / "benchmark" / "reference" / "dpt.py").read_bytes() == \
        (ROOT / "tools" / "dpt_reference.py").read_bytes()


def test_cell_files_load_no_jax():
    mods = top_level("benchmark.drivers.dpt", "benchmark.dpt_work", "benchmark.metrics.dpt_mfu")
    assert not mods & {"jax", "jaxlib", "flax", "omnidata_tpu"}
    mods = top_level("benchmark.reference.dpt", "benchmark.gen.dpt_weights",
                     "benchmark.dpt_work")
    assert not mods & {"jax", "jaxlib", "flax", "omnidata_tpu", "omnidata_tpu_torch"}


def test_mfu_counts_the_windows_images_at_the_bf16_peak():
    work = {0: {"flops": 8 * 255.23e9}, 1: {"flops": 8 * 255.23e9}}
    rec = {"work": work, "completed_pool_idx": [0, 1, 0], "seconds": 2.0}
    assert dpt_mfu.read(rec) == pytest.approx(100 * 3 * 8 * 255.23e9 / (2.0 * 989e12))
    assert dpt_mfu.read({**rec, "work": None}) is None


@pytest.mark.cuda
def test_tiny_run_on_the_card(card):
    r = run_cell(device="cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
