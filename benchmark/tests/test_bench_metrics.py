"""The end-to-end readers on synthetic records, and admission_ms's timing."""
import statistics
import time
from types import SimpleNamespace

import pytest

from benchmark.metrics import admission_ms, batch_p95_ms, views_per_s


def test_views_per_s_counts_every_view_over_the_whole_window():
    # 30 s window; a stall of 10 s in the middle still divides by 30
    rec = {"views_done": 32 * 40, "seconds": 30.0}
    assert views_per_s.read(rec) == 32 * 40 / 30.0


def test_batch_p95_is_over_all_batches_with_a_stall():
    lat = [0.1] * 95 + [2.0] * 5  # five batches caught in a stall
    rec = {"batch_latencies_s": lat}
    got = batch_p95_ms.read(rec)
    assert got == statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
    assert 100.0 < got <= 2000.0  # the stall shows in the tail
    rec = {"batch_latencies_s": [0.1] * 100}
    assert abs(batch_p95_ms.read(rec) - 100.0) < 1e-9


class _Event:
    """A host-clock stand-in for ``torch.cuda.Event`` on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


FAKE_TORCH = SimpleNamespace(cuda=SimpleNamespace(Event=_Event, synchronize=lambda: None))


@pytest.fixture(scope="module")
def tiny_cell():
    import torch

    from benchmark import run as harness
    from benchmark.drivers import annotate

    torch.set_num_threads(2)
    _, _, config, traffic = harness.load_cell("xl.annotate10")
    config = {**config, "scene": {**config["scene"], "spheres": 1, "boxes": 1,
                                  "sphere_lat": 8, "edge_m": 3.0},
              "annotator": {**config["annotator"], "resolution": 32, "views_per_batch": 2}}
    return annotate.Cell(config, {**traffic, "pool_batches": 3}, 5, "cpu")


def test_admission_is_timed_inside_the_windows_entry(tiny_cell, monkeypatch):
    from omnidata_tpu_torch.mesh import raster

    real = raster.prepare_raster
    calls = []
    monkeypatch.setattr(raster, "prepare_raster",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    patched = raster.prepare_raster
    got = admission_ms.measure(tiny_cell, FAKE_TORCH)
    assert got is not None and got > 0
    # a warm pass and three timed passes over the stage batches, one call each
    assert len(calls) == 4 * len(tiny_cell.stage_batches())
    assert raster.prepare_raster is patched  # the timer was taken off again


def test_admission_is_left_out_where_the_entry_makes_no_such_call(tiny_cell, monkeypatch):
    from omnidata_tpu_torch.annotator import pipeline

    monkeypatch.setattr(pipeline, "annotate_views", lambda *a, **k: {})
    assert admission_ms.measure(tiny_cell, FAKE_TORCH) is None
