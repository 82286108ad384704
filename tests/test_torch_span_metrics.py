"""The benchmark's readers of the program's spans and counters
(``benchmark/metrics/<name>.py`` over ``utils.profiler.summary``): each
reads its number from a fabricated summary, gives None where the span or
counter is missing or the program has no recorder, and its
``BENCHMARK.json`` entry names a layer the benchmark already had."""
import importlib
import json
from pathlib import Path

import pytest

from omnidata_tpu_torch.utils import profiler

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

SUMMARY = {
    "spans": {
        "raster.prepare": {"count": 4, "batches": [0, 1, 2, 3], "parents": [""],
                           "host_ms": 1.5, "device_ms": 88.25},
        "raster.render": {"count": 4, "batches": [0, 1, 2, 3], "parents": [""],
                          "host_ms": 2.0, "device_ms": 110.5},
        "annotate.labels": {"count": 4, "batches": [0, 1, 2, 3], "parents": [""],
                            "host_ms": 3.0, "device_ms": 40.0},
        "cues.keypoints2d": {"count": 4, "batches": [0, 1, 2, 3],
                             "parents": ["annotate.labels"], "host_ms": 0.5,
                             "device_ms": 15.25},
        "pipeline.fetch": {"count": 4, "batches": [0, 1, 2, 3], "parents": [""],
                           "host_ms": 9.0, "device_ms": 4.5},
        "pipeline.wait": {"count": 3, "batches": [0, 1, 2], "parents": [""],
                          "host_ms": 6.75, "device_ms": None},
        "predict.upload": {"count": 4, "batches": [0, 1, 2, 3], "parents": [""],
                           "host_ms": 0.5, "device_ms": 0.375},
        "dpt.backbone": {"count": 4, "batches": [0, 1, 2, 3],
                         "parents": ["predict.model"], "host_ms": 2.5, "device_ms": 7.25},
        "dpt.encoder": {"count": 4, "batches": [0, 1, 2, 3],
                        "parents": ["predict.model"], "host_ms": 1.5, "device_ms": 6.5},
        "dpt.decoder": {"count": 4, "batches": [0, 1, 2, 3],
                        "parents": ["predict.model"], "host_ms": 2.0, "device_ms": 11.75},
    },
    "counters": {
        "raster.rows": {"total": 32768, "batches": [0, 1, 2, 3]},
        "raster.rows_block": {"total": 1024, "batches": [0, 1, 2, 3]},
        "raster.rows_scan_all": {"total": 2048, "batches": [0, 1, 2, 3]},
        "raster.rows_fused": {"total": 32768, "batches": [0, 1, 2, 3]},
        "raster.rows_past_stage_cap": {"total": 1000, "batches": [0, 1, 2, 3]},
        "fetch.bytes": {"total": 4000, "batches": [0, 1, 2, 3]},
        "fetch.pinned_alloc_bytes": {"total": 1000, "batches": [0, 1, 2, 3]},
    },
    "dropped": 0,
}

# metric -> (value from SUMMARY, the span or counter whose absence silences it)
WANT = {
    "prepare_span_ms": (88.25, ("spans", "raster.prepare")),
    "render_span_ms": (110.5, ("spans", "raster.render")),
    "cues_span_ms": (40.0, ("spans", "annotate.labels")),
    "keypoints2d_span_ms": (15.25, ("spans", "cues.keypoints2d")),
    "fetch_span_ms": (4.5, ("spans", "pipeline.fetch")),
    "fetch_wait_ms": (6.75, ("spans", "pipeline.wait")),
    "rows_over_ccap_pct": (100.0 * 3072 / 32768, ("counters", "raster.rows_scan_all")),
    "rows_past_stage_cap_pct": (100.0 * 1000 / 32768,
                                ("counters", "raster.rows_past_stage_cap")),
    "pinned_alloc_pct": (25.0, ("counters", "fetch.pinned_alloc_bytes")),
    "rows_fused_pct": (100.0, ("counters", "raster.rows_fused")),
}
# the DPT cell's readers (metric -> value, span), each a layer of its own
DPT_WANT = {
    "predict_upload_span_ms": (0.375, ("spans", "predict.upload")),
    "dpt_backbone_span_ms": (7.25, ("spans", "dpt.backbone")),
    "dpt_encoder_span_ms": (6.5, ("spans", "dpt.encoder")),
    "dpt_decoder_span_ms": (11.75, ("spans", "dpt.decoder")),
}
READERS = {**WANT, **DPT_WANT}
LAYERS = {
    "prepare_span_ms": "Admission (mesh.raster.prepare_raster)",
    "rows_over_ccap_pct": "Admission (mesh.raster.prepare_raster)",
    "rows_fused_pct": "Admission (mesh.raster.prepare_raster)",
    "render_span_ms": "Raster kernels (mesh.raster_kernels, csrc)",
    "rows_past_stage_cap_pct": "Raster kernels (mesh.raster_kernels, csrc)",
    "cues_span_ms": "Cue stack (annotator.pipeline, cues)",
    "keypoints2d_span_ms": "Cue stack (annotator.pipeline, cues)",
    "fetch_span_ms": "CLI pipeline and fetch (annotator.cli.render_batches)",
    "fetch_wait_ms": "CLI pipeline and fetch (annotator.cli.render_batches)",
    "pinned_alloc_pct": "CLI pipeline and fetch (annotator.cli.render_batches)",
}


def _reader(name):
    return importlib.import_module(f"benchmark.metrics.{name}")


def _measured(mod, name):
    return mod.read({"stages": {name: mod.measure(None, None)}})


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_summary(name, monkeypatch):
    mod = _reader(name)
    monkeypatch.setattr(profiler, "summary", lambda: SUMMARY)
    assert _measured(mod, name) == pytest.approx(READERS[name][0], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_without_its_span_or_counter(name, monkeypatch):
    mod = _reader(name)
    kind, key = READERS[name][1]
    cut = {**SUMMARY, kind: {k: v for k, v in SUMMARY[kind].items() if k != key}}
    monkeypatch.setattr(profiler, "summary", lambda: cut)
    assert _measured(mod, name) is None
    monkeypatch.setattr(profiler, "summary", lambda: {"spans": {}, "counters": {}})
    assert _measured(mod, name) is None
    monkeypatch.delattr(profiler, "summary")  # a program without the recorder
    assert _measured(mod, name) is None
    assert mod.read({"stages": {}}) is None


def test_a_zero_denominator_reads_none(monkeypatch):
    zero = {**SUMMARY, "counters": {k: {**v, "total": 0}
                                    for k, v in SUMMARY["counters"].items()}}
    monkeypatch.setattr(profiler, "summary", lambda: zero)
    for name in ("rows_over_ccap_pct", "rows_past_stage_cap_pct", "pinned_alloc_pct",
                 "rows_fused_pct"):
        assert _measured(_reader(name), name) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_entry_names_an_existing_layer_and_file(name):
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    m = entries[name]
    older = {e["layer"] for e in SPEC["per_layer"] if e["name"] not in WANT}
    assert m["layer"] == LAYERS[name] and m["layer"] in older
    assert (ROOT / "benchmark" / "metrics" / f"{name}.py").is_file()
    assert m["moves"] == "views_per_s" and m["workloads"] == ["xl.annotate10"]
    assert m["better"] == ("higher" if name == "rows_fused_pct" else "lower")
    assert m["source"] == ("program_counter" if name.endswith("_pct") else "program_span")
    assert m["unit"] == ("%" if name.endswith("_pct") else "ms")
    assert callable(_reader(name).measure) and callable(_reader(name).read)


def test_new_entries_come_last():
    """The annotate cell's span and counter metrics follow its older ones;
    only entries of later cells come after them."""
    names = [m["name"] for m in SPEC["per_layer"]]
    first = min(names.index(n) for n in WANT)
    assert set(names[first:first + len(WANT)]) == set(WANT)
    later = SPEC["per_layer"][first + len(WANT):]
    assert all("xl.annotate10" not in m["workloads"] for m in later)


@pytest.mark.parametrize("name", sorted(DPT_WANT) + ["dpt_mfu"])
def test_dpt_entries_list_only_the_dpt_cell(name):
    m = {e["name"]: e for e in SPEC["per_layer"]}[name]
    assert m["moves"] == "views_per_s" and m["workloads"] == ["dpt.infer-bf16-b8"]
    assert (ROOT / "benchmark" / "metrics" / f"{name}.py").is_file()
    if name == "dpt_mfu":
        assert (m["source"], m["unit"], m["better"]) == ("host_clock", "%", "higher")
    else:
        assert (m["source"], m["unit"], m["better"]) == ("program_span", "ms", "lower")
        assert callable(_reader(name).measure)
