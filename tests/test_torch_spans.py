"""The port's span and counter recorder (``omnidata_tpu_torch.utils.profiler``)
on the CLI's batched pipeline (``annotator.cli.render_batches``) on the CPU:

- with no profiler recording, nothing is kept, ``span`` hands out the
  shared no-op, and no CUDA event, ``record_function`` or counted value is
  made;
- under ``torch.profiler`` every stage span is recorded once per batch
  under that batch's id, ``pipeline.fetch`` too, though it runs in the
  fetch thread where the profiler's own flag is off; ``cues.keypoints2d``
  nests in ``annotate.labels``; the chrome trace holds the spans as
  ``user_annotation`` events; the labels equal those of an untraced run;
- the admission counters equal a direct count over ``prepare_raster``'s
  ``counts``; the buffer bound drops and counts the oldest spans;
  ``DeviceTrace`` writes ``spans.json`` beside ``trace.json``.
"""
import json
import threading

import numpy as np
import pytest
import torch

from omnidata_tpu_torch.annotator import cli
from omnidata_tpu_torch.core.cameras import Camera, look_at_rotation
from omnidata_tpu_torch.mesh import from_arrays, raster, room, uv_sphere
from omnidata_tpu_torch.utils import DeviceTrace, profiler

torch.set_num_threads(1)

RES = 64
K = 2
MODS = ("depth_zbuffer", "normal", "rgb", "keypoints2d")
KW = dict(tile=32, chunk=64, modalities=MODS, keypoint_blur_sigma=0.0)
NO_PREFIXES = {"narf": False, "seg2d": False, "seg25d": False}
MAIN_SPANS = ("raster.prepare", "raster.render", "annotate.labels",
              "cues.keypoints2d", "pipeline.wait")
SPANS = MAIN_SPANS + ("pipeline.fetch",)


@pytest.fixture(scope="module")
def scene():
    r = room(size=6.0, height=3.0)
    s = uv_sphere(radius=0.7, center=(0.6, 0.1, 1.2), n_lat=16, n_lon=32)
    vs = np.concatenate([r.vertices.numpy(), s.vertices.numpy()])
    fs = np.concatenate([r.faces[: r.num_faces].numpy(),
                         s.faces[: s.num_faces].numpy() + r.vertices.shape[0]])
    mesh = from_arrays(vs, fs, vertex_colors=np.random.RandomState(0).rand(len(vs), 3))
    locs = torch.tensor([[1.1, 0.5, 1.4], [-0.8, 0.9, 1.6], [0.2, -1.0, 1.5],
                         [-1.5, -0.4, 1.2]])
    tgts = torch.tensor([[0.3, 0.0, 1.0], [0.5, -0.3, 0.8], [0.6, 0.1, 1.2],
                         [1.0, 1.0, 1.0]])
    Rs = look_at_rotation(locs, tgts)
    fovs = torch.tensor([1.2, 1.0, 0.9, 1.3])
    batches = [Camera(locs[b:b + K], Rs[b:b + K], fovs[b:b + K], RES)
               for b in range(0, len(locs), K)]
    return mesh, batches


@pytest.fixture(autouse=True)
def empty_recorder():
    profiler.reset()
    yield
    profiler.reset()


def _run(mesh, batches):
    return list(cli.render_batches(iter(batches), mesh, None, KW, MODS, None,
                                   NO_PREFIXES))


def test_off_records_nothing_and_makes_nothing(scene, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made while nothing records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiler, "count", refuse)
    assert not torch.autograd._profiler_enabled() and not profiler.recording()
    assert profiler.span("raster.prepare") is profiler.span("x", device=False)
    assert isinstance(profiler.span("x"), profiler._Off)
    out = _run(*scene)
    assert len(out) == 2
    assert profiler.records() == []
    got = profiler.summary()
    assert got["spans"] == {} and got["counters"] == {} and got["dropped"] == 0


def test_profiler_records_each_stage_once_a_batch(scene):
    mesh, batches = scene
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        traced = _run(mesh, batches)
    rec = profiler.records()
    got = profiler.summary()
    assert set(got["spans"]) == set(SPANS)
    ids = got["spans"]["raster.prepare"]["batches"]
    assert len(ids) == len(batches) and len(set(ids)) == len(batches)
    for name in SPANS:
        s = got["spans"][name]
        assert s["count"] == len(batches) and s["batches"] == ids, name
        assert s["host_ms"] > 0 and s["device_ms"] is None  # no CUDA here
    # every span of one batch carries that batch's id, in pull order
    for b, ident in enumerate(ids):
        names = [r[0] for r in rec if r[3] == ident]
        assert sorted(names) == sorted(SPANS), b
    assert ids == sorted(ids)
    assert got["spans"]["cues.keypoints2d"]["parents"] == ["annotate.labels"]
    assert got["spans"]["raster.prepare"]["parents"] == [""]
    main = threading.current_thread().name
    threads = {r[0]: r[1] for r in rec}
    assert threads["pipeline.fetch"] != main
    assert all(threads[n] == main for n in MAIN_SPANS)
    # counters
    T = (RES // KW["tile"]) ** 2
    c = got["counters"]
    assert c["raster.rows"] == {"total": len(batches) * K * T, "batches": ids}
    assert c["raster.rows_block"]["batches"] == ids
    want_bytes = sum(a.nbytes for labels, _ in traced for a in labels.values())
    assert c["fetch.bytes"] == {"total": want_bytes, "batches": ids}
    assert "raster.rows_past_stage_cap" not in c  # kernel C's count: a card's
    # the main thread's spans reach the chrome trace
    names = {e.name for e in p.events() if e.name in SPANS}
    assert set(MAIN_SPANS) <= names
    # labels as without the profiler
    plain = _run(mesh, batches)
    for (labels, _), (want, _) in zip(traced, plain):
        assert set(labels) == set(MODS)
        for m in MODS:
            np.testing.assert_array_equal(labels[m], want[m])


def test_chrome_trace_holds_user_annotations(scene, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        _run(*scene)
    p.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(MAIN_SPANS) <= names


def test_device_trace_writes_spans_json(scene, tmp_path):
    with DeviceTrace(str(tmp_path / "tr")):
        assert profiler.recording()
        _run(*scene)
    assert not profiler.recording()
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert set(spans["spans"]) == set(SPANS)
    assert all(s["count"] == 2 for s in spans["spans"].values())
    assert spans["counters"]["raster.rows"]["total"] == 2 * K * 4
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(MAIN_SPANS) <= names
    try:
        from torch._C._profiler import _ExperimentalConfig

        _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return
    assert "pipeline.fetch" in names  # the fetch thread's span, all threads traced


def test_device_trace_resets_on_entry(scene, tmp_path):
    with DeviceTrace(str(tmp_path / "a")):
        with profiler.span("leftover"):
            pass
    with DeviceTrace(str(tmp_path / "b")):
        pass
    assert json.loads((tmp_path / "b" / "spans.json").read_text())["spans"] == {}


@pytest.mark.parametrize("ccap", [4, 1])
def test_row_counters_equal_a_direct_count(scene, ccap):
    """Chunks of 16 faces (64 of them) in buffers of list_slots(ccap, 64)
    slots a row (4 and 2): the longer rows past the buffer scan every chunk;
    no row is in block mode and none was admitted by a kernel."""
    mesh, batches = scene
    cams = Camera(torch.cat([b.location for b in batches]),
                  torch.cat([b.R for b in batches]),
                  torch.cat([b.fov for b in batches]), RES)
    args = (cams, mesh, 16, 16, None, ccap)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        inp = raster.prepare_raster(*args)
    c = profiler.summary()["counters"]
    counts = raster.prepare_raster(*args).counts
    assert torch.equal(inp.counts, counts)
    want = {"raster.rows": counts.numel(), "raster.rows_fused": 0,  # no kernel
            "raster.rows_block": 0,
            "raster.rows_scan_all": int((counts == -1).sum())}
    assert {k: v["total"] for k, v in c.items()} == want
    assert want["raster.rows_scan_all"] > 0


def test_buffer_bound_drops_and_counts_the_oldest():
    rec = profiler.Recorder(max_spans=4)
    rec.hold(True)
    for i in range(6):
        with rec.span(f"s{i}"):
            pass
    rec.hold(False)
    assert [r[0] for r in rec.records()] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped == 2 and rec.summary()["dropped"] == 2
    with rec.span("off"):
        pass
    assert len(rec.records()) == 4
    rec.reset()
    assert rec.records() == [] and rec.dropped == 0


def test_counts_sum_ints_and_tensors_per_batch():
    rec = profiler.Recorder()
    with rec.in_batch(profiler.Batch(7, True)):
        rec.count("n", 3)
        rec.count("n", torch.tensor(4))
        with rec.span("outer"):
            with rec.span("inner"):
                pass
    rec.count("n", 100)  # nothing records outside the batch
    got = rec.summary()
    assert got["counters"] == {"n": {"total": 7, "batches": [7]}}
    assert got["spans"]["inner"]["parents"] == ["outer"]
    assert got["spans"]["outer"]["batches"] == [7]


def test_a_batch_begun_while_recording_records_in_other_threads():
    rec = profiler.Recorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = rec.new_batch()
    off = rec.new_batch()
    assert on.on and not off.on and off.ident == on.ident + 1

    def work():
        with rec.span("w"):
            pass
        return rec.recording()

    seen = []
    for b in (on, off):
        t = threading.Thread(target=lambda b=b: seen.append(rec.call_in_batch(b, work)))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == [True, False]
    assert [r[3] for r in rec.records()] == [on.ident]
