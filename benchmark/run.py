"""The port's benchmark: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository on a machine with an
NVIDIA GPU. The cell names a configuration (``benchmark/configs/<name>.json``)
and a traffic mix (``benchmark/traffic/<name>.json``) in ``BENCHMARK.json``;
the traffic names its driver (``benchmark/drivers/<name>.py``), and each
metric is read by ``benchmark/metrics/<name>.py``. Set-up (imports, the
scene, the program's mesh and bake, one warm pass) is timed as ``setup_s``;
then the window runs for ``--seconds``; then the program's state is freed
and a seeded sample of what the window produced is compared with the plain
reference (``benchmark/reference``) under the limits of
``benchmark/limits/<cell>.json``.

With ``--trace 0`` the last line of standard output is the result with the
cell's end-to-end metrics; with ``--trace 1`` the window profiles a stretch
of a few seconds and the result carries the per-layer metrics, the device's
busy seconds and a breakdown. The numbers compared and their limits end
standard error and the result line. ``--control <dtype>`` puts the
reference, computed in that lower precision, in the program's place for the
comparison (a check of the comparison, not a measurement).

Exits non-zero with no result when there is no CUDA device (or fewer than
the cell asks for), when the port cannot be imported, or when JAX or the
JAX package has been loaded by the time the window closes.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "cache"
BANNED = ("jax", "jaxlib", "flax", "omnidata_tpu")


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_cell(name: str):
    """-> (BENCHMARK.json, workload entry, configuration, traffic)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return spec, w, config, traffic


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end untraced, per-layer traced."""
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def loaded_banned() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run(args, device: str = "cuda") -> dict:
    """One run of a cell -> the result (correct, attempted, failed,
    metrics, device[, breakdown], checks). device 'cpu' is for tests."""
    spec, w, config, traffic = load_cell(args.workload)
    import torch

    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            fail("no CUDA device is available")
        if torch.cuda.device_count() < int(w["chips"]):
            fail(f"{args.workload} needs {w['chips']} CUDA devices, "
                 f"{torch.cuda.device_count()} present")
    try:
        importlib.import_module("omnidata_tpu_torch")
    except ImportError as e:
        fail(f"the port omnidata_tpu_torch cannot be imported: {e}")
    scale = getattr(args, "scale", None) or {}
    config = {**config, "scene": {**config["scene"], **scale.get("scene", {})},
              "annotator": {**config["annotator"], **scale.get("annotator", {})}}
    traffic = {**traffic, **scale.get("traffic", {})}
    limits = json.loads((BENCH / "limits" / f"{args.workload}.json").read_text())
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    metrics = cell_metrics(spec, args.workload, bool(args.trace))
    readers = {m["name"]: importlib.import_module(f"benchmark.metrics.{m['name']}")
               for m in metrics}

    dev = torch.device(device, 0) if on_card else torch.device(device)
    cell = driver.Cell(config, traffic, args.seed, dev)
    t_warm = time.perf_counter()
    cell.run(float(traffic["warm_s"]), window=False)
    if on_card:
        torch.cuda.synchronize()
        if args.trace:  # the profiler's first start is slow: not in the window
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.zeros(1, device=dev).add_(1)
                torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - getattr(args, "t0", T0)
    cell.setup_parts["warm_s"] = time.perf_counter() - t_warm

    tracer = None
    if args.trace:
        from .trace import Stretch

        tracer = Stretch(float(traffic["trace_delay_s"]), float(traffic["trace_stretch_s"]))
    rec = cell.run(float(args.seconds), tracer=tracer)
    rec["setup_s"] = setup_s
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else 0
    banned = loaded_banned()
    if banned:
        fail(f"modules of {banned} were loaded by the time the window closed", 3)

    rec["trace"] = tracer.read() if tracer is not None else None
    rec["stages"] = {}
    if args.trace:
        for name, mod in readers.items():
            if hasattr(mod, "measure") and on_card:
                rec["stages"][name] = mod.measure(cell, torch)
        idx = rec["completed_pool_idx"] + (rec["trace"] or {}).get("pool_idx", [])
        rec["work"] = cell.work(idx)
    info = {"card": card() if on_card else "cpu",
            "launches_per_batch": rec["launches_per_batch"],
            "batches_pulled": rec["batches_pulled"], "setup_parts": cell.setup_parts,
            **cell.rows_past_stage_cap()}
    print(f"benchmark: {json.dumps(info)}", file=sys.stderr, flush=True)

    cell.release()
    t_check = time.perf_counter()
    checks = cell.check(limits, int(traffic["sample_views"]),
                        getattr(args, "control", None))
    print(f"benchmark: comparison {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    correct = all(ok for _, _, _, ok in checks)
    out = {}
    for m in metrics:
        value = readers[m["name"]].read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": int(w["chips"]) if on_card else 1,
                   "memory_peak_bytes": int(rec["peak_bytes"])}
    result = {"correct": correct,
              "attempted": int(rec["views_done"] + cell.malformed * cell.K),
              "failed": int(cell.malformed * cell.K) + (0 if correct else 1),
              "metrics": out, "device": device_info}
    if rec["trace"] is not None:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["stretch_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in checks}
    for name, v, lim, ok in checks:
        print(f"check {name}: {v} limit {lim} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="compare the reference in this torch dtype in the "
                    "program's place (bfloat16): the comparison must fail")
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    result = run(args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):  # run as a script: import as the package
        sys.path[0] = str(ROOT)  # not benchmark/: its modules are not top level
        from benchmark.run import main as _main

        sys.exit(_main())
    sys.exit(main())
