"""What the benchmark loads: no JAX and no JAX package anywhere, and nothing
of the port in the reference. Module names are compared by their whole
top-level name (``omnidata_tpu_torch`` is not ``omnidata_tpu``)."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import importlib, json, sys
for m in sys.argv[1:]:
    importlib.import_module(m)
print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))
"""


def top_level(*modules):
    out = subprocess.run([sys.executable, "-c", PROBE, *modules], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout))


def test_harness_loads_no_jax():
    mods = top_level("benchmark.run", "benchmark.drivers.annotate", "benchmark.trace",
                     "benchmark.work", "benchmark.reference.views",
                     "omnidata_tpu_torch.annotator.cli",
                     "omnidata_tpu_torch.annotator.pipeline",
                     "omnidata_tpu_torch.cues.curvature",
                     *(f"benchmark.metrics.{p.stem}"
                       for p in (ROOT / "benchmark" / "metrics").glob("[a-z]*.py")))
    assert not mods & {"jax", "jaxlib", "flax", "omnidata_tpu"}
    assert "omnidata_tpu_torch" in mods


def test_reference_loads_nothing_of_the_port():
    mods = top_level("benchmark.reference.views", "benchmark.reference.render",
                     "benchmark.gen.scene", "benchmark.gen.cameras", "benchmark.work")
    assert not mods & {"jax", "jaxlib", "flax", "omnidata_tpu", "omnidata_tpu_torch"}


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    """Without CUDA (this host), and in a directory holding only
    BENCHMARK.json and the benchmark, the run exits non-zero and prints
    nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                              "xl.annotate10", "--seed", "1", "--seconds", "1",
                              "--trace", "0"], cwd=cwd, capture_output=True, text=True)
        assert out.returncode != 0 and out.stdout == ""
