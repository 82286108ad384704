"""omnidata_tpu_torch.train.multihost and the sharded trainers against the
JAX package's multihost tests (tests/test_train.py:444-509) and against
the port's one-process trainer, on the CPU: worker processes started as
torchrun starts them (tests/_torch_dist_worker.py) join a gloo group.

Driver: ``train_depth`` with the tiny DPT (JAX's dryrun_multichip config)
on the mini scene the JAX CLI annotates, 2 steps of global batch 4 at 64²,
at world 2 (data_parallel 2: 2 images a rank) and world 1. Tolerances as
tests/test_torch_parallel.py's against one process: every parameter
within 2 lr a step plus the rounding of p + u, the moves within 1% in L2;
the Adam moments' count and the step equal. At world 2, with
data_parallel 2 and with model_parallel 2, a run of 1 step resumed to 2
(``--resume``) leaves the 'last' of the uninterrupted 2-step run bit for
bit: parameters, moments (through the qkv permutation when
model-sharded), step and the run's place in its plan and draws. A world-2
checkpoint resumed at world 1 continues from its step.
"""
import functools
import io
import os
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

from omnidata_tpu.train.multihost import stripe as j_stripe
from omnidata_tpu_torch import train_depth as t_train_depth
from omnidata_tpu_torch.models import DPTHybrid
from omnidata_tpu_torch.train import multihost
from omnidata_tpu_torch.train.checkpoints import load_tree
from omnidata_tpu_torch.train.parallel import make_mesh

from torch.distributed.tensor import Replicate, Shard

import _torch_dist_worker as W
from _torch_port_util import jax_mini_scene

torch.set_num_threads(1)

LOSS_RTOL, MOVE_RTOL = 1e-5, 0.01
LR = 1e-5
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


# ---------------- one process ----------------

def test_stripe_partition_equals_jax():
    """tests/test_train.py:444: disjoint, covering, order-stable; the same
    slices as JAX's stripe."""
    items = list(range(23))
    parts = [multihost.stripe(items, process_index=i, process_count=4) for i in range(4)]
    assert sorted(x for p in parts for x in p) == items
    assert all(len(set(p)) == len(p) for p in parts)
    assert parts == [j_stripe(items, process_index=i, process_count=4) for i in range(4)]
    assert multihost.stripe(items) == items  # one process: everything
    with pytest.raises(ValueError):
        multihost.stripe(items, process_index=4, process_count=4)


@pytest.mark.parametrize("env", [
    {}, {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500"},
    {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": "29500",
     "LOCAL_RANK": "0"},
    {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}],
    ids=["none", "address_only", "world_1", "no_address"])
def test_initialize_is_a_noop_without_a_group(monkeypatch, env):
    """tests/test_train.py:486,492: nothing configured, stray variables, or
    torchrun's variables at world size 1 start no process group."""
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.initialize("cpu") is False
    assert not torch.distributed.is_initialized()
    assert (multihost.rank(), multihost.world_size(), multihost.local_rank()) == (0, 1, 0)


def test_single_process_batch_barrier_and_split():
    """tests/test_train.py:456: one process's local batch is the global
    batch; barrier is a no-op; one process takes the whole batch."""
    batch = {"rgb": torch.arange(8 * 3 * 4 * 4, dtype=torch.float32).reshape(8, 3, 4, 4),
             "mask": torch.ones((8, 1, 4, 4))}
    assert multihost.local_batch_to_global(make_mesh(), batch) is batch
    multihost.barrier("test")
    assert multihost.process_local_batch_size(64) == 64
    assert multihost.process_local_batch_size(7) == 7


# ---------------- two processes ----------------

def test_multihost_at_world_2(tmp_path):
    """tests/test_train.py:509 (its two-process run) on the port: torchrun's
    variables start a gloo group; stripe follows the rank; a global batch
    splits evenly or raises; the two ranks' batch shards are one global
    DTensor split over 'data'."""
    ranks = W.launch("multihost", 2, {}, tmp_path / "mh.pt")
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in ranks)
    assert [r["stripe"] for r in ranks] == [j_stripe(list(range(7)), i, 2) for i in (0, 1)]
    assert all(r["local_batch"] == 4 and r["uneven"] == "ValueError" for r in ranks)
    want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100 * r
                      for r in (0, 1)])
    for r in ranks:
        assert r["global_shape"] == (4, 3)
        assert torch.equal(r["global_rgb"], want)
        assert r["placements"] == [str(Shard(0)), str(Replicate())]


# ---------------- the sharded trainer ----------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jax_mini_scene(str(tmp_path_factory.mktemp("scene")),
                          tasks=("rgb", "depth_zbuffer", "mask_valid"))


def _config(tmp_path, scene, ckpt, **kw) -> str:
    cfg = {"image_size": 64, "batch_size": 4, "lr": LR, "max_steps": 2, "log_step": 1,
           "val_step": 2, "ckpt_step": 100, "save_top_k": 2, "val_fraction": 0.4,
           "num_workers": 2, "checkpoint_dir": str(ckpt), "data_paths": {"scene": scene},
           **kw}
    path = str(tmp_path / f"{ckpt.name}.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _run_world_1(monkeypatch, argv) -> str:
    monkeypatch.setattr(t_train_depth, "DPTHybrid", functools.partial(DPTHybrid, **W.TINY_DPT))
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_train_depth.main(argv + ["--device", "cpu"])
    return buf.getvalue()


def _losses(out: str) -> list:
    import ast

    return [ast.literal_eval(line.split(": ", 1)[1].rsplit(" (", 1)[0])["loss"]
            for line in out.splitlines() if line.startswith("step ") and ": {" in line]


@pytest.fixture(scope="module")
def world_2_run(scene, tmp_path_factory):
    """train_depth at world 2 for 2 steps, and for 1 step then --resume to
    2, at data_parallel 2 and at model_parallel 2. -> ({(grid, "whole" |
    "resumed"): 'last'}, the data_parallel 2 run's checkpoint dir)."""
    d = tmp_path_factory.mktemp("world2")
    runs, keys = [], []
    for grid, kw in (("2x1", {"data_parallel": 2}),
                     ("1x2", {"data_parallel": 1, "model_parallel": 2})):
        whole, part = d / f"ck{grid}", d / f"ck{grid}_resumed"
        argv = ["--device", "cpu", "--config_file"]
        runs.append((argv + [_config(d, scene, whole, **kw)], str(whole)))
        path = _config(d, scene, part, **dict(kw, max_steps=1))
        runs.append((argv + [path], str(part)))
        runs.append((argv + [path, "--resume", "--max_steps", "2"], str(part)))
        keys += [(grid, "whole"), (grid, "first step"), (grid, "resumed")]
    lasts = W.launch("driver", 2, {"runs": runs}, d / "driver.pt")
    return dict(zip(keys, lasts)), d / "ck2x1"


def _assert_same_last(got, want):
    assert int(got["step"]) == int(want["step"]) == 2
    assert set(got) == set(want) and set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert torch.equal(got["opt_state"]["count"], want["opt_state"]["count"])
    for k in ("mu", "nu"):
        assert len(got["opt_state"][k]) == len(want["opt_state"][k])
        assert all(torch.equal(a, b) for a, b in zip(got["opt_state"][k], want["opt_state"][k]))
    assert got["run"]["plan_seed"] == want["run"]["plan_seed"] == 0
    assert torch.equal(got["run"]["rng"], want["run"]["rng"])


def test_train_depth_at_world_2_writes_the_world_1_last(scene, world_2_run, tmp_path,
                                                        monkeypatch):
    lasts, _ = world_2_run
    path = _config(tmp_path, scene, tmp_path / "ck1")
    out = _run_world_1(monkeypatch, ["--config_file", path])
    want = load_tree(str(tmp_path / "ck1" / "last"))
    got = lasts[("2x1", "whole")]
    assert int(got["step"]) == int(want["step"]) == 2
    assert int(got["opt_state"]["count"]) == int(want["opt_state"]["count"]) == 2
    assert set(got["params"]) == set(want["params"])
    start = DPTHybrid(num_channels=1, **W.TINY_DPT)
    from omnidata_tpu_torch.models.registry import init_weights

    init_weights(start, torch.Generator().manual_seed(0))
    start = start.state_dict()
    names = [k for k in want["params"] if not torch.equal(want["params"][k], start[k])]
    assert names
    for k in want["params"]:
        w, g = want["params"][k], got["params"][k]
        assert bool(((g - w).abs() <= 2 * 2 * LR + 2**-22 * w.abs()).all()), k
    d_got = torch.cat([(got["params"][k] - start[k]).flatten() for k in names])
    d_want = torch.cat([(want["params"][k] - start[k]).flatten() for k in names])
    assert float((d_got - d_want).norm() / d_want.norm()) <= MOVE_RTOL
    for k in ("mu", "nu"):
        assert len(got["opt_state"][k]) == len(want["opt_state"][k])
    assert len(_losses(out)) == 2 and all(np.isfinite(_losses(out)))
    assert os.path.exists(tmp_path / "ck1" / "scores.json")


def test_resume_at_world_2_is_bitwise(world_2_run):
    """data_parallel 2: 1 step, then --resume to 2, is the 2-step run."""
    lasts, _ = world_2_run
    assert int(lasts[("2x1", "first step")]["step"]) == 1
    _assert_same_last(lasts[("2x1", "resumed")], lasts[("2x1", "whole")])


def test_resume_at_model_parallel_2_is_bitwise(world_2_run):
    """model_parallel 2: the moments are gathered through the qkv
    permutation into 'last' and sharded again on --resume; 1 step, then
    --resume to 2, is the 2-step run."""
    lasts, _ = world_2_run
    assert int(lasts[("1x2", "first step")]["step"]) == 1
    _assert_same_last(lasts[("1x2", "resumed")], lasts[("1x2", "whole")])


def test_world_2_checkpoint_resumes_at_world_1(scene, world_2_run, tmp_path, monkeypatch):
    _, ckpt = world_2_run
    ck = tmp_path / "ck_resume"
    shutil.copytree(ckpt, ck, symlinks=True)
    path = _config(tmp_path, scene, ck, max_steps=3)  # data_parallel absent: world 1
    out = _run_world_1(monkeypatch, ["--config_file", path, "--resume"])
    assert "resumed from" in out and "at step 2" in out
    last = load_tree(str(ck / "last"))
    assert int(last["step"]) == 3 and int(last["opt_state"]["count"]) == 3
    assert np.isfinite(_losses(out)).all() and len(_losses(out)) == 1
