"""Experiment logging backend — the stand-in for paper_code's wandb setup
(reference paper_code/train_depth.py:12-14 `wandb.init(...)`), the
port's copy of the JAX package's ``utils/experiment.py``.

Always writes a JSONL scalar stream + a one-shot config snapshot under the
run directory (greppable, survives any environment); if `wandb` is
importable AND the caller asks for it (backend='wandb' or 'auto' with
WANDB_PROJECT set), scalars are mirrored there too. Only rank 0 of an
initialised ``torch.distributed`` group writes (Lightning's rank-zero
logging semantics).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class ExperimentLogger:
    def __init__(self, run_dir: str, config: Mapping[str, Any] | None = None,
                 backend: str = "auto", name: str | None = None):
        self._primary = _rank() == 0
        self.run_dir = run_dir
        self._wandb = None
        self._fh = None
        if not self._primary:
            return
        os.makedirs(run_dir, exist_ok=True)
        if config is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(dict(config), f, indent=2, default=str)
        self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if backend == "wandb" or (backend == "auto" and os.environ.get("WANDB_PROJECT")):
            try:
                import wandb  # optional; not in the base image

                self._wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "omnidata-tpu"),
                    name=name, config=None if config is None else dict(config),
                    dir=run_dir,
                )
            except Exception:
                self._wandb = None  # jsonl stream is the source of truth

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        if not self._primary:
            return
        rec = {"step": int(step), "ts": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(dict(scalars), step=int(step))

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
