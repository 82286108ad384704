"""Step profiler: a context manager that logs
'"{name}:{step}: {secs} seconds"' per step and the total on exit; and a
device trace context."""
from __future__ import annotations

import logging
import os
import time


class Profiler:
    def __init__(self, name: str = "", logger: logging.Logger | None = None,
                 level=logging.INFO):
        self.name = name
        self.logger = logger
        self.level = level
        self.step_start = None
        self.start = None

    def _log(self, msg: str):
        if self.logger:
            self.logger.log(self.level, msg)
        else:
            print(msg)

    def __enter__(self):
        self.start = self.step_start = time.time()
        return self

    def step(self, name: str = ""):
        now = time.time()
        self._log(f"{self.name}:{name}: {now - self.step_start:.3f} seconds")
        self.step_start = now

    def __exit__(self, *exc):
        self._log(f"{self.name}: total {time.time() - self.start:.3f} seconds")
        return False


class DeviceTrace:
    """``torch.profiler`` trace of the host and, when a card is present, the
    CUDA device, written on exit as ``<logdir>/trace.json`` (Chrome trace
    format; chrome://tracing or Perfetto open it). The counterpart of the
    JAX package's ``jax.profiler`` trace context."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        return False
