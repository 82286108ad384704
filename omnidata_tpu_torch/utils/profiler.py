"""Step profiler: a context manager that logs
'"{name}:{step}: {secs} seconds"' per step and the total on exit."""
from __future__ import annotations

import logging
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
