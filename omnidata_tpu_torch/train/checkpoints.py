"""Checkpointing with the reference's ModelCheckpoint semantics
(train_normal.py:371-374: save_top_k on the monitored validation loss +
save_last), the port's counterpart of the JAX package's Orbax-backed
``train/checkpoints.py``, on ``torch.save``.

Layout, as the JAX package's: one directory per checkpoint under the run
directory — ``step_<N>`` for the top-k validated steps, ``last.<serial>``
for the rotating latest state with a ``last`` symlink to it — and
``scores.json`` ({"step_N": metric}). Each directory holds ``state.pt``.

Saves are synchronous. A directory is complete before anything points at
it: ``state.pt`` is written under a temporary name and renamed, and the
``last`` symlink is flipped atomically to a new ``last.<serial>`` only then,
so a crash mid-save never leaves a partial or dangling ``last``; the
previous ``last.<serial>`` is removed after the flip.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

STATE_FILE = "state.pt"


def save_tree(directory: str, tree: Any) -> None:
    """tree (nested dicts/lists of tensors and numbers) -> directory/state.pt."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, STATE_FILE)
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_tree(directory: str, map_location="cpu") -> Any:
    return torch.load(os.path.join(directory, STATE_FILE), map_location=map_location,
                      weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 3, mode: str = "min"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self.mode = mode
        self._scores_path = os.path.join(self.directory, "scores.json")
        self._scores = {}
        if os.path.exists(self._scores_path):
            with open(self._scores_path) as fh:
                self._scores = json.load(fh)
        serials = [int(n.split(".", 1)[1]) for n in os.listdir(self.directory)
                   if n.startswith("last.") and n.split(".", 1)[1].isdigit()]
        self._last_serial = max(serials, default=-1) + 1

    def _dir(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, state: Any, step: int, metric: float | None = None) -> None:
        """Refreshes 'last' and, given a metric, keeps the top-k checkpoints."""
        new = self._dir(f"last.{self._last_serial}")
        self._last_serial += 1
        save_tree(new, state)
        link = self._dir("last")
        old = os.path.realpath(link) if os.path.islink(link) else None
        tmp = link + ".tmp"
        if os.path.lexists(tmp):
            os.remove(tmp)
        os.symlink(os.path.basename(new), tmp)
        os.replace(tmp, link)  # atomic flip to a complete directory
        if old is not None and os.path.isdir(old):
            shutil.rmtree(old)

        if metric is None:
            return
        name = f"step_{step}"
        self._scores[name] = float(metric)
        keep = sorted(self._scores, key=self._scores.get,
                      reverse=(self.mode == "max"))[: self.save_top_k]
        if name in keep:
            # a crash-resumed run re-reaches validated steps: replace the dir
            if os.path.exists(self._dir(name)):
                shutil.rmtree(self._dir(name))
            save_tree(self._dir(name), state)
        for n in list(self._scores):
            if n not in keep:
                if os.path.exists(self._dir(n)):
                    shutil.rmtree(self._dir(n))
                del self._scores[n]
        with open(self._scores_path, "w") as fh:
            json.dump(self._scores, fh)

    def restore(self, name: str = "last", map_location="cpu") -> Any:
        return load_tree(self._dir(name), map_location)

    def best(self) -> str | None:
        if not self._scores:
            return None
        return sorted(self._scores, key=self._scores.get,
                      reverse=(self.mode == "max"))[0]
