"""Split registry (reference: dataset/starter_dataset/component_datasets/
splits.py:4-20 + taskonomy/__init__.py:14-39): per-component train/val/test
CSVs and the taskonomy subset ladder debug/tiny/medium/full/fullplus.

CSV format (the reference's train_val_test_*.csv): one row per space with
columns id,train,val,test (1/0 flags). The port's copy of the JAX
package's ``data/splits.py``.
"""
from __future__ import annotations

import csv
import os

SUBSETS = ("debug", "tiny", "medium", "full", "fullplus")

# The reference hard-codes a handful of buildings that may never be used.
FORBIDDEN_BUILDINGS = ("mosquito", "tansboro")


def get_splits(csv_path: str) -> dict:
    """-> {'train': set, 'val': set, 'test': set} from a split CSV."""
    out = {"train": set(), "val": set(), "test": set()}
    with open(csv_path) as fh:
        for row in csv.DictReader(fh):
            name = row.get("id") or row.get("name") or list(row.values())[0]
            if name in FORBIDDEN_BUILDINGS:
                continue
            for split in ("train", "val", "test"):
                if str(row.get(split, "0")).strip() in ("1", "True", "true"):
                    out[split].add(name)
    return out


def subset_ladder(all_spaces: list, fractions=(0.01, 0.06, 0.25, 0.8, 1.0)) -> dict:
    """Nested subsets debug ⊂ tiny ⊂ medium ⊂ full ⊂ fullplus over a sorted
    space list (the taskonomy subsets are nested building lists)."""
    spaces = sorted(all_spaces)
    out = {}
    for name, frac in zip(SUBSETS, fractions):
        k = max(1, int(len(spaces) * frac))
        out[name] = set(spaces[:k])
    return out


def flat_split_to_spaces(splits: dict, subsets: dict) -> dict:
    """'tiny-train'-style flat lookup (taskonomy/__init__.py:14-39)."""
    out = {}
    for sub, sub_spaces in subsets.items():
        for split, split_spaces in splits.items():
            out[f"{sub}-{split}"] = sub_spaces & split_spaces
    return out
