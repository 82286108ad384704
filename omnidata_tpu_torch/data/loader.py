"""Threaded prefetching batch loader — the role of the reference's
`DataLoader(num_workers=16)` worker pool (train_normal.py dataloaders;
SURVEY.md §7 "dataloading at 1000 views/sec" hard part).

PNG decode is zlib-bound (zlib and numpy release the GIL), so a thread
pool overlaps decode of future batches with device compute on the current
one; the port's copy of the JAX package's ``data/loader.py``. Batches come out in a deterministic order for a fixed seed/epoch, and
each item carries a private augmentation seed (dataset.item) so decode-
thread completion order cannot change flips/crops.

    loader = PrefetchLoader(dataset, batch_size=16, num_workers=8)
    for batch in loader.epoch(seed=0):   # dict of stacked numpy arrays
        ...
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _fetch(ds, i: int, seed: int):
    """Seeded, thread-safe item access when the dataset supports it."""
    item = getattr(ds, "item", None)
    return item(i, seed) if item is not None else ds[i]


def _stack(items: list) -> dict:
    batch = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray):
            batch[k] = np.stack([it[k] for it in items])
        else:
            batch[k] = [it[k] for it in items]
    return batch


def _prefetched(plan, submit_row, num_workers: int, prefetch: int):
    """Shared producer/consumer machinery for the loaders.

    plan: list of batch rows (resolved up front — deterministic).
    submit_row(pool, row) -> list of futures for that batch's items.
    Keeps `prefetch` whole batches in flight on a daemon producer thread;
    yields stacked batches in plan order; re-raises decode exceptions in
    the consumer; drains cleanly if the consumer stops early."""
    out_q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def produce():
        with ThreadPoolExecutor(num_workers) as pool:
            futures = []
            for row in plan:
                if stop.is_set():
                    return
                futures.append(submit_row(pool, row))
                while len(futures) > prefetch or (futures and row is plan[-1]):
                    fs = futures.pop(0)
                    try:
                        out_q.put(_stack([f.result() for f in fs]))
                    except Exception as e:  # surface in the consumer
                        out_q.put(e)
                        return
        out_q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = out_q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        # drain so the producer can exit
        while t.is_alive():
            try:
                out_q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.1)


class MixedLoader:
    """Per-batch equal-component mixing with threaded prefetch — the role of
    the reference's WeightedRandomSampler over a ConcatDataset
    (train_normal.py:140-156: each sample drawn from component k with
    probability 1/k) + the CombinedLoader 1/k-per-batch datamodule
    (dataloader/pytorch_lightning_datamodule.py:12-96), fused with the
    num_workers=16 decode pool.

    Every item of every batch picks a uniformly-random component, then a
    uniformly-random sample within it; decode runs on a thread pool with
    `prefetch_batches` whole batches in flight ahead of the consumer.

        loader = MixedLoader([ds_a, ds_b], batch_size=8, num_workers=8)
        for batch in loader.batches(steps=1000, seed=0):
            ...
    """

    def __init__(self, datasets, batch_size: int, num_workers: int = 8,
                 prefetch_batches: int = 2):
        assert datasets and all(len(d) for d in datasets)
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch_batches)

    def batches(self, steps: int, seed: int | None = 0):
        rng = np.random.RandomState(seed)
        # resolve the whole (component, item, aug-seed) plan up front:
        # deterministic for a fixed seed regardless of decode-thread timing
        plan = []
        for _ in range(steps):
            row = []
            for _ in range(self.batch_size):
                d = rng.randint(len(self.datasets))
                row.append((d, rng.randint(len(self.datasets[d])),
                            rng.randint(1 << 31)))
            plan.append(row)

        def submit_row(pool, row):
            return [pool.submit(_fetch, self.datasets[d], int(i), int(s))
                    for d, i, s in row]

        yield from _prefetched(plan, submit_row, self.num_workers, self.prefetch)


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 prefetch_batches: int = 2, drop_last: bool = True):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch_batches)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.ds) // self.batch_size
        if not self.drop_last and len(self.ds) % self.batch_size:
            n += 1
        return n

    def epoch(self, seed: int | None = None, shuffle: bool = True):
        order = np.arange(len(self.ds))
        rs = np.random.RandomState(seed)
        if shuffle:
            rs.shuffle(order)
        aug_seeds = rs.randint(1 << 31, size=len(order))
        stops = range(0, len(order) if not self.drop_last else
                      len(order) - self.batch_size + 1, self.batch_size)
        plan = [
            list(zip(order[s : s + self.batch_size],
                     aug_seeds[s : s + self.batch_size]))
            for s in stops
        ]
        if not plan:
            return

        def submit_row(pool, row):
            return [pool.submit(_fetch, self.ds, int(i), int(s))
                    for i, s in row]

        yield from _prefetched(plan, submit_row, self.num_workers, self.prefetch)
