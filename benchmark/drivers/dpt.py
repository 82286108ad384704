"""The DPT cells: batched depth inference through the program's predict
route (``models.predict.predict_batches``, the route ``demo`` takes).

Set-up draws the model's weights from the configuration's ``weight_seed``
in the published checkpoint's layout (``gen.dpt_weights``, cached under
``benchmark/cache``) and builds the program's model from that file through
its own checkpoint loader, in the configuration's precision
(``create_model(..., checkpoint=, dtype=)``); then a pool of
``pool_batches`` batches of ``views_per_batch`` uniform RGB uint8 images
at ``image_size``^2, drawn from the traffic's ``image_seed``; ``--seed``
puts the batches in order.

The window is a closed loop with one client: ``predict_batches`` pulls the
next batch as soon as the previous batch's forward pass is enqueued, and
every batch's depth comes back to pinned host memory. A view is one image;
it is done when its depth has reached the loop, and the views done inside
the window are what ``views_per_s`` counts.

The comparison, after ``release``: a seeded sample of the kept views (one
a pool batch finished in the window) against the plain float32 reference
(``reference/dpt.py``, TF32 off) on the same device: per view the share of
pixels off by more than ``tol`` of the reference's range, and the relative
L2 error; the share of the reference's pixels above 0, so that the check
cannot pass on an all-zero depth.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..gen import dpt_weights


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch

        from omnidata_tpu_torch.models import create_model
        from omnidata_tpu_torch.models.predict import predict_batches

        self.torch, self.predict_batches = torch, predict_batches
        self.device = torch.device(device)
        self.config = config
        self.K, self.res = int(traffic["views_per_batch"]), int(traffic["image_size"])
        self.n_pool = int(traffic["pool_batches"])
        self.seed = seed
        t = [time.perf_counter()]
        self.weights = dpt_weights.cached(config, config["weight_seed"])
        t.append(time.perf_counter())
        self.model = create_model(config["model"], checkpoint=str(self.weights),
                                  dtype=config["dtype"], device=self.device)
        t.append(time.perf_counter())
        # one set of images for every seed, which orders its batches
        shape = (self.n_pool, self.K, self.res, self.res, 3)
        raw = np.random.RandomState(int(traffic["image_seed"])).bytes(int(np.prod(shape)))
        images = np.frombuffer(bytearray(raw), np.uint8).reshape(shape)
        order = np.random.RandomState(seed % 2**32).permutation(self.n_pool)
        self.pool = [images[b] for b in order]
        t.append(time.perf_counter())
        self.setup_parts = {"weights_s": t[1] - t[0], "model_s": t[2] - t[1],
                            "images_s": t[3] - t[2]}
        rng = np.random.RandomState((seed + 1) % 2**32)
        self.sample_vi = rng.randint(0, self.K, self.n_pool)  # one kept view a batch
        self.kept: dict = {}
        self.malformed = 0

    # ---- the loop --------------------------------------------------------

    def run(self, seconds: float, tracer=None, window: bool = True) -> dict:
        """One closed loop over the pool for ``seconds`` -> the loop's record.
        window=False is the warm-up: nothing is kept for the comparison."""
        K = self.K
        pulls: list = []
        done: list = []  # (pulled, arrived) of each batch that came back whole
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def images():
            seq = 0
            while time.perf_counter() < t_end:
                if tracer is not None:
                    tracer.tick(t0, seq % self.n_pool)
                pulls.append(time.perf_counter())
                yield self.pool[seq % self.n_pool]
                seq += 1

        completed: list = []
        try:
            for seq, depth in enumerate(self.predict_batches(self.model, images(), "depth")):
                t = time.perf_counter()
                if depth.shape != (K, self.res, self.res) or depth.dtype != np.float32:
                    self.malformed += 1
                    continue
                done.append((pulls[seq], t))
                if t <= t_end:
                    completed.append(seq % self.n_pool)
                if window and seq < self.n_pool and t <= t_end:
                    self.kept[seq] = np.array(depth[int(self.sample_vi[seq])])
        finally:
            if tracer is not None:
                tracer.stop()
        in_window = [(p, a) for p, a in done if a <= t_end]
        return {
            "seconds": seconds,
            "views_done": K * len(in_window),
            "batch_latencies_s": [a - p for p, a in in_window],
            "completed_pool_idx": completed,
            "batches_pulled": len(pulls),
            "launches_per_batch": {},
        }

    def rows_past_stage_cap(self) -> dict:
        return {}

    # ---- traced run: work -----------------------------------------------------

    def work(self, pool_idx) -> dict:
        """FLOPs of each pool batch in pool_idx (``benchmark.dpt_work``)."""
        from ..dpt_work import image_flops

        flops = self.K * image_flops(self.config, self.res)
        return {b: {"flops": flops} for b in set(pool_idx)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # ---- correctness --------------------------------------------------------

    def check(self, limits: dict, n_sample: int, control: str | None = None) -> list:
        """Compare a seeded sample of the kept views with the reference ->
        [(name, value, limit, passed)]. control: a lower precision whose
        operand rounding the reference takes on in the program's place."""
        torch = self.torch
        from ..reference.dpt import dpt_forward, exact_float32, rounder

        cand = sorted(self.kept)
        rng = np.random.RandomState((self.seed + 2) % 2**32)
        sample = sorted(rng.choice(cand, min(n_sample, len(cand)), replace=False)) \
            if cand else []
        sd = {k: v.to(self.device) for k, v in dpt_weights.load(self.weights).items()}
        cfg = self.config
        kw = {"heads": cfg["num_attention_heads"], "hooks": tuple(cfg["vit_taps"])}
        rnd = rounder(getattr(torch, control)) if control else None
        tol = limits["depth_off"]["tol"]
        worst_off = worst_l2 = 0.0
        least_nonzero = 1.0
        for seq in sample:
            img = self.pool[int(seq)][int(self.sample_vi[seq])]
            x = (img.astype(np.float32).transpose(2, 0, 1)[None] / np.float32(255) - 0.5) / 0.5
            x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            with torch.no_grad(), exact_float32():
                ref = dpt_forward(sd, x, **kw)[0, 0].clamp(0.0, 1.0)
                prog = (torch.from_numpy(self.kept[seq]).to(self.device) if rnd is None
                        else dpt_forward(sd, x, rnd=rnd, **kw)[0, 0].clamp(0.0, 1.0))
            err = (prog - ref).abs()
            span = float(ref.max() - ref.min())
            off = float((err > tol * span).float().mean())
            l2 = float(err.norm() / ref.norm().clamp(min=1e-30))
            nonzero = float((ref > 0).float().mean())
            print(f"benchmark: view {int(seq)}: depth_off {off} depth_rel_l2 {l2} "
                  f"max_err_of_range {float(err.max()) / max(span, 1e-30)} "
                  f"nonzero {nonzero}", file=sys.stderr)
            worst_off, worst_l2 = max(worst_off, off), max(worst_l2, l2)
            least_nonzero = min(least_nonzero, nonzero)
        checks = [
            ("depth_off", worst_off, limits["depth_off"]["limit"],
             worst_off <= limits["depth_off"]["limit"]),
            ("depth_rel_l2", worst_l2, limits["depth_rel_l2"]["limit"],
             worst_l2 <= limits["depth_rel_l2"]["limit"]),
            ("nonzero_share", least_nonzero, limits["nonzero_share"]["limit"],
             bool(sample) and least_nonzero >= limits["nonzero_share"]["limit"]),
            ("malformed_batches", self.malformed, 0, self.malformed == 0),
        ]
        want = min(n_sample, max(len(cand), 1))
        checks.append(("views_compared", len(sample), want, len(sample) >= want))
        return checks
