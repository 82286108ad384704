"""Batched inference: crops in, predictions out, one batch in flight while
the previous one comes back to the host.

``predict_batches`` is the route ``demo`` takes for its images and the
benchmark's DPT cell times. Each batch is a (B, S, S, 3) uint8 array of
crops already resized to the model's input size (``demo``'s resize and
centre crop); it is uploaded from pinned memory and normalised on the
device as the reference's transform does (``/ 255``; depth also ``(x -
0.5) / 0.5``), run through the ``Predictor`` and clamped to [0, 1], as
the reference's demo clamps. On a card the ``Predictor`` runs as CUDA
graphs (``Predictor.graphed``): eager, DPT at batch 8 enqueues ~1,190
kernels, and the host took as long to enqueue them as the card took to
run them (~23 ms), so the loop's rate followed the host's noise. Batch b's
prediction is fetched to pinned host
memory by one fetch thread on a side stream (``utils.fetch.fetch_to_host``)
and yielded once batch b+1's forward pass is enqueued, as
``annotator.cli.render_batches`` does with its labels.

Spans and counters (``utils.profiler``, recorded only while a profiler
runs): ``predict.upload`` (the copy to the device and the normalisation),
``predict.model`` (the forward pass and the clamp; inside it a DPT's
``dpt.*`` spans, around each stage's replay on a card, the counter
``dpt.tokens`` only where the forward runs eagerly),
``pipeline.fetch`` and ``pipeline.wait`` as in the CLI's pipeline; counters
``predict.images`` and ``predict.upload_bytes``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils import profiler
from ..utils.fetch import fetch_to_host


def normalise(crops: torch.Tensor, task: str) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> (B, 3, S, S) float32 on the same device, as the
    reference's transform: / 255, for depth also (x - 0.5) / 0.5. The
    division is by a tensor: a Python divisor is a product with its
    reciprocal on the card, one rounding more than the reference's."""
    x = crops.permute(0, 3, 1, 2).float() / torch.full((), 255.0, device=crops.device)
    return (x - 0.5) / 0.5 if task == "depth" else x


def _upload(crops: np.ndarray, device: torch.device, task: str) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(crops))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return normalise(x, task)


def predict_batches(model, batches, task: str = "depth"):
    """``model`` (a ``registry.Predictor``) on each uint8 crop batch of
    ``batches`` in turn -> yields, in order, each batch's prediction clamped
    to [0, 1] as a float32 numpy array on the host: depth (B, S, S),
    normals (B, 3, S, S)."""
    device = next(model.parameters()).device
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def fetched(fut, batch):
        with profiler.in_batch(batch), profiler.span("pipeline.wait", device=False):
            return fut.result()

    with ThreadPoolExecutor(max_workers=1) as fetcher:
        prev = None
        for crops in batches:
            batch = profiler.new_batch()
            with profiler.in_batch(batch), torch.inference_mode():
                with profiler.span("predict.upload"):
                    x = _upload(crops, device, task)
                if profiler.recording():
                    profiler.count("predict.images", int(crops.shape[0]))
                    profiler.count("predict.upload_bytes", int(crops.nbytes))
                with profiler.span("predict.model"):
                    pred = (model(x) if side is None else model.graphed(x)).clamp_(0.0, 1.0)
            ready = None
            if side is not None:
                ready = torch.cuda.Event()
                ready.record()
            fut = fetcher.submit(profiler.call_in_batch, batch, fetch_to_host,
                                 pred, ready, side)
            del x, pred
            if prev is not None:
                yield fetched(*prev)
            prev = fut, batch
        if prev is not None:
            yield fetched(*prev)
