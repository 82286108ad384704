"""Device-to-host fetch of a tree of tensors: pinned buffers on a side
stream, so the copy of one batch's results runs beside the next batch's
work. The batched routes (``annotator.cli.render_batches``,
``models.predict.predict_batches``) fetch through it."""
from __future__ import annotations

import torch

from . import profiler


def fetch_to_host(tree, ready=None, stream=None):
    """Tensors of a tree of dicts, lists and tuples -> the same tree of numpy
    arrays.

    With a side ``stream`` (on a card), each tensor is copied into a pinned
    host buffer on that stream once the event ``ready`` (recorded after the
    work that made the tree) has fired, so the copy waits only for that work
    and not for what the main stream has enqueued since; then the copies are
    waited for. Without one, each tensor is ``.cpu()``'d in turn.

    The copies are span ``pipeline.fetch`` (``utils.profiler``; on a card
    its events sit on the side stream, after the wait for ``ready``); the
    bytes copied go to counter ``fetch.bytes`` and, where torch keeps the
    pinned allocator's statistics, the pinned host bytes newly allocated
    through CUDA to ``fetch.pinned_alloc_bytes``."""
    if stream is None:
        with profiler.span("pipeline.fetch"):
            out = tree_map(lambda x: x.cpu().numpy(), tree)
        if profiler.recording():
            profiler.count("fetch.bytes", _tree_bytes(tree))
        return out

    def copy(x):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        x.record_stream(stream)
        host.copy_(x, non_blocking=True)
        return host

    on = profiler.recording()
    pinned = _pinned_bytes() if on else None
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        with profiler.span("pipeline.fetch", stream=stream):
            host = tree_map(copy, tree)
        done = torch.cuda.Event()
        done.record(stream)
    if on:
        profiler.count("fetch.bytes", _tree_bytes(tree))
        if pinned is not None:
            profiler.count("fetch.pinned_alloc_bytes", _pinned_bytes() - pinned)
    done.synchronize()
    return tree_map(lambda x: x.numpy(), host)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _pinned_bytes() -> int | None:
    """Pinned host bytes the caching host allocator has allocated through
    CUDA so far, or None where torch does not report it."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("allocated_bytes.allocated")


def tree_map(fn, tree):
    """fn on each leaf of a tree of dicts, lists and tuples -> the same tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
