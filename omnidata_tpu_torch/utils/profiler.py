"""Step profiler: a context manager that logs
'"{name}:{step}: {secs} seconds"' per step and the total on exit; a device
trace context; and the program's span and counter recorder.

The recorder is on exactly while something traces: while a
``torch.profiler`` records in the calling thread, inside a ``DeviceTrace``,
or in a thread working for a batch that began while one of those was on
(``new_batch``, ``in_batch``). Off, ``span`` returns one shared no-op after
a flag check and ``count`` does nothing; call sites whose counted value
costs device work ask ``recording()`` first. On, a span enters
``torch.profiler.record_function`` (so it lands in the profiler's trace on
the same clock as the kernels it launches) and keeps, in a bounded buffer,
its name, thread, parent span, batch, host start and end and, where CUDA is
in use, a pair of timing events on its stream. Event times are read only
by ``summary``."""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import NamedTuple

import torch

MAX_SPANS = 8192  # spans kept; past it the oldest are dropped and counted


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


class _Local(threading.local):
    batch = None  # the batch this thread's spans and counts belong to
    forced = False  # that batch began while recording

    def __init__(self):
        self.stack = []  # open spans, innermost last


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "batch", "stream", "device", "thread", "parent",
                 "t0", "t1", "ev0", "ev1", "_rf")

    def __init__(self, rec, name, stream, device):
        self.rec, self.name, self.stream, self.device = rec, name, stream, device
        self.ev0 = self.ev1 = None

    def __enter__(self):
        tls = self.rec._tls
        self.batch = tls.batch
        self.thread = threading.current_thread().name
        self.parent = tls.stack[-1].name if tls.stack else None
        tls.stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.device and torch.cuda.is_initialized():
            if self.stream is None:
                self.stream = torch.cuda.current_stream()
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(self.stream)
        self._rf.__exit__(*exc)
        self._rf = self.stream = None
        self.rec._tls.stack.pop()
        self.rec._keep(self)
        return False


class Batch(NamedTuple):
    """One unit of the pipeline's work: its id, and whether it began while
    recording (then every span and count made for it records)."""

    ident: int
    on: bool


class Recorder:
    """Spans and counters of the program, kept while something traces."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self._tls = _Local()
        self._lock = threading.Lock()
        self._on = 0  # DeviceTrace extents open
        self._ids = itertools.count()
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self._counters: dict = {}
        self.dropped = 0

    def recording(self) -> bool:
        return (self._on > 0 or self._tls.forced
                or torch.autograd._profiler_enabled())

    def hold(self, on: bool) -> None:
        """Record in every thread (on) or stop doing so, in nested pairs."""
        with self._lock:
            self._on += 1 if on else -1

    def span(self, name: str, stream=None, device: bool = True):
        """Context manager timing a stage of the thread's batch
        (``in_batch``). stream: the CUDA stream its events go on (default:
        the current one); device=False keeps host time only."""
        if not self.recording():
            return _OFF
        return _Span(self, name, stream, device)

    def count(self, name: str, value) -> None:
        """Add a Python int or a 0-d tensor (summed on its device, no sync)
        to counter ``name``, for the thread's batch."""
        if not self.recording():
            return
        with self._lock:
            total, batches = self._counters.get(name, (0, set()))
            batches.add(self._tls.batch)
            self._counters[name] = (total + value, batches)

    def new_batch(self) -> Batch:
        return Batch(next(self._ids), self.recording())

    @contextlib.contextmanager
    def in_batch(self, batch: Batch):
        """The calling thread's spans and counts belong to ``batch`` inside,
        and record if it began while recording."""
        tls = self._tls
        saved = tls.batch, tls.forced
        tls.batch, tls.forced = batch.ident, batch.on
        try:
            yield
        finally:
            tls.batch, tls.forced = saved

    def call_in_batch(self, batch: Batch, fn, *args):
        """fn(*args) in ``in_batch(batch)``: for work handed to another
        thread, where the profiler's own flag does not reach."""
        with self.in_batch(batch):
            return fn(*args)

    def _keep(self, span: _Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self.dropped = 0

    def records(self) -> list:
        """The kept spans, oldest first: (name, thread, parent, batch, host
        start ns, host end ns)."""
        with self._lock:
            return [(s.name, s.thread, s.parent, s.batch, s.t0, s.t1)
                    for s in self._spans]

    def summary(self) -> dict:
        """-> {"spans": {name: {count, batches, parents, host_ms, device_ms}},
        "counters": {name: {total, batches}}, "dropped"}. batches: the
        sorted batch ids; host_ms and device_ms are means per batch (a span
        of no batch counts as one), device_ms the time between its events
        on its stream (None without events). Synchronises once."""
        with self._lock:
            spans = list(self._spans)
            counters = dict(self._counters)
            dropped = self.dropped
        if torch.cuda.is_initialized():
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        by_name: dict = {}
        for s in spans:
            by_name.setdefault(s.name, []).append(s)
        out = {}
        for name, group in by_name.items():
            ids = {s.batch for s in group if s.batch is not None}
            per = len(ids) + sum(s.batch is None for s in group)
            timed = [s for s in group if s.ev1 is not None]
            dev = (sum(s.ev0.elapsed_time(s.ev1) for s in timed) / per
                   if timed else None)
            out[name] = {"count": len(group), "batches": sorted(ids),
                         "parents": sorted({s.parent or "" for s in group}),
                         "host_ms": sum(s.t1 - s.t0 for s in group) / 1e6 / per,
                         "device_ms": dev}
        cnt = {name: {"total": int(total),
                      "batches": sorted(b for b in batches if b is not None)}
               for name, (total, batches) in counters.items()}
        return {"spans": out, "counters": cnt, "dropped": dropped}


RECORDER = Recorder()
recording = RECORDER.recording
span = RECORDER.span
count = RECORDER.count
new_batch = RECORDER.new_batch
in_batch = RECORDER.in_batch
call_in_batch = RECORDER.call_in_batch
summary = RECORDER.summary
reset = RECORDER.reset
records = RECORDER.records


class DeviceTrace:
    """``torch.profiler`` trace of the host and, when a card is present, the
    CUDA device, written on exit as ``<logdir>/trace.json`` (Chrome trace
    format; chrome://tracing or Perfetto open it), with the recorder's
    ``summary`` of the same extent as ``<logdir>/spans.json``. The recorder
    is reset on entry and records throughout; where the running torch
    offers it, the profiler traces every thread, so spans of the pipeline's
    fetch thread reach ``trace.json`` too. The counterpart of the JAX
    package's ``jax.profiler`` trace context."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):  # a torch without the option
            pass
        RECORDER.reset()
        RECORDER.hold(True)
        self._prof = torch.profiler.profile(activities=acts, **kw)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._prof.__exit__(*exc)
        finally:
            RECORDER.hold(False)
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        with open(os.path.join(self.logdir, "spans.json"), "w") as fh:
            json.dump(summary(), fh, indent=1)
        return False
