"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds of the window, read back from its chrome trace.

``Stretch`` starts the profiler once the window has run ``delay_s`` and
stops it ``length_s`` later; the driver calls ``tick`` at every batch it
pulls, so the stretch begins and ends on batch boundaries and counts the
batches pulled inside it. ``read`` returns the device's busy seconds (the
union of kernel, copy and set intervals inside the stretch), the stretch's
length, device seconds by operation name, and the longest idle gaps, each
named by the host event that overlaps it most.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "benchmark.stretch"


class Stretch:
    def __init__(self, delay_s: float, length_s: float):
        self.delay_s, self.length_s = delay_s, length_s
        self.prof = self.mark = None
        self.t_start = self.t_stop = None
        self.batches = 0  # pulled inside the stretch
        self.pool_idx: list = []
        self.done = False

    def tick(self, t_window0: float, pool_idx: int) -> None:
        """At a batch pull: start, count or stop."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.done:
            return
        now = time.perf_counter()
        if self.prof is None and now - t_window0 >= self.delay_s:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.mark = record_function(MARK)
            self.mark.__enter__()
            self.t_start = time.perf_counter()
        elif self.prof is not None and now - self.t_start >= self.length_s:
            self.stop()
            return
        if self.prof is not None:
            self.batches += 1
            self.pool_idx.append(pool_idx)

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        import torch

        self.mark.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True

    def read(self, top: int = 10) -> dict | None:
        """-> {busy_s, stretch_s, batches, pool_idx, device_s {name: s},
        device_n {name: events}, device_ops [[name, s]], idle_gaps [[name,
        s]]}, or None if the stretch never started. Events are clipped to
        the stretch."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        marks = [e for e in events if e.get("name") == MARK and "dur" in e
                 and e.get("cat") == "user_annotation"]
        if not marks:
            return None
        t0 = float(marks[0]["ts"])
        t1 = t0 + float(marks[0]["dur"])
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            iv = (max(s, t0), min(s + float(e["dur"]), t1), e.get("name", "?"))
            if iv[1] <= iv[0]:
                continue
            if e.get("cat") in DEVICE_CATS:
                dev.append(iv)
            elif e.get("cat") in HOST_CATS and e.get("name") != MARK:
                host.append(iv)
        by_name: dict = {}
        count: dict = {}
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
            count[name] = count.get(name, 0) + 1
        busy, gaps, cur_s, cur_e = 0.0, [], None, t0
        for s, e, _ in sorted(dev):
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, t1))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for gs, ge in gaps:
            best, name = 0.0, "no host event"
            for s, e, hname in host:
                ov = min(e, ge) - max(s, gs)
                if ov > best:
                    best, name = ov, hname
            named.append([name[:120], (ge - gs) / 1e6])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"busy_s": busy / 1e6, "stretch_s": (t1 - t0) / 1e6,
                "batches": self.batches, "pool_idx": list(self.pool_idx),
                "device_s": by_name, "device_n": count,
                "device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": named}
