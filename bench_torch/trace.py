"""Spans around the port's layers, and the profiler's timeline.

The program carries no spans of its own yet, so the traced run wraps each
layer's entry from here, with no edit to the program: the wrapper is
installed on the module attribute that callers look up and opens a
``torch.profiler.record_function`` range of the same name. In the spans
pass it also synchronises the device at both ends, so that a span's wall
time holds its device work and nothing else; in the profiled pass it does
not, so the device runs as it does untraced. The entries:

* ``prepare``: ``runtime.solver.prepare`` (preprocessing, problem and
  state, with the upload of the host arrays);
* ``iteration``: ``models.srps.srps_iteration`` (one outer iteration of a
  solve) and ``parallel.batched._iteration_lockstep`` (one of a lockstep
  batch);
* ``depth_cg``: ``models.srps.depth_cg``, which both call;
* ``solve_batch``: ``parallel.batched.solve_batch``;
* ``load``: ``io.image_loader.load_image_dataset`` (the dataset folder's
  PNG decode and float conversion, on the host), which ``cli._loader``
  hands out.

:class:`Timeline` reads a Chrome trace that ``torch.profiler`` exported:
the device's kernels, copies and sets, each with the host time of the
runtime call that launched it (matched by the profiler's correlation id),
and the host's ranges and operations.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    seconds: float
    info: dict


class Tracer:
    """Installs the span wrappers while active; ``spans`` keeps every
    span in order. ``lanes`` and ``pixels`` are set by the traffic client
    before each capture or batch: the lane count and the mask's pixels of
    each lane (for the roofline). With ``sync`` False the spans' seconds
    are the host's alone."""

    def __init__(self, device, sync: bool = True):
        self.device = device
        self.synced = sync
        self.spans: list[Span] = []
        self.lanes = 1
        self.pixels: list[int] = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name, fn, info=None):
        def wrapped(*args, **kw):
            with torch.profiler.record_function(name):
                if self.synced:
                    self.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if self.synced:
                    self.sync()
                dt = time.perf_counter() - t0
            self.spans.append(Span(name, dt, info(out) if info else {}))
            return out
        return wrapped

    @contextlib.contextmanager
    def installed(self):
        from srmeetsps_cuda_tpu_torch.io import image_loader
        from srmeetsps_cuda_tpu_torch.models import srps
        from srmeetsps_cuda_tpu_torch.parallel import batched
        from srmeetsps_cuda_tpu_torch.runtime import solver

        def cg_info(out):
            # The iteration counts stay on the device until the capture
            # ends (a read here would add a copy to the outer iteration).
            return {"iters": out[2], "pixels": list(self.pixels),
                    "lanes": self.lanes}

        targets = [
            (solver, "prepare", "prepare", None),
            (srps, "srps_iteration", "iteration", lambda _: {"lanes": 1}),
            (batched, "_iteration_lockstep", "iteration",
             lambda _: {"lanes": self.lanes}),
            (srps, "depth_cg", "depth_cg", cg_info),
            (batched, "solve_batch", "solve_batch", None),
            (image_loader, "load_image_dataset", "load", None),
        ]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in targets]
        try:
            for mod, attr, name, info in targets:
                setattr(mod, attr, self.wrap(name, getattr(mod, attr), info))
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def of(self, name):
        return [s for s in self.spans if s.name == name]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Timeline:
    """The events of one exported Chrome trace, times in seconds. A device
    event is ``(start, end, name, category, launch)``: ``launch`` is the
    host time of the runtime or driver call that enqueued it, matched by
    the profiler's correlation id, or its own start where the trace holds
    no such call (``unlaunched`` counts those)."""

    def __init__(self, events: list[dict]):
        dev, host, launch = [], [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                dev.append((t0, t1, e.get("name", ""), cat, corr))
            elif cat in HOST_CATS:
                host.append((t0, t1, e.get("name", ""), cat, e.get("tid")))
            elif cat in LAUNCH_CATS and corr is not None:
                launch[corr] = t0
        self.unlaunched = sum(1 for d in dev if d[4] not in launch)
        dev = [(a, b, n, c, launch.get(k, a)) for a, b, n, c, k in dev]
        self.device = sorted(dev, key=lambda d: (d[0], -d[1]))
        # A range before the ranges and operations it holds.
        self.host = sorted(host, key=lambda e: (e[0], -e[1]))
        self._by_launch = sorted(dev, key=lambda d: d[4])
        self._launches = [d[4] for d in self._by_launch]

    @classmethod
    def load(cls, path) -> "Timeline":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def ranges(self, name):
        """``(start, end)`` of each host range so named, in order."""
        return [(a, b) for a, b, n, c, _ in self.host
                if n == name and c == "user_annotation"]

    def kernels_in(self, t0, t1):
        """The kernels launched inside the host interval ``[t0, t1]``,
        wherever on the device they ran."""
        i = bisect.bisect_left(self._launches, t0)
        j = bisect.bisect_right(self._launches, t1)
        return [d for d in self._by_launch[i:j] if d[3] == "kernel"]

    def busy(self, t0, t1) -> float:
        """Seconds of ``[t0, t1]`` in which the device ran something."""
        total, end = 0.0, t0
        for a, b, *_ in self.device:
            a, b = max(a, end), min(b, t1)
            if b > a:
                total += b - a
                end = b
        return total

    def gaps(self, t0, t1):
        """The idle intervals of ``[t0, t1]``, longest first."""
        out, end = [], t0
        for a, b, *_ in self.device:
            if a > t1:
                break
            if a > end:
                out.append((end, min(a, t1)))
            end = max(end, b)
        if end < t1:
            out.append((end, t1))
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, times, tid=None) -> list:
        """The innermost host range or operation open at each of ``times``
        on thread ``tid`` (any thread where None), in one sweep: the
        events of one thread nest."""
        events = [e for e in self.host if tid is None or e[4] == tid]
        order = sorted(range(len(times)), key=lambda i: times[i])
        out = ["none"] * len(times)
        stack, k = [], 0
        for i in order:
            t = times[i]
            while k < len(events) and events[k][0] <= t:
                while stack and stack[-1][1] < events[k][0]:
                    stack.pop()
                stack.append(events[k])
                k += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack:
                out[i] = stack[-1][2]
        return out

    def tid_of(self, name):
        """The thread of the first host range so named."""
        return next((e[4] for e in self.host
                     if e[2] == name and e[3] == "user_annotation"), None)

    def top_ops(self, t0, t1, k=10):
        by = {}
        for a, b, n, *_ in self.device:
            if t0 <= a <= t1:
                by[n] = by.get(n, 0.0) + (b - a)
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]
