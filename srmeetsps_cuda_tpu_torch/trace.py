"""Named phase ranges and work counters, live only under ``torch.profiler``.

The solve's phases open spans (``span``) and count their work where it
happens (``count``; ``read`` for a host read of a device value). A span is
live only while a ``torch.profiler`` session records: it then opens a
``torch.profiler.record_function`` range of its name, so the profiler's
trace shows it as a ``user_annotation`` range on the same timeline as the
kernels and copies launched inside it. Otherwise ``span`` returns one
shared null context and ``count`` returns at once: one flag check each.

The store keeps no clock of its own. It holds the spans of the newest
profiler session, in the order they opened, each as ``{"name", "ordinal",
"parent", "request", "attrs", "counts"}``: ``ordinal`` is k for the k-th
span of that name in the session, so the record joins the k-th range of
that name in the session's trace; ``parent`` is the enclosing span's
``[name, ordinal]``; ``request`` is the id that the capture's
``srps.prepare`` span took (the spans of one capture share it).

Spans (all under ``srps.``, apart from any range the caller opens):

* ``srps.prepare``, one per capture, and inside it ``.upload`` (each move
  of a capture's host array to the device; attr ``pinned``, true where it
  goes through a card's pinned staging ring; counts ``h2d_bytes``,
  ``h2d_pinned_bytes``, the bytes moved through the ring, and
  ``h2d_fill_ns``, the host's time copying them into the ring's slots),
  ``.mean``, ``.inpaint``, ``.bilateral``, ``.bicubic`` (attr ``factor``,
  the upsample's), ``.pad``, ``.problem`` (``build_problem``) and
  ``.state`` (``init_state``);
* ``srps.iteration``, one outer iteration (``lanes`` of a lockstep
  batch; ``glue``, how its glue ran: ``"eager"``, ``"capture"`` or
  ``"replay"`` from the solve's CUDA graphs, ``models/glue.py``; counts
  ``glue_replays``, the lanes whose glue it replayed), and inside it
  ``srps.lighting``, ``srps.albedo``,
  ``srps.depth_operator``, ``srps.depth_cg`` (attrs ``lanes``, ``sf`` and
  ``form``, the CG's Jacobi form: ``"plain"``, ``"scaled"`` or ``"pcg"``;
  counts ``cg_iters``, the kernel's own per-lane count, kept on the device
  until the store is read) and ``srps.normals``; a lockstep batch's
  per-lane phases carry ``lane``. An iteration that replays the glue
  opens only ``srps.depth_cg`` inside it: the graphs' kernels are launched
  by the ``srps.iteration`` range itself;
* ``srps.stop``, the stop test between outer iterations, and
  ``srps.results``, the host reads after the loop.

Counters: ``host_reads`` (each call that waits for the device: a
tensor's value read on the host, a synchronise), ``h2d_bytes``,
``h2d_pinned_bytes``, ``h2d_fill_ns``, ``cg_iters`` and ``glue_replays``.
None of them launches a kernel.

:func:`records` and :func:`totals` read the store; :func:`dump` writes
it as JSON lines (``runtime.solver.profiling`` does, beside the trace).

Apart from the store, profiler or not, the process counts the launches
of its hand-written kernels by name: the wrapper that launches one calls
:func:`launched` (its docstring names what it counts), and
:func:`launch_counts` returns a copy of the counts.
"""

from __future__ import annotations

import contextlib
import json
import weakref

import torch

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_launches = {}  # kernel name -> launches in this process


def launched(name: str, n: int = 1) -> None:
    """Count ``n`` launches of the hand-written kernel ``name``."""
    _launches[name] = _launches.get(name, 0) + n


def launch_counts() -> dict:
    """A copy of the process's kernel launches so far, by name."""
    return dict(_launches)


class Store:
    """The spans and counts of the newest profiler session."""

    def __init__(self):
        self.clear()
        self.stale = False

    def clear(self):
        self.spans = []  # records, in the order the spans opened
        self.open = []  # records of the spans open now, innermost last
        self.seen = {}  # spans opened so far, by name
        self.loose = {}  # counts made outside any span
        self.request = None  # the request of the newest srps.prepare
        self.next_request = 0
        self.owners = {}  # id(tensor) -> (weak reference, request)
        self.lanes = None  # the requests of a lockstep batch's lanes

    def fresh(self):
        """Start from an empty store if a new session has started."""
        if self.stale:
            self.clear()
            self.stale = False

    def enter(self, name, attrs) -> dict:
        self.fresh()
        parent = self.open[-1] if self.open else None
        if name == "srps.prepare":
            self.request = request = self.next_request
            self.next_request += 1
        elif "lane" in attrs and self.lanes is not None:
            request = self.lanes[attrs["lane"]]
        elif parent is not None:
            request = parent["request"]
        else:
            request = None if self.lanes is not None else self.request
        k = self.seen.get(name, 0)
        self.seen[name] = k + 1
        rec = {"name": name, "ordinal": k,
               "parent": parent and [parent["name"], parent["ordinal"]],
               "request": request, "attrs": attrs, "counts": {}}
        self.spans.append(rec)
        self.open.append(rec)
        return rec

    def close(self, rec):
        if self.open and self.open[-1] is rec:
            self.open.pop()

    def add(self, key, n):
        self.fresh()
        counts = self.open[-1]["counts"] if self.open else self.loose
        counts.setdefault(key, []).append(n)


STORE = Store()


def _watch_sessions():
    """Mark the store stale whenever a profiler session starts, by
    wrapping torch's start hook (once, at the first live span)."""
    prof = torch.autograd.profiler
    start = getattr(prof, "_run_on_profiler_start", None)
    if start is None or getattr(start, "srps_watch", False):
        return

    def on_start():
        start()
        STORE.stale = True

    on_start.srps_watch = True
    prof._run_on_profiler_start = on_start


@contextlib.contextmanager
def _live(name, attrs):
    _watch_sessions()
    rec = STORE.enter(name, attrs)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        STORE.close(rec)


def span(name: str, **attrs):
    """A context that records the span ``name`` with ``attrs`` and opens
    a profiler range of that name, while a profiler records; else a
    shared null context."""
    if not _enabled():
        return _NULL
    return _live(name, attrs)


def live() -> bool:
    """Whether a profiler session records now (spans and counts kept)."""
    return _enabled()


def count(key: str, n=1) -> None:
    """Add ``n`` (a number, or a device tensor summed when the store is
    read) to ``key`` of the innermost open span."""
    if _enabled():
        STORE.add(key, n)


def read(convert, t):
    """``convert(t)`` (``bool``, ``int`` or ``float`` of a tensor), the
    host waiting for the device, counted as a host read."""
    count("host_reads")
    return convert(t)


def bind(prob) -> None:
    """Tie a capture's problem (by its ``mask`` tensor) to the request of
    the newest ``srps.prepare``, for :func:`lanes`."""
    if _enabled():
        STORE.owners[id(prob.mask)] = (weakref.ref(prob.mask), STORE.request)


@contextlib.contextmanager
def _lanes(probs):
    def owner(mask):
        ref, request = STORE.owners.get(id(mask), (None, None))
        return request if ref is not None and ref() is mask else None

    # A stacked problem's mask holds the lanes' masks, none of them bound.
    masks = probs.mask if hasattr(probs, "mask") else [p.mask for p in probs]
    STORE.lanes = [owner(m) for m in masks]
    try:
        yield
    finally:
        STORE.lanes = None


def lanes(probs):
    """A context in which the spans of lane b carry the request that
    ``probs[b]`` was bound to (none for a stacked problem), and the
    batch's own spans none."""
    if not _enabled():
        return _NULL
    return _lanes(probs)


def _number(values):
    total = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            v = sum(v.reshape(-1).tolist())
        total += v
    return total


def records() -> list:
    """The newest session's spans, each count a number."""
    STORE.fresh()
    return [dict(r, counts={k: _number(v) for k, v in r["counts"].items()})
            for r in STORE.spans]


def totals() -> dict:
    """Each counter over the whole session, spans and outside."""
    STORE.fresh()
    out = {k: _number(v) for k, v in STORE.loose.items()}
    for r in records():
        for k, v in r["counts"].items():
            out[k] = out.get(k, 0) + v
    return out


def dump(path) -> None:
    """The newest session's spans as JSON lines, one record a line, then
    the counts made outside any span, if any, as ``{"counts": ...}``."""
    with open(path, "w") as f:
        for r in records():
            f.write(json.dumps(r) + "\n")
        if STORE.loose:
            loose = {k: _number(v) for k, v in STORE.loose.items()}
            f.write(json.dumps({"counts": loose}) + "\n")
