"""The port's own spans and counters beside the profiled pass's timeline.

The program (``srmeetsps_cuda_tpu_torch/trace.py``) keeps, for the newest
``torch.profiler`` session, one record for each ``srps.*`` span it opened:
its name, ordinal, parent, attributes and counts, and no clock. The k-th
record of a name is the k-th ``user_annotation`` range of that name in the
session's trace. The metrics that read the spans take the profiled pass's
records through :func:`joined`, which finds nothing where the program
keeps no such store or its records and the trace's ranges do not pair one
to one.
"""

from __future__ import annotations

import bisect

PREFIX = "srps."


def joined(tl):
    """``(records, totals)`` of the program's store, each record with its
    host ``range`` ``(start, end)`` from ``tl``, or None."""
    try:
        from srmeetsps_cuda_tpu_torch import trace
    except ImportError:
        return None
    recs = trace.records()
    ranges = {}
    for a, b, name, cat, _ in tl.host:
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges.setdefault(name, []).append((a, b))
    seen = {}
    for r in recs:
        seen[r["name"]] = seen.get(r["name"], 0) + 1
    if not recs or seen != {k: len(v) for k, v in ranges.items()}:
        return None
    for r in recs:
        r["range"] = ranges[r["name"]][r["ordinal"]]
    return recs, trace.totals()


def of(recs, name):
    return [r for r in recs if r["name"] == name]


def launched(tl, ranges, cat):
    """The device events of category ``cat`` whose runtime call was made
    inside one of the host ``ranges`` (disjoint), wherever they ran."""
    events = sorted((d for d in tl.device if d[3] == cat),
                    key=lambda d: d[4])
    keys = [d[4] for d in events]
    out = []
    for a, b in ranges:
        out += events[bisect.bisect_left(keys, a):bisect.bisect_right(keys, b)]
    return out


def idle(tl, pieces):
    """``(idle, total)`` seconds over the host intervals ``pieces``: the
    time in them in which no device event runs."""
    busy, end = [], None
    for a, b, *_ in tl.device:  # sorted by start: merge the overlaps
        if busy and a <= end:
            end = max(end, b)
            busy[-1] = (busy[-1][0], end)
        else:
            busy.append((a, b))
            end = b
    starts = [a for a, _ in busy]
    total = covered = 0.0
    for a, b in pieces:
        total += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return total - covered, total


def less(outer, inner):
    """The interval ``outer`` less the disjoint intervals ``inner`` inside
    it, as a list of pieces."""
    out, t = [], outer[0]
    for a, b in sorted(inner):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < outer[1]:
        out.append((t, outer[1]))
    return out
