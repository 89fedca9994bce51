"""Preprocessing's upload through pinned memory: the program's
``h2d_pinned_bytes`` counter (the bytes of a host array moved through the
card's pinned staging ring) over its ``h2d_bytes`` (every host array's
bytes moved), in the profiled pass, in %. Nothing where the program counts
no pinned bytes or moved none."""

from bench_torch import spans


def read(ctx):
    got = spans.joined(ctx.timeline)
    if got is None:
        return None
    totals = got[1]
    if "h2d_pinned_bytes" not in totals or not totals.get("h2d_bytes"):
        return None
    return 100.0 * totals["h2d_pinned_bytes"] / totals["h2d_bytes"]
