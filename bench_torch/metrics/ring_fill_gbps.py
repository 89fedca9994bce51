"""The host's fill of the card's pinned staging ring: the program's
``h2d_pinned_bytes`` counter (the bytes moved through the ring) over its
``h2d_fill_ns`` (the host's time copying them into the ring's slots), in
the profiled pass, in GB/s. Nothing where the program counts no fill
time, or no bytes."""

from bench_torch import spans


def read(ctx):
    got = spans.joined(ctx.timeline)
    if got is None:
        return None
    totals = got[1]
    if not totals.get("h2d_fill_ns") or not totals.get("h2d_pinned_bytes"):
        return None
    return totals["h2d_pinned_bytes"] / totals["h2d_fill_ns"]
