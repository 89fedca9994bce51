"""Preprocessing's inpaint: the kernels launched inside the program's
``srps.prepare.inpaint`` ranges, per capture (``srps.prepare`` range),
from the profiled pass."""

from bench_torch import spans


def read(ctx):
    tl = ctx.timeline
    got = spans.joined(tl)
    if got is None or not tl.device:
        return None
    recs = got[0]
    captures = len(spans.of(recs, "srps.prepare"))
    ranges = [r["range"] for r in spans.of(recs, "srps.prepare.inpaint")]
    if not captures or not ranges:
        return None
    return len(spans.launched(tl, ranges, "kernel")) / captures
