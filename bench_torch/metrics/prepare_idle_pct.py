"""Preprocessing's device idle share: the part of the program's
``srps.prepare`` ranges in which no kernel, copy or set runs on the
device, from the profiled pass."""

from bench_torch import spans


def read(ctx):
    tl = ctx.timeline
    got = spans.joined(tl)
    if got is None or not tl.device:
        return None
    idle, total = spans.idle(
        tl, [r["range"] for r in spans.of(got[0], "srps.prepare")])
    if total <= 0:
        return None
    return 100.0 * idle / total
