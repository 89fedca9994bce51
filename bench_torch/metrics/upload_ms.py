"""Preprocessing's upload: the device time of the copies launched inside
the program's ``srps.prepare.upload`` ranges (the moves of a capture's
host arrays), per capture (``srps.prepare`` range), from the profiled
pass."""

from bench_torch import spans


def read(ctx):
    tl = ctx.timeline
    got = spans.joined(tl)
    if got is None or not tl.device:
        return None
    recs = got[0]
    captures = len(spans.of(recs, "srps.prepare"))
    ups = [r["range"] for r in spans.of(recs, "srps.prepare.upload")]
    copies = spans.launched(tl, ups, "gpu_memcpy")
    if not captures or not copies:
        return None
    return 1e3 * sum(b - a for a, b, *_ in copies) / captures
