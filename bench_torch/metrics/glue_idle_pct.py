"""The outer iteration's glue, device idle share: the part of the
program's ``srps.iteration`` ranges, less the ``srps.depth_cg`` ranges
inside them, in which no kernel, copy or set runs on the device, from the
profiled pass."""

from bench_torch import spans


def read(ctx):
    tl = ctx.timeline
    got = spans.joined(tl)
    if got is None or not tl.device:
        return None
    recs = got[0]
    cg = {}
    for r in spans.of(recs, "srps.depth_cg"):
        if r["parent"] and r["parent"][0] == "srps.iteration":
            cg.setdefault(r["parent"][1], []).append(r["range"])
    pieces = [p for r in spans.of(recs, "srps.iteration")
              for p in spans.less(r["range"], cg.get(r["ordinal"], []))]
    idle, total = spans.idle(tl, pieces)
    if total <= 0:
        return None
    return 100.0 * idle / total
