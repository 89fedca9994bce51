"""The depth CG's work: the program's ``cg_iters`` counter (the kernel's
own iteration count of each lane) summed over the ``srps.depth_cg`` spans
of the profiled pass, per lane-solve (a span's ``lanes``)."""

from bench_torch import spans


def read(ctx):
    got = spans.joined(ctx.timeline)
    if got is None:
        return None
    cg = spans.of(got[0], "srps.depth_cg")
    solves = sum(r["attrs"].get("lanes", 1) for r in cg)
    if not solves:
        return None
    return sum(r["counts"].get("cg_iters", 0) for r in cg) / solves
