"""Host reads of the outer loop: the program's ``host_reads`` counter
(each wait of the host for the device: a tensor's value read, a
synchronise) over the profiled pass, per outer iteration the loops ran
(``srps.iteration`` spans; one per batch iteration in lockstep)."""

from bench_torch import spans


def read(ctx):
    got = spans.joined(ctx.timeline)
    if got is None:
        return None
    recs, totals = got
    iters = len(spans.of(recs, "srps.iteration"))
    if not iters:
        return None
    return totals.get("host_reads", 0) / iters
