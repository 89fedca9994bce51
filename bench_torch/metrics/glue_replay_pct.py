"""The outer iteration's glue replayed from CUDA graphs: the program's
``glue_replays`` counter (the lanes whose glue an ``srps.iteration`` span
replayed) over the lane-iterations of the profiled pass (a span's
``lanes``), in %. Nothing where the program counts no replays."""

from bench_torch import spans


def read(ctx):
    got = spans.joined(ctx.timeline)
    if got is None:
        return None
    its = spans.of(got[0], "srps.iteration")
    if not any("glue_replays" in r["counts"] for r in its):
        return None
    lanes = sum(r["attrs"].get("lanes", 1) for r in its)
    return 100.0 * sum(r["counts"].get("glue_replays", 0)
                       for r in its) / lanes
