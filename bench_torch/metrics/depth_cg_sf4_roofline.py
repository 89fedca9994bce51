"""The sf = 4 depth CG's share of its roofline: the least time of the CG
work that each ``depth_cg`` call needed (``roofline_sf4.py``, from the
mask's pixels and the CG iterations of each lane) over the device time of
the kernels launched inside the program's ``srps.depth_cg`` ranges, from
the profiled pass. Nothing where any of those ranges records another
``sf`` than 4, or none (a program whose spans carry no ``sf``)."""

from bench_torch import roofline_sf4, spans


def read(ctx):
    got = spans.joined(ctx.timeline)
    if got is None:
        return None
    cg = spans.of(got[0], "srps.depth_cg")
    solves = ctx.prof.of("depth_cg")
    if not cg or len(cg) != len(solves) or \
            any(r["attrs"].get("sf") != 4 for r in cg):
        return None
    device = sum(b - a for r in cg
                 for a, b, *_ in ctx.timeline.kernels_in(*r["range"]))
    least = sum(roofline_sf4.least_seconds(px, it)[0]
                for s in solves
                for px, it in zip(s.info["pixels"], s.info["iters"]))
    if device <= 0:
        return None
    return 100.0 * least / device
