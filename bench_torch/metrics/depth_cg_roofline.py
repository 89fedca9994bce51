"""The depth CG's share of its roofline: the least time of the CG work
that each ``depth_cg`` call needed (``roofline.py``, from the mask's
pixels and the CG iterations of each lane) over the device time of the
kernels launched inside its ranges, from the profiled pass."""

from bench_torch import roofline


def read(ctx):
    tl = ctx.timeline
    ranges = tl.ranges("depth_cg")
    spans = ctx.prof.of("depth_cg")
    if not ranges or len(ranges) != len(spans):
        return None
    device = sum(b - a for r in ranges for a, b, *_ in tl.kernels_in(*r))
    least = sum(roofline.least_seconds(px, it)[0]
                for s in spans
                for px, it in zip(s.info["pixels"], s.info["iters"]))
    if device <= 0:
        return None
    return 100.0 * least / device
