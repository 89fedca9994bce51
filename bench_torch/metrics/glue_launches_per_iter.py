"""The outer iteration's glue: the kernels launched inside the
outer-iteration ranges less those launched inside the ``depth_cg``
ranges, per lane-iteration executed, from the profiled pass. A kernel
belongs to the range of the runtime call that launched it (the
profiler's correlation id), not to where it ran, so the count repeats
exactly for the same captures."""


def read(ctx):
    tl = ctx.timeline
    its = tl.ranges("iteration")
    lanes = sum(s.info["lanes"] for s in ctx.prof.of("iteration"))
    if not its or not lanes:
        return None
    n = (sum(len(tl.kernels_in(a, b)) for a, b in its)
         - sum(len(tl.kernels_in(a, b)) for a, b in tl.ranges("depth_cg")))
    return n / lanes
