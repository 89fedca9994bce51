"""The outer iteration's glue: the wall time of the outer-iteration spans
less that of the ``depth_cg`` spans inside them, per lane-iteration
executed (a lockstep batch computes every lane each iteration), from the
spans pass."""


def read(ctx):
    its = ctx.spans.of("iteration")
    lanes = sum(s.info["lanes"] for s in its)
    if not lanes:
        return None
    glue = (sum(s.seconds for s in its)
            - sum(s.seconds for s in ctx.spans.of("depth_cg")))
    return 1e3 * glue / lanes
