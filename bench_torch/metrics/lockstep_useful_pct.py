"""Lockstep batching's useful work: the lanes' own outer iterations over
the lane-iterations the batch computed (B times the loop's iterations: a
lane that has stopped is computed on until the last one stops), from the
spans pass's answers. Nothing to read at batch 1."""


def read(ctx):
    batches = [r for r in ctx.records if len(r.iterations) > 1]
    if not batches:
        return None
    own = sum(sum(r.iterations) for r in batches)
    computed = sum(len(r.iterations) * max(r.iterations) for r in batches)
    return 100.0 * own / computed
