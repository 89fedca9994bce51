"""Preprocessing: the mean wall time of ``runtime.solver.prepare`` per
capture (the upload of the host arrays, ``pre/``, ``build_problem`` and
``init_state``), synchronised at both ends, from the spans pass."""


def read(ctx):
    spans = ctx.spans.of("prepare")
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
