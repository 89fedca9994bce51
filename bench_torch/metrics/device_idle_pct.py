"""The device's idle share: the part of the profiled pass's window that
no kernel, copy or set covers."""


def read(ctx):
    a, b = ctx.window
    if b <= a:
        return None
    return 100.0 * (1.0 - ctx.timeline.busy(a, b) / (b - a))
