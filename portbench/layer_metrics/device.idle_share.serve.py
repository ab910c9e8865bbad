"""The share (%) of the traced slice's wall time in which no kernel or
copy ran on the card (the union of the profiler's device intervals). The
profiler stretches the slice, so this overstates the unprofiled share."""


def read(ctx):
    p = ctx.get("profile")
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
