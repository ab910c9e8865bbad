"""The share (%) of the traced slice's wall time in which the card is idle
waiting on a greedy decode step outside its EOS check: the idle gaps
whose closing operation was launched from a thread on which
``mpr.t5.decode.step`` was the innermost of the program's spans at the
gap's middle (``portbench/program_trace.py``)."""


def read(ctx):
    p = ctx.get("program_profile")
    if not p or not p["window_s"] or "mpr.t5.decode.step" not in p["spans"]:
        return None
    return 100.0 * p["idle"].get("mpr.t5.decode.step", 0.0) / p["window_s"]
