"""Host-clock ms of an LM greedy step: the program's ``mpr.lm.decode``
span (the steps after the prefill, a host EOS check each) over its
``lm.decode_steps`` counter, in the traced window."""


def read(ctx):
    prog = (ctx.get("spans") or {}).get("program") or {}
    span = prog.get("spans", {}).get("mpr.lm.decode")
    steps = prog.get("counters", {}).get("lm.decode_steps", 0)
    if not span or not steps:
        return None
    return 1e3 * span["total_s"] / steps
