"""Host-clock ms a greedy decode step spends outside its host EOS check:
the self time of ``mpr.t5.decode.step`` (the program's span, its
``mpr.t5.decode.eos_sync`` child left out), over the window's steps. With
the card idle, this is the Python launch sequence of the step."""


def read(ctx):
    span = (ctx.get("program") or {}).get("spans", {}).get(
        "mpr.t5.decode.step")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["self_s"] / span["calls"]
