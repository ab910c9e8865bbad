"""Host-clock ms of a greedy decode step: ``t5_greedy_decode``'s wall time
(it syncs on the host after every step) over the steps it ran (the
server's ``decode_steps``)."""


def read(ctx):
    span = ctx.get("spans", {}).get("t5.decode")
    steps = ctx["stats"].get("decode_steps", 0)
    if not span or not steps:
        return None
    return 1e3 * span["host_s"] / steps
