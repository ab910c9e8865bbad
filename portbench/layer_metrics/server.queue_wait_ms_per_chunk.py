"""Host-clock ms a chunk waits in the dispatcher's queue: from its
submission to the dispatcher until its device work starts
(``mpr.serve.queue_wait``, the program's span), over the window's
chunks."""


def read(ctx):
    span = (ctx.get("program") or {}).get("spans", {}).get(
        "mpr.serve.queue_wait")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["total_s"] / span["calls"]
