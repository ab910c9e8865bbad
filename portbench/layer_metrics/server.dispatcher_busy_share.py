"""The share (%) of the window's seconds in which the server's dispatcher
thread runs a chunk: its device work queued and its ids fetched
(``mpr.serve.chunk``, the program's span)."""


def read(ctx):
    span = (ctx.get("program") or {}).get("spans", {}).get("mpr.serve.chunk")
    seconds = ctx["stats"].get("seconds")
    if not span or not span["calls"] or not seconds:
        return None
    return 100.0 * span["total_s"] / seconds
