"""Host-clock ms the server's dispatcher thread spends on a chunk: its
device work queued and its ids fetched (``MPRServer._run_chunk``)."""


def read(ctx):
    span = ctx.get("spans", {}).get("server.chunk")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["host_s"] / span["calls"]
