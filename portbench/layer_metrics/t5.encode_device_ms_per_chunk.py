"""Device ms of the T5 encoder a chunk, in the traced slice: the kernels
launched inside ``t5_encode``."""


def read(ctx):
    p = ctx.get("profile")
    span = p["spans"].get("pb.t5.encode") if p else None
    if not span or not span["calls"] or not span["kernels"]:
        return None
    return 1e3 * span["device_s"] / span["calls"]
