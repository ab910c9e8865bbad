"""Device ms of the LM's prefill a chunk, in the traced slice: the kernels
launched inside ``moe_lm.lm_prefill`` (``pb.lm.prefill``: the non-absorbed
forward over [prefix || prompt], the latent cache written, the head at the
last position), over its calls."""


def read(ctx):
    p = ctx.get("profile")
    span = p["spans"].get("pb.lm.prefill") if p else None
    if not span or not span["calls"] or not span["kernels"]:
        return None
    return 1e3 * span["device_s"] / span["calls"]
