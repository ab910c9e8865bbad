"""The absorbed latent decode attention's share of its roofline (%): the
least time of the work its calls' inputs need (``portbench/work_lm.py``:
each row's cache of valid tokens read once, q and the output once a head)
over the device time of what ``ops.mla.mla_decode_attention`` launched
(``pb.kernel.mla_decode``), in the traced slice."""


def read(ctx):
    rec = ((ctx.get("spans") or {}).get("lm_kernels") or {}).get(
        "mla_decode")
    p = ctx.get("profile")
    span = p["spans"].get("pb.kernel.mla_decode") if p else None
    if not rec or not span or not span["kernels"] or span["device_s"] <= 0:
        return None
    return 100.0 * rec["bound_s"] / span["device_s"]
