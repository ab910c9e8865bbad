"""The routed experts' share of their roofline (%): the least time of the
work their calls' inputs need (``portbench/work_lm.py``: each touched
expert's weights read once, the rows in and out, three products a row)
over the device time of what ``ops.moe.moe_experts`` launched
(``pb.kernel.moe_experts``), in the traced slice."""


def read(ctx):
    rec = ((ctx.get("spans") or {}).get("lm_kernels") or {}).get(
        "moe_experts")
    p = ctx.get("profile")
    span = p["spans"].get("pb.kernel.moe_experts") if p else None
    if not rec or not span or not span["kernels"] or span["device_s"] <= 0:
        return None
    return 100.0 * rec["bound_s"] / span["device_s"]
