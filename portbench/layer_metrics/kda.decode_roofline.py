"""The KDA decode step's share of its roofline (%): the least time of the
work its calls' inputs need (``portbench/work_kda.py``: each (row, head)'s
fp32 state read and written once, q / k / v / g / beta in and o out, three
products over the state) over the device time of what
``ops.kda.kda_decode`` launched (``pb.kernel.kda_decode``), in the traced
slice."""


def read(ctx):
    rec = ((ctx.get("spans") or {}).get("lm_kernels") or {}).get(
        "kda_decode")
    p = ctx.get("profile")
    span = p["spans"].get("pb.kernel.kda_decode") if p else None
    if not rec or not span or not span["kernels"] or span["device_s"] <= 0:
        return None
    return 100.0 * rec["bound_s"] / span["device_s"]
