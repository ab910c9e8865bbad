"""The KDA chunked prefill's share of its roofline (%): the least time of
the work its calls' inputs need (``portbench/work_kda.py``: the chunk
form's products over each row's valid tokens at the bf16 tensor peak, its
inputs and outputs once, the final state written once) over the device
time of what ``ops.kda.kda_prefill`` launched (``pb.kernel.kda_prefill``),
in the traced slice."""


def read(ctx):
    rec = ((ctx.get("spans") or {}).get("lm_kernels") or {}).get(
        "kda_prefill")
    p = ctx.get("profile")
    span = p["spans"].get("pb.kernel.kda_prefill") if p else None
    if not rec or not span or not span["kernels"] or span["device_s"] <= 0:
        return None
    return 100.0 * rec["bound_s"] / span["device_s"]
