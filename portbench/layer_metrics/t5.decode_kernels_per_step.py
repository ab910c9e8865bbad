"""Device operations (kernels of the port, cuBLAS and elementwise kernels,
copies) a greedy decode step launches: those launched inside
``mpr.t5.decode.step`` (the program's span) in the traced slice, over
those spans."""


def read(ctx):
    p = ctx.get("program_profile")
    span = p["spans"].get("mpr.t5.decode.step") if p else None
    if not span or not span["calls"] or not span["kernels"]:
        return None
    return span["kernels"] / span["calls"]
