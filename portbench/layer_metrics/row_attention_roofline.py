"""K1's share of its roofline (%): the least time of the work its calls'
inputs need (unpadded rows, each byte once) over the device time of the
kernels those calls launched, in the traced slice
(``portbench/rooflines.py``)."""


def read(ctx):
    rec = ctx.get("kernels", {}).get("row_attention")
    return None if rec is None else rec["share"]
