"""The decode attention's (K6 / K7) share of its roofline (%): the least
time of the work its calls' inputs need (self-attention over the t + 1
tokens decoded so far, cross-attention over each row's unpadded encoder
states, each byte once) over the device time of the kernels those calls
launched, in the traced slice (``portbench/rooflines.py``)."""


def read(ctx):
    rec = ctx.get("kernels", {}).get("decode_attention")
    return None if rec is None else rec["share"]
