"""The served window's share (%) of the card's bf16 peak: the operations
the answered questions need (``portbench/work.py``: unpadded prompts, the
steps each row ran, attention over the tokens decoded so far) over the
unprofiled window's seconds, over 989 TFLOP/s."""


def read(ctx):
    from portbench.peaks import PEAK_FLOPS

    stats = ctx["stats"]
    if not ctx["cuda"] or not ctx.get("flops") or not stats["seconds"]:
        return None
    return 100.0 * ctx["flops"] / stats["seconds"] / PEAK_FLOPS["bfloat16"]
