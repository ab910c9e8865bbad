"""Host-clock ms a chunk spends in the tokenizers: the T5 prompt encode,
the answers' decode and the CLIP tokenize, on any thread."""


def read(ctx):
    span = ctx.get("spans", {}).get("host_text")
    if not span or not ctx.get("chunks"):
        return None
    return 1e3 * span["host_s"] / ctx["chunks"]
