"""Device us a question spends in the CLIP towers, in the traced slice: the
kernels launched inside image staging (the ViT, once per image) and the
text tower, over the questions the slice answered."""


def read(ctx):
    p, stats = ctx.get("profile"), ctx.get("profile_stats")
    if not p or not stats or not stats.get("answered"):
        return None
    vit, text = p["spans"].get("pb.clip.vit"), p["spans"].get("pb.clip.text")
    if not vit or not text or not vit["kernels"] or not text["kernels"]:
        return None
    return 1e6 * (vit["device_s"] + text["device_s"]) / stats["answered"]
