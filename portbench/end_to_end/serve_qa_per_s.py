"""Questions answered in the window over the window's seconds: all the
work over all the time, the window ending in a device sync."""


def read(ctx):
    stats = ctx["stats"]
    return stats["answered"] / stats["seconds"]
