"""Share (%) of the routed experts' (token, slot) rows that K10 sent
through its 128-row ``wgmma`` kernels: the program's ``moe.rows_wgmma``
counter over its ``moe.rows``, in the traced window; 0 where the program
counts rows but none through those kernels."""


def read(ctx):
    prog = (ctx.get("spans") or {}).get("program") or {}
    counters = prog.get("counters", {})
    rows = counters.get("moe.rows", 0)
    if not rows:
        return None
    return 100.0 * counters.get("moe.rows_wgmma", 0) / rows
