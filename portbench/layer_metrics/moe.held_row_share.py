"""Share (%) of the routed (token, expert) rows that went to the experts
this chip holds: the program's ``moe.rows_held`` counter over its
``moe.rows`` (every row the router sent), in the traced window. One rank's share of an
expert-parallel deployment reads about 1 / ranks; a share path that
computes absent experts, or drops held ones, moves it."""


def read(ctx):
    prog = (ctx.get("spans") or {}).get("program") or {}
    counters = prog.get("counters", {})
    routed = counters.get("moe.rows", 0)
    if not routed or "moe.rows_held" not in counters:
        return None
    return 100.0 * counters["moe.rows_held"] / routed
