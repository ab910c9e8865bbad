"""Share (%) of the LM's greedy steps run by replaying the step's CUDA
graphs: the program's ``lm.decode_graph_steps`` counter over its
``lm.decode_steps``, in the traced window; 0 where the program counts
steps but no graph step."""


def read(ctx):
    prog = (ctx.get("spans") or {}).get("program") or {}
    counters = prog.get("counters", {})
    steps = counters.get("lm.decode_steps", 0)
    if not steps:
        return None
    return 100.0 * counters.get("lm.decode_graph_steps", 0) / steps
