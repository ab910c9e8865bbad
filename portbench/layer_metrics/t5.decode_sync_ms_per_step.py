"""Host-clock ms a greedy decode step waits in its host EOS check
(``mpr.t5.decode.eos_sync``, the program's span: the device finishing the
step and the flag's copy), over the window's steps
(``mpr.t5.decode.step``)."""


def read(ctx):
    spans = (ctx.get("program") or {}).get("spans", {})
    step, sync = spans.get("mpr.t5.decode.step"), spans.get(
        "mpr.t5.decode.eos_sync")
    if not step or not sync or not step["calls"]:
        return None
    return 1e3 * sync["total_s"] / step["calls"]
