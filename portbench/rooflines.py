"""Each kernel's share of its roofline over the traced slice.

For every call of a kernel wrapped in the slice (``instrument.Spans.
kernel_spans``), the operations and bytes its inputs need
(``portbench/work.py``) give its least time at the card's published peaks
(``portbench/peaks.py``); their sum over the device time of the kernels
those calls launched (``profiling.analyze``'s span attribution) is the
share. A kernel with no attributed device time gets no share.
"""

from __future__ import annotations

from typing import Dict, List

from portbench import instrument, peaks, work

_PEAK_BY_ITEMSIZE = {2: peaks.PEAK_FLOPS["bfloat16"],
                     4: peaks.PEAK_FLOPS["float32"]}


def _call_work(config: dict, call: dict):
    heads, W = call["heads"], call["W"]
    Dh = W // heads
    size = call["itemsize"]
    if call["kernel"] == "row_attention":
        mask, bias = call["mask"], call["bias"]
        if call["causal"] and call["lengths"] is not None:
            lengths = call["lengths"].tolist()
        else:
            lengths = instrument.row_keys(mask, call["B"], call["L"])
        return work.row_attention_work(
            heads, Dh, lengths, size, call["causal"],
            bias_bytes=0 if bias is None else bias.numel() * bias.element_size(),
            mask_bytes=0 if mask is None else mask.numel() * mask.element_size())
    if "mask" in call:  # cross-attention over the encoder states
        mask = call["mask"]
        keys = instrument.row_keys(mask, call["B"], mask.shape[1])
        return work.decode_attention_work(
            heads, Dh, keys, size,
            mask_bytes=mask.numel() * mask.element_size())
    t = call["step_call"] // config["t5"]["num_decoder_layers"]
    return work.decode_attention_work(heads, Dh, [t + 1] * call["B"], size,
                                      bias_bytes=call["bias_bytes"])


def shares(config: dict, calls: List[dict], spans: Dict[str, dict]
           ) -> Dict[str, dict]:
    """kernel -> {"share" (%), "bound" ("bytes" or "operations": which
    holds for most of the least time), "bound_s", "device_s", "calls"}."""
    out: Dict[str, dict] = {}
    for call in calls:
        flops, nbytes = _call_work(config, call)
        least, which = peaks.bound(nbytes, flops,
                                   _PEAK_BY_ITEMSIZE[call["itemsize"]])
        rec = out.setdefault(call["kernel"], {"bound_s": 0.0, "calls": 0,
                                              "bytes_s": 0.0, "ops_s": 0.0})
        rec["bound_s"] += least
        rec["calls"] += 1
        rec["bytes_s" if which == "bytes" else "ops_s"] += least
    for name, rec in out.items():
        span = spans.get("pb.kernel." + name, {})
        rec["device_s"] = span.get("device_s", 0.0)
        rec["kernels"] = span.get("kernels", 0)
        rec["spans"] = span.get("calls", 0)
        rec["bound"] = ("bytes" if rec["bytes_s"] >= rec["ops_s"]
                        else "operations")
        rec["share"] = (100.0 * rec["bound_s"] / rec["device_s"]
                        if rec["device_s"] > 0 and rec["kernels"] else None)
    return out
