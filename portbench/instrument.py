"""The benchmark's wrappers around the program's calls: what the served path
produced (for the correctness check), and the spans of the traced run.

The program has no spans of its own yet, so each wrapper replaces a module
attribute that the served path looks up at call time, and puts it back on
exit. Each records into plain lists; nothing is read until the window has
closed.

* :class:`Capture` (every run): per fused serve chunk, the retrieval query,
  the top-k indices, the spliced prompt mask, the CLIP text ids and the
  greedy ids, as device tensors.
* :class:`Spans` (the traced run): host-clock spans around the dispatcher's
  chunks, the tokenizers and the greedy decode; ``record_function`` spans
  around image staging, the text tower and the T5 encoder, whose kernels the
  profiled slice attributes to them; and, while the profiler runs, a span
  with the call's shapes around each attention kernel call.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_local = threading.local()


class _Patch:
    """Replace attributes; put them back on :meth:`restore`."""

    def __init__(self):
        self._saved: List[tuple] = []

    def set(self, owner, attr: str, value) -> None:
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def restore(self) -> None:
        for owner, attr, value in reversed(self._saved):
            setattr(owner, attr, value)
        self._saved.clear()


class Capture:
    """Records of the fused serve chunks, oldest first, the last ``keep``
    of them. ``select`` maps a chunk's place in a pass (of ``keep`` chunks)
    to the rows whose greedy-step logits are kept (the LM head's output
    rows, ``vocab`` wide)."""

    def __init__(self, keep: int, select: Dict[int, List[int]],
                 vocab: int):
        from multimodalpromptretrieval_tpu_torch import serve
        from multimodalpromptretrieval_tpu_torch.models import t5

        self.records: collections.deque = collections.deque(maxlen=keep)
        self.calls = 0
        self._patch = _Patch()
        fused, topk, splice, dense = (serve.fused_serve_step, serve.l2_topk,
                                      serve.splice_hints, t5.dense)

        def fused_step(params, cfg, batch, *a, **kw):
            rec: Dict[str, Any] = {"clip_ids": batch["clip_text_ids"]}
            rows = select.get(self.calls % keep)
            if rows:
                rec["rows"] = torch.as_tensor(
                    rows, device=batch["q_ids"].device)
                rec["logits"] = []
                rec["prefix"] = batch["prefix"].index_select(0, rec["rows"])
            _local.rec = rec
            try:
                rec["ids"] = fused(params, cfg, batch, *a, **kw)
            finally:
                _local.rec = None
            self.records.append(rec)
            self.calls += 1
            return rec["ids"]

        def l2_topk(query, *a, **kw):
            d, i = topk(query, *a, **kw)
            rec = getattr(_local, "rec", None)
            if rec is not None:
                rec["query"], rec["idx"] = query, i
            return d, i

        def splice_hints(*a, **kw):
            ids, mask = splice(*a, **kw)
            rec = getattr(_local, "rec", None)
            if rec is not None:
                rec["mask"] = mask
            return ids, mask

        def lm_dense(x, weight, bias=None):
            y = dense(x, weight, bias)
            rec = getattr(_local, "rec", None)
            if (rec is not None and "rows" in rec and x.dim() == 2
                    and y.shape[-1] == vocab):
                rec["logits"].append(y.index_select(0, rec["rows"]))
            return y

        self._patch.set(serve, "fused_serve_step", fused_step)
        self._patch.set(serve, "l2_topk", l2_topk)
        self._patch.set(serve, "splice_hints", splice_hints)
        self._patch.set(t5, "dense", lm_dense)

    def restore(self) -> None:
        self._patch.restore()


class _Scope(torch.autograd.Function):
    """A host operation the profiler records around a kernel call made from
    Python (through ctypes), so that the kernels it launches are linked to
    the benchmark span that holds it."""

    @staticmethod
    def forward(ctx, thunk, anchor):
        return thunk()


class _Host:
    """Host-clock seconds and calls of one span."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self.lock = threading.Lock()

    def add(self, s: float) -> None:
        with self.lock:
            self.seconds += s
            self.calls += 1


class Spans:
    """The traced run's spans (module docstring). ``host`` and ``device``
    map a span name to its totals; :meth:`kernel_spans` adds the attention
    kernels' ``record_function`` spans and their shapes."""

    def __init__(self, exp):
        from multimodalpromptretrieval_tpu_torch import serve
        from multimodalpromptretrieval_tpu_torch.models import mprgen

        self.host: Dict[str, _Host] = collections.defaultdict(_Host)
        self.kernel_calls: List[dict] = []
        self._patch = _Patch()
        self._kernel_patch = _Patch()

        def host_span(name, fn):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function("pb." + name):
                        return fn(*a, **kw)
                finally:
                    self.host[name].add(time.perf_counter() - t0)
            return wrapped

        def span(name, fn):
            def wrapped(*a, **kw):
                with torch.profiler.record_function("pb." + name):
                    return fn(*a, **kw)
            return wrapped

        p = self._patch
        p.set(serve.MPRServer, "_run_chunk",
              host_span("server.chunk", serve.MPRServer._run_chunk))
        for owner, attr in ((exp.tokenizer, "encode_rows"),
                            (exp.tokenizer, "decode"),
                            (exp.clip_tokenizer, "tokenize")):
            p.set(owner, attr, host_span("host_text", getattr(owner, attr)))
        p.set(serve, "image_embed_prefix_step",
              span("clip.vit", serve.image_embed_prefix_step))
        p.set(serve, "clip_encode_text",
              span("clip.text", serve.clip_encode_text))
        p.set(mprgen, "t5_encode", span("t5.encode", mprgen.t5_encode))
        p.set(mprgen, "t5_greedy_decode",
              host_span("t5.decode", mprgen.t5_greedy_decode))

    def kernel_spans(self) -> None:
        """Spans with shapes around each row- and decode-attention call,
        for the profiled slice."""
        from multimodalpromptretrieval_tpu_torch.models import clip, t5

        calls = self.kernel_calls

        def row(fn):
            def wrapped(qkv, *a, **kw):
                B, L, W3 = qkv.shape
                heads = kw.get("heads")
                bias = a[0] if a else kw.get("bias")
                mask = a[1] if len(a) > 1 else kw.get("kv_mask")
                with torch.profiler.record_function("pb.kernel.row_attention"):
                    out = _Scope.apply(lambda: fn(qkv, *a, **kw), qkv)
                calls.append({"kernel": "row_attention", "B": B, "L": L,
                              "W": W3 // 3, "heads": heads,
                              "itemsize": qkv.element_size(),
                              "causal": bool(kw.get("causal", False)),
                              "bias": bias, "mask": mask,
                              "lengths": getattr(_local, "text_lengths",
                                                 None)})
                return out
            return wrapped

        def decode_for(fn):
            def make(impl):
                attend = fn(impl)
                state = {"self": 0}

                def wrapped(q, k, v, *a, bias=None, kv_mask=None, heads=1,
                            **kw):
                    with torch.profiler.record_function(
                            "pb.kernel.decode_attention"):
                        out = _Scope.apply(
                            lambda: attend(q, k, v, *a, bias=bias,
                                           kv_mask=kv_mask, heads=heads, **kw),
                            q)
                    rec = {"kernel": "decode_attention", "B": q.shape[0],
                           "W": q.shape[1], "heads": heads,
                           "itemsize": q.element_size()}
                    if kv_mask is None:  # self-attention at step t
                        rec["step_call"] = state["self"]
                        rec["bias_bytes"] = (bias.numel()
                                             * bias.element_size())
                        state["self"] += 1
                    else:
                        rec["mask"] = kv_mask
                    calls.append(rec)
                    return out
                return wrapped
            return make

        kp = self._kernel_patch
        for mod in (t5, clip):
            kp.set(mod, "row_attention_packed",
                   row(mod.row_attention_packed))
        kp.set(t5, "decode_attention_for", decode_for(t5.decode_attention_for))

        # the text tower's rows end at their EOT token: row attention there
        # needs only that many keys
        from multimodalpromptretrieval_tpu_torch import serve
        text = serve.clip_encode_text

        def clip_text(params, cfg, ids):
            _local.text_lengths = ids.argmax(dim=-1) + 1
            try:
                return text(params, cfg, ids)
            finally:
                _local.text_lengths = None

        kp.set(serve, "clip_encode_text", clip_text)

    def end_kernel_spans(self) -> None:
        self._kernel_patch.restore()

    def restore(self) -> None:
        self._kernel_patch.restore()
        self._patch.restore()

    def totals(self) -> Dict[str, dict]:
        """Span name -> {"host_s", "calls"}."""
        return {name: {"host_s": h.seconds, "calls": h.calls}
                for name, h in self.host.items()}


def row_keys(mask: Optional[torch.Tensor], B: int, L: int) -> List[int]:
    """Valid keys a row of a (B, L) {0, 1} mask."""
    if mask is None:
        return [L] * B
    return mask.long().sum(dim=-1).tolist()
