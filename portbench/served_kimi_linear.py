"""What the serving driver of the Kimi-Linear configurations adds to
``portbench/served_lm.py`` (which it reuses by import): the experiment
built from the published Kimi-Linear keys, the spans of the KDA kernels
and of the held expert share in the traced run, the work a chunk needs,
and the check against ``reference/kimi_linear.py``.

A configuration file holds the language model's published ``config.json``
keys at its top level in Kimi-Linear's own names (``num_experts`` the
experts held here, ``linear_attn_config``, ``mla_use_nope``, ...), with
``ep_size`` (the ranks of the expert-parallel deployment; this chip holds
rank 0's experts), the CLIP tower under ``clip`` and ``settings`` as an LM
configuration's.

The check is ``served_lm.check``, with two differences: the reference is
``reference/kimi_linear.py`` (KDA as its recurrence, MLA without rotation,
the same expert share), and a row's prefill columns lie at the right end
of its row ([pads || prefix || prompt]: the program puts a KDA model's pads
first), which is where the program's routing choices are read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Dict, List

import torch

from portbench import instrument, served, served_lm, work, work_kda
from portbench.reference import kimi_linear as ref_kl

# top-level keys of a configuration file that are not the LM's
NOT_LM = ("name", "source", "clip", "settings", "reduced", "assumed",
          "deployment")


def lm_keys(config: dict) -> dict:
    """The LM's config: the file's published keys with its ``lm_knobs``
    (``LMConfig.from_dict`` maps the names and ignores the rest)."""
    keys = {k: v for k, v in config.items() if k not in NOT_LM}
    keys.update(config["settings"].get("lm_knobs", {}))
    return keys


def model_config(config: dict):
    """The program's ``MPRGenConfig`` of a Kimi-Linear configuration; a
    program whose LM config does not take its KDA layers and expert share
    raises at once (it would run another model)."""
    from multimodalpromptretrieval_tpu_torch.models.moe_lm import LMConfig

    lm = LMConfig.from_dict(lm_keys(config))
    want = (tuple(config["linear_attn_config"]["kda_layers"]),
            config["ep_size"], config["num_experts"])
    got = (tuple(getattr(lm, "kda_layers", ())), getattr(lm, "ep_size", 1),
           lm.n_routed_experts)
    if got != want:
        raise RuntimeError(f"the program's LM config reads {got} of "
                           f"(kda_layers, ep_size, num_experts) {want}: it "
                           "does not run this configuration")
    return dataclasses.replace(served_lm.model_config(config), lm=lm)


def port_config(config: dict, seed: int) -> dict:
    """The program's experiment config of a Kimi-Linear configuration."""
    cfg = served_lm.port_config(config, seed)
    cfg["lm_overrides"] = lm_keys(config)
    return cfg


def build(config: dict, workload: dict, seed: int, device,
          parts: Dict[str, float]):
    """(experiment, server, splits, images); the weights made on
    ``device`` from ``seed`` (``weights_kimi_linear``)."""
    from multimodalpromptretrieval_tpu_torch import serve, serving
    from portbench.weights_kimi_linear import make_weights

    with served.timed(parts, "traffic"):
        traffic = importlib.import_module(
            "portbench.traffic." + workload["traffic"]["generator"])
        splits, images = traffic.generate(workload["traffic"], seed)
    mcfg = model_config(config)
    with served.timed(parts, "weights"):
        model = make_weights(mcfg, seed, device)
    with served.timed(parts, "experiment"):
        exp = serving.ServingExperiment(
            port_config(config, seed), train=splits["train"],
            validate=splits["validate"], test=splits["test"], images=images,
            params=model, device=device)
    if (exp.model_cfg.lm, exp.model_cfg.clip) != (mcfg.lm, mcfg.clip):
        raise RuntimeError("the program's model config differs from the "
                           "configuration file's")
    with served.timed(parts, "server"):
        server = serve.MPRServer(
            exp, load_checkpoint=False,
            pipeline_depth=workload["driver_args"]["pipeline_depth"])
    return exp, server, splits, images


class Spans(served_lm.Spans):
    """``served_lm.Spans``, and in the profiled slice
    ``pb.kernel.kda_prefill`` / ``pb.kernel.kda_decode`` around K12 / K13
    and ``pb.kernel.moe_experts`` around the held share's K10 calls, whose
    least times (``work_kda``: the held rows and experts only) go under
    ``totals()["lm_kernels"]`` once the slice has closed."""

    def __init__(self, exp):
        super().__init__(exp)
        self.kl_calls: List[dict] = []

    def kernel_spans(self) -> None:
        super().kernel_spans()
        from multimodalpromptretrieval_tpu_torch.ops import kda, moe

        calls = self.kl_calls
        held, prefill, decode = (moe.moe_experts_held, kda.kda_prefill,
                                 kda.kda_decode)

        def moe_experts_held(h, idx, w, gate_up, down, first, routed):
            with torch.profiler.record_function("pb.kernel.moe_experts"):
                out = instrument._Scope.apply(
                    lambda: held(h, idx, w, gate_up, down, first, routed), h)
            calls.append({"kernel": "moe_experts", "idx": idx,
                          "first": first, "held": gate_up.shape[0],
                          "d": h.shape[-1], "width": down.shape[-1],
                          "itemsize": h.element_size()})
            return out

        def kda_prefill(q, k, v, g, beta, valid, state, scale, taps):
            with torch.profiler.record_function("pb.kernel.kda_prefill"):
                out = instrument._Scope.apply(
                    lambda: prefill(q, k, v, g, beta, valid, state, scale,
                                    taps), q)
            calls.append({"kernel": "kda_prefill", "valid": valid,
                          "heads": q.shape[2], "K": q.shape[-1],
                          "V": v.shape[-1], "itemsize": q.element_size(),
                          "taps": taps.shape[-1]})
            return out

        def kda_decode(q, k, v, g, beta, state, scale, out=None):
            with torch.profiler.record_function("pb.kernel.kda_decode"):
                o = instrument._Scope.apply(
                    lambda: decode(q, k, v, g, beta, state, scale, out), q)
            calls.append({"kernel": "kda_decode", "rows": q.shape[0],
                          "heads": q.shape[1], "K": q.shape[-1],
                          "V": v.shape[-1], "itemsize": q.element_size()})
            return o

        self._kernel_patch.set(moe, "moe_experts_held", moe_experts_held)
        self._kernel_patch.set(kda, "kda_prefill", kda_prefill)
        self._kernel_patch.set(kda, "kda_decode", kda_decode)

    def end_kernel_spans(self) -> None:
        super().end_kernel_spans()
        from portbench import peaks

        peak = {2: peaks.PEAK_FLOPS["bfloat16"],
                4: peaks.PEAK_FLOPS["float32"]}
        out: Dict[str, dict] = {}
        for call in self.kl_calls:
            if call["kernel"] == "moe_experts":
                flops, nbytes = work_kda.moe_held_work(
                    call["d"], call["width"], call["idx"], call["first"],
                    call["held"], call["itemsize"])
            elif call["kernel"] == "kda_prefill":
                flops, nbytes = work_kda.kda_prefill_work(
                    call["valid"].long().sum(dim=1).tolist(), call["heads"],
                    call["K"], call["V"], call["itemsize"], call["taps"])
            else:
                flops, nbytes = work_kda.kda_decode_work(
                    call["rows"], call["heads"], call["K"], call["V"],
                    call["itemsize"])
            least, which = peaks.bound(nbytes, flops, peak[call["itemsize"]])
            rec = out.setdefault(call["kernel"], {"bound_s": 0.0, "calls": 0,
                                                  "bytes_s": 0.0,
                                                  "ops_s": 0.0})
            rec["bound_s"] += least
            rec["calls"] += 1
            rec["bytes_s" if which == "bytes" else "ops_s"] += least
        self.kl_calls.clear()
        if self._totals is not None:
            self._totals.setdefault("lm_kernels", {}).update(out)


def chunk_flops(config: dict, rec: dict, index_rows: int) -> float:
    """A fused chunk's operations: the text tower to each question's EOT,
    the distances to the index, the LM's prefill over each row's prefix
    and prompt (``work_kda``), and the steps each row ran to its EOS."""
    clip = config["clip"]
    B = rec["ids"].shape[0]
    prefix = (clip["image_resolution"] // clip["patch_size"]) ** 2 + 1
    lengths = [int(x) + prefix
               for x in rec["mask"].long().sum(dim=-1).tolist()]
    steps = served.steps_until_eos(rec["ids"].cpu().numpy(),
                                   config["settings"]["lm_knobs"][
                                       "eos_token_id"])
    return (work.clip_text_flops(clip, [int(x) for x in (
        rec["clip_ids"].long().argmax(dim=-1) + 1).tolist()])
            + work.l2_flops(B, index_rows, 2 * clip["embed_dim"])
            + work_kda.lm_prefill_flops(config, lengths)
            + work_kda.lm_decode_flops(config, lengths, steps))


def _row_routes(rec: dict, k: int, n_moe: int, S: int,
                prompt_len: int, prefix: int) -> List[torch.Tensor]:
    """``served_lm._row_routes`` for rows whose pads come first: the
    prefill's valid columns are its last prefix + prompt ones."""
    routes = rec["routes"]
    out = []
    for m in range(n_moe):
        pre = routes[m][k]  # (L, top_k)
        parts = [pre[pre.shape[0] - prefix - prompt_len:]]
        parts += [routes[n_moe * s + m][k][None] for s in range(1, S)]
        out.append(torch.cat(parts).long())
    return out


@contextlib.contextmanager
def _kimi_linear_check():
    patch = instrument._Patch()
    patch.set(served_lm, "ref_lm", ref_kl)
    patch.set(served_lm, "_row_routes", _row_routes)
    try:
        yield
    finally:
        patch.restore()


def check(*args, **kw):
    """``served_lm.check`` (its arguments and readings) against
    ``reference/kimi_linear.py``, the routes read at the pads-first
    columns."""
    with _kimi_linear_check():
        return served_lm.check(*args, **kw)
