"""What the serving drivers of the LM configurations share: the served
experiment with the LM generator, the capture of its logits and routing,
the spans of the traced run, the work a chunk needs, and the check that
decides ``correct``.

A configuration file of an LM cell holds the language model's published
``config.json`` keys at its top level, the CLIP tower under ``clip`` and
``settings`` (``compute_dtype``, ``batch_size``, ``k``, ``quantifier``,
``max_source_length``, ``clip_knobs``, ``lm_knobs``: the tokenizer's pad
and EOS ids).

The check (``portbench/reference``, float32 with TF32 off, after the
window, with the program's state freed) judges what the window's fused
chunks produced, from the benchmark's own inputs and weights, as
``served.check`` does for T5:

* ``query_err``, ``search_excess``, ``prefix_err``: as ``served.check``
  (the ViT prefix through the 512 -> hidden projection);
* ``logit_err``: for rows drawn from the seed over the whole pass (the
  longest question among them), the reference builds the prompt itself
  (its own tokenizer, the hint of the served top-k entries), runs the ViT,
  then the LM's full forward over [prefix || prompt || served tokens]
  (``reference/moe_lm.py``, teacher forcing), and compares the logits at
  the prompt's last token and each served token with the ones the served
  prefill and steps computed; the largest relative error;
* ``token_excess``: as ``served.check``;
* ``route_excess``: the (token, MoE layer) decisions of those rows, at
  the prefill and every step, where the program chose an expert that the
  reference ranks below its own k-th by more than the workload's
  ``route_tol`` (a decision within it is taken over by the reference and
  counted as a flip);
* ``route_flip_share``: the flips over the decisions. bf16 moves the
  experts of some near ties; a fault that moves more of them, all within
  ``route_tol`` (a router computed in bf16, a bias or a normalisation a
  little off), shows only here (``portbench/lm_route_control.py`` runs
  the program with its router in bf16).

``--control``: the reference with fp8 products in the program's place;
the exact reference takes its routing within ``route_tol`` as it takes
the program's.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import instrument, program_trace, served, work, work_lm
from portbench.reference import models as ref
from portbench.reference import moe_lm as ref_lm


def lm_keys(config: dict) -> dict:
    """The LM's config: the file's published keys with its ``lm_knobs``."""
    from multimodalpromptretrieval_tpu_torch.models.moe_lm import LMConfig

    names = {f.name for f in dataclasses.fields(LMConfig)}
    keys = {k: v for k, v in config.items() if k in names}
    keys.update(config["settings"].get("lm_knobs", {}))
    return keys


def model_config(config: dict):
    """The program's ``MPRGenConfig`` of an LM configuration file."""
    from multimodalpromptretrieval_tpu_torch.models.clip import CLIPConfig
    from multimodalpromptretrieval_tpu_torch.models.moe_lm import LMConfig
    from multimodalpromptretrieval_tpu_torch.models.mprgen import MPRGenConfig
    from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config

    s = config["settings"]
    return MPRGenConfig(
        t5=T5Config(),
        clip=dataclasses.replace(CLIPConfig(), **config["clip"],
                                 **s["clip_knobs"]),
        use_image_info=True, num_classes=0,
        max_source_length=s["max_source_length"], max_target_length=16,
        compute_dtype=s["compute_dtype"],
        lm=LMConfig.from_dict(lm_keys(config)))


def port_config(config: dict, seed: int) -> dict:
    """The program's experiment config of an LM configuration file."""
    from multimodalpromptretrieval_tpu_torch import serving

    s = config["settings"]
    cfg = serving.synthetic_config(
        batch_size=s["batch_size"], epochs=1, retrieval=True, k=s["k"],
        image_size=config["clip"]["image_resolution"])
    cfg.pop("t5_overrides", None)
    cfg.update(seed=seed, compute_dtype=s["compute_dtype"],
               quantifier=1 if s["quantifier"] else 0,
               max_source_length=s["max_source_length"], generator="lm",
               lm_overrides=lm_keys(config),
               clip_overrides={**config["clip"], **s["clip_knobs"]})
    return cfg


def build(config: dict, workload: dict, seed: int, device,
          parts: Dict[str, float]):
    """(experiment, server, splits, images) of an LM cell; the weights made
    on ``device`` from ``seed``."""
    from multimodalpromptretrieval_tpu_torch import serve, serving
    from portbench.weights_lm import make_weights

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


class Capture(instrument.Capture):
    """``instrument.Capture``'s records of the fused chunks, and for the
    rows it keeps: the LM head's logits at the prefill and each step
    (``"logits"``), and every MoE layer's routing choices, the prefill's
    (rows, L, k) then each step's (rows, k) in layer order
    (``"routes"``); device tensors, nothing read until the check."""

    def __init__(self, keep: int, select: Dict[int, List[int]], vocab: int):
        super().__init__(keep, select, vocab)
        from multimodalpromptretrieval_tpu_torch.models import moe_lm
        from multimodalpromptretrieval_tpu_torch.ops import moe

        head, route = moe_lm.lm_head, moe.route

        def lm_head(x, weight):
            y = head(x, weight)
            rec = getattr(instrument._local, "rec", None)
            if rec is not None and "rows" in rec:
                rec["logits"].append(y.index_select(0, rec["rows"]))
            return y

        def route_(h, *a, **kw):
            idx, w = route(h, *a, **kw)
            rec = getattr(instrument._local, "rec", None)
            if rec is not None and "rows" in rec:
                rec.setdefault("routes", []).append(
                    idx.index_select(0, rec["rows"]))
            return idx, w

        self._patch.set(moe_lm, "lm_head", lm_head)
        self._patch.set(moe, "route", route_)


class Spans(instrument.Spans):
    """``instrument.Spans``, and: ``pb.lm.prefill`` / ``pb.lm.decode``
    (host clock and device) around the LM's entry points; the program's
    own spans and counters on for the window, their totals under
    ``totals()["program"]``; in the profiled slice ``pb.kernel.
    moe_experts`` and ``pb.kernel.mla_decode`` around those calls, whose
    least times (``work_lm``) go under ``totals()["lm_kernels"]`` once the
    slice has closed. Its call records stay out of ``kernel_calls``."""

    def __init__(self, exp):
        super().__init__(exp)
        from multimodalpromptretrieval_tpu_torch.models import moe_lm

        self.lm_calls: List[dict] = []
        self._totals: Optional[dict] = None
        for name in ("prefill", "decode"):
            fn = getattr(moe_lm, "lm_" + name)
            self._patch.set(moe_lm, "lm_" + name,
                            self._host("lm." + name, fn))
        program_trace.enable(True)

    def _host(self, name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("pb." + name):
                    return fn(*a, **kw)
            finally:
                self.host[name].add(time.perf_counter() - t0)
        return wrapped

    def totals(self) -> Dict[str, dict]:
        out = super().totals()
        out["program"] = program_trace.snapshot()
        program_trace.enable(False)
        self._totals = out
        return out

    def kernel_spans(self) -> None:
        super().kernel_spans()
        from multimodalpromptretrieval_tpu_torch.ops import mla, moe

        calls = self.lm_calls
        experts, attend = moe.moe_experts, mla.mla_decode_attention

        def moe_experts(h, idx, w, gate_up, down):
            with torch.profiler.record_function("pb.kernel.moe_experts"):
                out = instrument._Scope.apply(
                    lambda: experts(h, idx, w, gate_up, down), h)
            calls.append({"kernel": "moe_experts", "idx": idx,
                          "d": h.shape[-1], "width": down.shape[-1],
                          "itemsize": h.element_size()})
            return out

        def mla_decode(q_lat, q_pe, cache, key_ok, length, scale):
            with torch.profiler.record_function("pb.kernel.mla_decode"):
                out = instrument._Scope.apply(
                    lambda: attend(q_lat, q_pe, cache, key_ok, length, scale),
                    q_lat)
            calls.append({"kernel": "mla_decode", "key_ok": key_ok,
                          "length": int(length), "heads": q_lat.shape[1],
                          "latent": q_lat.shape[-1], "rope": q_pe.shape[-1],
                          "itemsize": q_lat.element_size()})
            return out

        self._kernel_patch.set(moe, "moe_experts", moe_experts)
        self._kernel_patch.set(mla, "mla_decode_attention", mla_decode)

    def end_kernel_spans(self) -> None:
        super().end_kernel_spans()
        from portbench import peaks

        peak = {2: peaks.PEAK_FLOPS["bfloat16"],
                4: peaks.PEAK_FLOPS["float32"]}
        out: Dict[str, dict] = {}
        for call in self.lm_calls:
            if call["kernel"] == "moe_experts":
                idx = call["idx"]
                flops, nbytes = work_lm.moe_experts_work(
                    call["d"], call["width"], idx.numel(),
                    int(torch.unique(idx).numel()), call["itemsize"])
            else:
                keys = call["key_ok"][:, :call["length"]].long().sum(dim=1)
                flops, nbytes = work_lm.mla_decode_work(
                    call["heads"], call["latent"], call["rope"],
                    keys.tolist(), call["itemsize"])
            least, which = peaks.bound(nbytes, flops, peak[call["itemsize"]])
            rec = out.setdefault(call["kernel"], {"bound_s": 0.0, "calls": 0,
                                                  "bytes_s": 0.0,
                                                  "ops_s": 0.0})
            rec["bound_s"] += least
            rec["calls"] += 1
            rec["bytes_s" if which == "bytes" else "ops_s"] += least
        self.lm_calls.clear()
        if self._totals is not None:
            self._totals["lm_kernels"] = out

    def restore(self) -> None:
        program_trace.enable(False)
        super().restore()


# ---------------------------------------------------------------------------
# Work
# ---------------------------------------------------------------------------


def staging_flops(config: dict, n_images: int) -> float:
    """The ViT over the staged images, every token through the 512 ->
    hidden projection."""
    return work.vit_flops(config["clip"], n_images, config["hidden_size"])


def chunk_flops(config: dict, rec: dict, index_rows: int) -> float:
    """A fused chunk's operations: the text tower to each question's EOT,
    the distances to the index, the LM's prefill over each row's prefix
    and prompt, and the steps each row ran to its EOS."""
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
            + work_lm.lm_prefill_flops(config, lengths)
            + work_lm.lm_decode_flops(config, lengths, steps))


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def _row_routes(rec: dict, k: int, n_moe: int, S: int,
                prompt_len: int, prefix: int) -> List[torch.Tensor]:
    """The program's experts of the k-th kept row of a chunk at each MoE
    layer, (prefix + prompt + S - 1, top_k), in the reference's positions:
    the prefill's valid columns (the prefix, then the left-padded prompt at
    the right end), then each step's token."""
    routes = rec["routes"]
    out = []
    for m in range(n_moe):
        pre = routes[m][k]  # (L, top_k)
        L = pre.shape[0]
        parts = [pre[:prefix], pre[L - prompt_len:]]
        parts += [routes[n_moe * s + m][k][None] for s in range(1, S)]
        out.append(torch.cat(parts).long())
    return out


def _lm_reference(w, config: dict, clip_cfg: dict, t5_tok, corpus, images,
                  served_pairs, picks, device, routes=None, route_tol=0.0,
                  chosen=None):
    """The reference's prefix (n, P, d), logits (n, S, V) at each judged
    position, the served ids (n, 1 + steps) and the routing readings."""
    s = config["settings"]
    rows, imgs, tokens, plens = [], [], [], []
    S = len(served_pairs[picks[0][0]][0]["logits"])
    for c, k in picks:
        rec, meta = served_pairs[c]
        r = int(rec["rows"][k])
        e = meta["rows"][r]
        top = [corpus[int(j)]["answer"] for j in rec["idx"][r].tolist()]
        prompt = ref.prompt_ids(t5_tok, e["question"], e["task"],
                                ref.hint(top, s["quantifier"]),
                                s["max_source_length"])
        ids = rec["ids"][r].long().to(device)
        rows.append(torch.cat([torch.as_tensor(prompt, device=device),
                               ids[1:S]]))
        plens.append(len(prompt))
        imgs.append(images[e["image_name"]])
        tokens.append(ids)
    prefix = ref.prefix_from_tokens(w, ref.vit_tokens(
        w, clip_cfg, torch.as_tensor(np.stack(imgs), device=device)))
    P = prefix.shape[1]
    embeds = [torch.cat([prefix[i], t])
              for i, t in enumerate(ref_lm.embed(w, rows))]
    hidden, stats = ref_lm.forward_rows(w, config, embeds, routes, route_tol,
                                        chosen)
    at = torch.stack([h[P + n - 1:P + n - 1 + S]
                      for h, n in zip(hidden, plens)])  # (n, S, d)
    logits = ref_lm.logits(w, at.flatten(0, 1)).view(len(picks), S, -1)
    return prefix, logits, torch.stack(tokens), stats, plens


def check(config: dict, workload: dict, seed: int, splits, images, weights,
          served_pairs: List[Tuple[dict, dict]], device, control: bool = False
          ) -> Tuple[Dict[str, float], Dict[str, dict]]:
    """(numbers, readings) of the module docstring's check. ``weights``: a
    mapping by name that draws the LM's layers when read
    (``weights_lm.Redraw``)."""
    clip_cfg = config["clip"]
    opts = workload["check"]
    tol = opts["route_tol"]
    eos = config["settings"]["lm_knobs"]["eos_token_id"]
    n_moe = config["num_hidden_layers"] - config["first_k_dense_replace"]
    rng = random.Random(f"check-{seed}")
    with ref.exact_fp32():
        t5_tok, clip_tok = served.reference_tokenizers(splits, clip_cfg)
        corpus = splits["train"]
        index = served.reference_queries(weights, clip_cfg, clip_tok, images,
                                         corpus, device)

        # the query and the search over chunks drawn from the seed
        judged = rng.sample(range(len(served_pairs)),
                            min(opts.get("query_chunks", 1),
                                len(served_pairs)))
        rows = [e for c in judged for e in served_pairs[c][1]["rows"]]
        q_ref = served.reference_queries(weights, clip_cfg, clip_tok, images,
                                         rows, device)
        q_port = torch.cat([served_pairs[c][0]["query"]
                            for c in judged]).float()
        idx = torch.cat([served_pairs[c][0]["idx"] for c in judged]).long()
        delta = (q_port - q_ref).norm(dim=1)
        q_err = delta / q_ref.norm(dim=1)
        d = ref.l2_distances(q_ref, index)
        chosen = d.gather(1, idx[:, :1])[:, 0]
        slack = 2 * delta + (1e-5 * (q_ref.pow(2).sum(1)
                                     + index.pow(2).sum(1).max())).sqrt()
        search_excess = int((chosen > d.min(dim=1).values + slack).sum())

        # the rows whose logits and routes were kept
        picks = [(c, k) for c, (rec, _) in enumerate(served_pairs)
                 if "rows" in rec for k in range(len(rec["rows"]))]
        if len(picks) > opts["decode_rows"]:
            longest = max(picks, key=lambda ck: len(served_pairs[ck[0]][1][
                "rows"][int(served_pairs[ck[0]][0]["rows"][ck[1]])][
                    "question"]))
            picks = rng.sample(picks, opts["decode_rows"])
            if longest not in picks:
                picks[-1] = longest
        if not picks:
            raise RuntimeError("no served row was kept for the check")
        picks.sort()
        args = (weights, config, clip_cfg, t5_tok, corpus, images,
                served_pairs, picks, device)
        # the program's routes in the reference's positions
        P = (clip_cfg["image_resolution"] // clip_cfg["patch_size"]) ** 2 + 1
        S = len(served_pairs[picks[0][0]][0]["logits"]) if picks else 0
        routes = []
        for c, k in picks:
            rec = served_pairs[c][0]
            r = int(rec["rows"][k])
            plen = int(rec["mask"][r].long().sum())
            routes.append(_row_routes(rec, k, n_moe, S, plen, P))
        prefix, ref_logits, served_ids, stats, plens = _lm_reference(
            *args, routes=routes, route_tol=tol)
        if any(int(served_pairs[c][0]["mask"][int(served_pairs[c][0][
                "rows"][k])].long().sum()) != n
               for (c, k), n in zip(picks, plens)):
            raise RuntimeError("the served prompt's length differs from the "
                               "reference's")
        port_prefix = torch.stack([served_pairs[c][0]["prefix"][k]
                                   for c, k in picks]).float()
        port = torch.stack([torch.stack([s_[k] for s_ in served_pairs[c][0][
            "logits"]]) for c, k in picks]).float()  # (n, S, V)
        nxt = served_ids[:, 1:S + 1]
        hit = (nxt == eos).long()
        live = (torch.cumsum(hit, dim=1) - hit) == 0
        diff = port - ref_logits
        err = diff.norm(dim=-1) / ref_logits.norm(dim=-1)
        eps = diff.abs().amax(dim=-1)
        gap = (ref_logits.max(dim=-1).values
               - ref_logits.gather(2, nxt[..., None].long())[..., 0])
        start_ok = bool((served_ids[:, 0] == config["settings"]["lm_knobs"][
            "pad_token_id"]).all())
        tok_excess = (int(((gap > 2 * eps * (1 + 1e-3)) & live).sum())
                      + (0 if start_ok else len(picks)))
        pre_err = served._rel(port_prefix, prefix)
        lg = err[live]
        if control:
            c_chosen = [[] for _ in picks]
            with ref.products_through(ref.fp8):
                q_c = served.reference_queries(weights, clip_cfg, clip_tok,
                                               images, rows, device)
                c_prefix, c_logits, _, _, _ = _lm_reference(
                    *args, chosen=c_chosen)
            _, e_logits, _, c_stats, _ = _lm_reference(
                *args, routes=c_chosen, route_tol=tol)
            c_err = ((c_logits - e_logits).norm(dim=-1)
                     / e_logits.norm(dim=-1))
            c_readings = {"query_err": float(served._rel(q_c, q_ref).max()),
                          "prefix_err": float(served._rel(c_prefix,
                                                          prefix).max()),
                          "logit_err": float(c_err[live].max()),
                          "route_excess": c_stats["route_excess"],
                          "route_flip_share": _flip_share(c_stats),
                          "route": c_stats}
    readings = {"query_err": served._stats(q_err),
                "prefix_err": served._stats(pre_err),
                "logit_err": served._stats(lg),
                "logit_gap": {"max": float(gap.masked_fill(~live, 0).max())},
                "route": stats,
                "rows": {"query": len(rows), "decode": len(picks),
                         "steps": S}}
    if control:
        readings["control"] = c_readings
    numbers = {"query_err": readings["query_err"]["max"],
               "prefix_err": readings["prefix_err"]["max"],
               "logit_err": readings["logit_err"]["max"],
               "search_excess": search_excess,
               "token_excess": tok_excess,
               "route_excess": stats["route_excess"],
               "route_flip_share": _flip_share(stats)}
    return numbers, readings


def _flip_share(stats: dict) -> float:
    """The decisions taken over within ``route_tol``, of all judged."""
    return stats["route_flips"] / max(stats["route_decisions"], 1)
