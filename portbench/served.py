"""What the serving drivers share: the served experiment built from a
configuration file, the work a served chunk needs, and the check that
decides ``correct``.

The check (``portbench/reference``, float32 with TF32 off, after the
window, with the program's state freed) judges what the window's fused
chunks produced, from the benchmark's own inputs and weights:

* ``query_err``: the ViT's pooled embedding and the text tower, as the
  retrieval query: for every row of the chunks drawn from the seed, the
  distance of the served query from the reference's, over the reference's
  norm; the largest.
* ``search_excess``: the top-k, exactly: the rows of those chunks whose
  served nearest corpus entry lies farther from the reference's query than
  the reference's nearest by more than twice the row's query error (plus
  fp32 distance rounding) can explain. The reference builds the corpus
  index itself. Limit 0.
* ``prefix_err``: the ViT prefix (every token, through the projection
  where there is one) that the served chunk read for the rows drawn for
  the decode, against the reference's; the largest relative error.
* ``logit_err``: the hint splice, the T5 encoder and each greedy step: for
  rows drawn from the seed over the whole pass (the longest question among
  them), the reference builds the prompt itself (its own tokenizer, the
  hint of the served top-k entries), runs the ViT, the encoder and the
  decoder over the served tokens, and compares each step's logits with the
  ones the served step computed; the largest relative error.
* ``token_excess``: the served tokens whose reference logit lies below the
  reference's best by more than twice that step's largest logit error can
  explain (an argmax over logits within eps of the reference's falls at
  most 2 eps below its best). Limit 0.

The reference follows the served top-k entries into the prompt, since a
near tie may order two entries differently in another precision; the
search that chose them is judged by ``search_excess``. The widest gap of a
served token below the reference's best (``logit_gap``) is read too, but
not compared: with random weights the best token leads by far more than
any rounding, so it reads 0 in bf16 and in the int8 control alike.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import instrument, work
from portbench.reference import models as ref
from portbench.reference.text.clip_bpe import CLIPBPETokenizer
from portbench.reference.text.spm import T5SentencePieceTokenizer
from portbench.traffic import slake


class ServedDriver:
    """What the serving drivers share: their arguments, the spans of the
    traced run, and freeing the program's state."""

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 quantize: Optional[str] = None):
        self.config, self.workload, self.seed = config, workload, seed
        self.device, self.quantize = device, quantize
        self.args = workload["driver_args"]
        self.setup_parts: Dict[str, float] = {}

    def spans(self, cuda: bool):
        return instrument.Spans(self.exp)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Free the program's state, its weights with it."""
        if hasattr(self, "server"):
            self.server._dispatcher.shutdown(wait=True)
        for name in ("server", "exp"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def port_config(config: dict, seed: int) -> dict:
    """The program's experiment config for a configuration file."""
    from multimodalpromptretrieval_tpu_torch import serving

    s = config["settings"]
    cfg = serving.synthetic_config(
        batch_size=s["batch_size"], epochs=1, retrieval=True, k=s["k"],
        image_size=config["clip"]["image_resolution"])
    cfg.update(seed=seed, compute_dtype=s["compute_dtype"],
               T5_version=config["T5_version"],
               quantifier=1 if s["quantifier"] else 0,
               max_source_length=s["max_source_length"],
               t5_overrides={**config["t5"], **s["t5_knobs"]},
               clip_overrides={**config["clip"], **s["clip_knobs"]})
    return cfg


@contextlib.contextmanager
def timed(parts: Dict[str, float], name: str):
    """Add the seconds of the block to ``parts[name]`` (set-up's parts,
    printed on standard error)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0


def build(config: dict, workload: dict, seed: int, device, quantize=None,
          parts: Optional[Dict[str, float]] = None):
    """(experiment, server, splits, images) of a served cell; the weights
    made on ``device`` from ``seed``. ``parts``: the seconds of each step
    of it."""
    from multimodalpromptretrieval_tpu_torch import serve, serving
    from portbench.weights import make_weights

    parts = {} if parts is None else parts
    with timed(parts, "traffic"):
        traffic = importlib.import_module(
            "portbench.traffic." + workload["traffic"]["generator"])
        splits, images = traffic.generate(workload["traffic"], seed)
    cfg = port_config(config, seed)
    mcfg = model_config(config)
    with timed(parts, "weights"):
        model, _ = make_weights(mcfg, seed, device)
    with timed(parts, "experiment"):
        exp = serving.ServingExperiment(
            cfg, train=splits["train"], validate=splits["validate"],
            test=splits["test"], images=images, params=model, device=device)
    if (exp.model_cfg.t5, exp.model_cfg.clip) != (mcfg.t5, mcfg.clip):
        raise RuntimeError("the program's model config differs from the "
                           "configuration file's")
    with timed(parts, "server"):
        server = serve.MPRServer(
            exp, load_checkpoint=False,
            pipeline_depth=workload["driver_args"]["pipeline_depth"],
            quantize=quantize)
    return exp, server, splits, images


def model_config(config: dict):
    """The program's ``MPRGenConfig`` of a configuration file."""
    import dataclasses

    from multimodalpromptretrieval_tpu_torch.models.clip import CLIPConfig
    from multimodalpromptretrieval_tpu_torch.models.mprgen import MPRGenConfig
    from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config

    s = config["settings"]
    return MPRGenConfig(
        t5=dataclasses.replace(T5Config(), **config["t5"], **s["t5_knobs"]),
        clip=dataclasses.replace(CLIPConfig(), **config["clip"],
                                 **s["clip_knobs"]),
        use_image_info=True, num_classes=0,
        max_source_length=s["max_source_length"],
        max_target_length=16, compute_dtype=s["compute_dtype"])


def steps_until_eos(ids: np.ndarray, eos: int) -> List[int]:
    """Decode steps each row needed: up to and including its EOS."""
    out = []
    for row in ids[:, 1:]:
        hit = np.nonzero(row == eos)[0]
        out.append(int(hit[0]) + 1 if len(hit) else len(row))
    return out


def chunk_flops(config: dict, rec: dict, index_rows: int) -> float:
    """Operations a fused chunk needs: the text tower over each question up
    to its EOT, the distances to the index, the encoder over each prompt's
    prefix and tokens, and the greedy steps each row ran to its EOS."""
    t5, clip = config["t5"], config["clip"]
    B = rec["ids"].shape[0]
    enc = rec["mask"].long().sum(dim=-1).cpu().numpy()
    prefix = (clip["image_resolution"] // clip["patch_size"]) ** 2 + 1
    enc_len = [int(x) + prefix for x in enc]
    steps = steps_until_eos(rec["ids"].cpu().numpy(), t5["eos_token_id"])
    return (work.clip_text_flops(clip, [int(x) for x in (
        rec["clip_ids"].long().argmax(dim=-1) + 1).tolist()])
            + work.l2_flops(B, index_rows, 2 * clip["embed_dim"])
            + work.t5_encoder_flops(t5, enc_len)
            + work.t5_decode_flops(t5, enc_len, steps))


def staging_flops(config: dict, n_images: int) -> float:
    """The ViT over the staged images (every token, through the 512 ->
    d_model projection where there is one)."""
    proj = (config["t5"]["d_model"]
            if config["t5"]["d_model"] != config["clip"]["embed_dim"] else 0)
    return work.vit_flops(config["clip"], n_images, proj)


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def reference_tokenizers(splits: Dict[str, List[dict]], clip_cfg: dict):
    t5_tok = T5SentencePieceTokenizer.from_corpus(slake.tokenizer_corpus(
        splits["train"], splits["validate"], splits["test"]))
    t5_tok.add_tokens(["[itk]"])
    clip_tok = CLIPBPETokenizer.build_toy(
        context_length=clip_cfg["context_length"])
    return t5_tok, clip_tok


def _blocks(n: int, size: int):
    for s in range(0, n, size):
        yield slice(s, min(n, s + size))


def reference_queries(w, clip_cfg: dict, clip_tok, images: Dict[str, np.ndarray],
                      entries: Sequence[dict], device,
                      block: int = 64) -> torch.Tensor:
    """(N, 2 * embed_dim) image (+) question embeddings of ``entries``, the
    ViT once per distinct image."""
    names = list(dict.fromkeys(e["image_name"] for e in entries))
    img_emb = {}
    for sl in _blocks(len(names), block):
        x = torch.as_tensor(np.stack([images[n] for n in names[sl]]),
                            device=device)
        for n, e in zip(names[sl], ref.vit_tokens(w, clip_cfg, x)[:, 0]):
            img_emb[n] = e
    ids = torch.as_tensor(clip_tok.tokenize([e["question"] for e in entries]),
                          device=device)
    txt = torch.cat([ref.clip_text(w, clip_cfg, ids[sl])
                     for sl in _blocks(len(entries), block)])
    img = torch.stack([img_emb[e["image_name"]] for e in entries])
    return torch.cat([img, txt], dim=1)


def sample_rows(chunk_rows: Sequence[Sequence[dict]], n: int, seed: int
                ) -> Dict[int, List[int]]:
    """The rows whose decode the check judges, drawn from the seed over a
    pass's chunks, with the longest question among them: chunk -> rows."""
    rng = random.Random(f"sample-{seed}")
    rows = [(c, r) for c, chunk in enumerate(chunk_rows)
            for r in range(len(chunk))]
    picks = rng.sample(rows, min(n, len(rows)))
    longest = max(rows, key=lambda cr: len(chunk_rows[cr[0]][cr[1]][
        "question"]))
    if longest not in picks:
        picks[-1] = longest
    out: Dict[int, List[int]] = {}
    for c, r in sorted(picks):
        out.setdefault(c, []).append(r)
    return out


def _stats(x: torch.Tensor) -> Dict[str, float]:
    x = x.flatten().float()
    return {"max": float(x.max()), "median": float(x.median()),
            "mean": float(x.mean())}


def check(config: dict, workload: dict, seed: int, splits, images,
          weights: Dict[str, torch.Tensor], served: List[Tuple[dict, dict]],
          device, control: bool = False
          ) -> Tuple[Dict[str, float], Dict[str, dict]]:
    """(numbers, readings): the compared numbers of the module docstring
    and the spread behind each. ``served``: (record of a fused chunk,
    {"rows": the test entries it answered}) in serving order. ``control``:
    also the same numbers of the reference with fp8 products in the
    program's place (under ``readings["control"]``)."""
    t5_cfg, clip_cfg = config["t5"], config["clip"]
    s = config["settings"]
    opts = workload["check"]
    rng = random.Random(f"check-{seed}")
    with ref.exact_fp32():
        t5_tok, clip_tok = reference_tokenizers(splits, clip_cfg)
        corpus = splits["train"]
        index = reference_queries(weights, clip_cfg, clip_tok, images, corpus,
                                  device)

        # the query and the search over chunks drawn from the seed
        judged = rng.sample(range(len(served)),
                            min(opts.get("query_chunks", 1), len(served)))
        rows = [e for c in judged for e in served[c][1]["rows"]]
        q_ref = reference_queries(weights, clip_cfg, clip_tok, images, rows,
                                  device)
        q_port = torch.cat([served[c][0]["query"] for c in judged]).float()
        idx = torch.cat([served[c][0]["idx"] for c in judged]).long()
        delta = (q_port - q_ref).norm(dim=1)
        q_err = delta / q_ref.norm(dim=1)
        d = ref.l2_distances(q_ref, index)
        chosen = d.gather(1, idx[:, :1])[:, 0]
        # rounding of an exact search on the served query can move the
        # choice by twice the query's error, and fp32 distance arithmetic
        # by a little more
        slack = 2 * delta + (1e-5 * (q_ref.pow(2).sum(1)
                                     + index.pow(2).sum(1).max())).sqrt()
        search_excess = int((chosen > d.min(dim=1).values + slack).sum())

        # the prefixes and the decode of the rows whose logits were kept
        picks = [(c, k) for c, (rec, _) in enumerate(served)
                 if "rows" in rec for k in range(len(rec["rows"]))]
        if len(picks) > opts["decode_rows"]:
            longest = max(picks, key=lambda ck: len(served[ck[0]][1]["rows"][
                int(served[ck[0]][0]["rows"][ck[1]])]["question"]))
            picks = rng.sample(picks, opts["decode_rows"])
            if longest not in picks:
                picks[-1] = longest
        pre, lg, c_pre, c_lg = [], [], [], []
        tok_excess, gap = 0, 0.0
        for sl in _blocks(len(picks), opts.get("decode_block", 16)):
            out = _decode_check(weights, t5_cfg, clip_cfg, s, t5_tok, corpus,
                                images, served, picks[sl], device, control)
            pre.append(out["prefix_err"])
            lg.append(out["logit_err"])
            tok_excess += out["token_excess"]
            gap = max(gap, out["logit_gap"])
            if control:
                c_pre.append(out["control"]["prefix_err"])
                c_lg.append(out["control"]["logit_err"])
        if control:
            with ref.products_through(ref.fp8):
                q_c = reference_queries(weights, clip_cfg, clip_tok, images,
                                        rows, device)
            c_readings = {"query_err": float(_rel(q_c, q_ref).max()),
                          "prefix_err": float(torch.cat(c_pre).max()),
                          "logit_err": float(torch.cat(c_lg).max())}
        if not picks:  # nothing judged: no reading can pass
            pre = lg = torch.full((1,), float("inf"))
        else:
            pre, lg = torch.cat(pre), torch.cat(lg)
    readings = {"query_err": _stats(q_err), "prefix_err": _stats(pre),
                "logit_err": _stats(lg), "logit_gap": {"max": gap},
                "rows": {"query": len(rows), "decode": len(picks)}}
    if control:
        readings["control"] = c_readings
    numbers = {"query_err": readings["query_err"]["max"],
               "prefix_err": readings["prefix_err"]["max"],
               "logit_err": readings["logit_err"]["max"],
               "search_excess": search_excess,
               "token_excess": tok_excess}
    return numbers, readings


def _reference_decode(w, t5_cfg: dict, clip_cfg: dict, settings: dict,
                      t5_tok, corpus, images, served, picks, device):
    """The reference's prefix (n, P, d) and teacher-forced logits (n, S,
    vocab) of ``picks`` over their served tokens."""
    prompts, imgs, tokens = [], [], []
    for c, k in picks:
        rec, meta = served[c]
        r = int(rec["rows"][k])
        e = meta["rows"][r]
        top = [corpus[int(j)]["answer"] for j in rec["idx"][r].tolist()]
        prompts.append(ref.prompt_ids(
            t5_tok, e["question"], e["task"],
            ref.hint(top, settings["quantifier"]),
            settings["max_source_length"]))
        imgs.append(images[e["image_name"]])
        tokens.append(rec["ids"][r].long())
    ids, mask = ref.pad_rows(prompts)
    ids, mask = ids.to(device), mask.to(device)
    prefix = ref.prefix_from_tokens(w, ref.vit_tokens(
        w, clip_cfg, torch.as_tensor(np.stack(imgs), device=device)))
    embeds = torch.cat([prefix, w["t5.shared"].float()[ids]], dim=1)
    full_mask = torch.cat([torch.ones(prefix.shape[:2], dtype=mask.dtype,
                                      device=device), mask], dim=1)
    enc = ref.t5_encode(w, t5_cfg, embeds, full_mask)
    served_ids = torch.stack(tokens).to(device)  # (n, 1 + max steps)
    S = len(served[picks[0][0]][0]["logits"])
    logits = ref.t5_decoder_logits(w, t5_cfg, enc, full_mask,
                                   served_ids[:, :S])
    return prefix, logits, served_ids


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row ||a - b|| / ||b|| over the trailing dimensions."""
    return (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)


def _decode_check(w, t5_cfg: dict, clip_cfg: dict, settings: dict, t5_tok,
                  corpus: Sequence[dict], images, served, picks,
                  device, control: bool = False) -> dict:
    """For ``picks`` (chunk, k) -- the k-th judged row of a chunk -- the
    prefix's error, each decode step's logit error, the served tokens that
    lie below the reference's best by more than the logit error can
    explain, and the widest such gap; with ``control``, the prefix and
    logit errors of the reference with fp8 products in the program's
    place."""
    args = (w, t5_cfg, clip_cfg, settings, t5_tok, corpus, images, served,
            picks, device)
    prefix, ref_logits, served_ids = _reference_decode(*args)
    port_prefix = torch.stack([served[c][0]["prefix"][k]
                               for c, k in picks]).float()
    port = torch.stack([torch.stack([s[k] for s in served[c][0]["logits"]])
                        for c, k in picks]).float()  # (n, S, vocab)
    S = port.shape[1]
    nxt = served_ids[:, 1:S + 1]
    # a row's steps count up to and including its first EOS
    eos = (nxt == t5_cfg["eos_token_id"]).long()
    live = (torch.cumsum(eos, dim=1) - eos) == 0
    diff = port - ref_logits
    err = diff.norm(dim=-1) / ref_logits.norm(dim=-1)
    # argmax over logits within eps of the reference's can fall at most
    # 2 eps below the reference's best
    eps = diff.abs().amax(dim=-1)
    gap = (ref_logits.max(dim=-1).values
           - ref_logits.gather(2, nxt[..., None])[..., 0])
    start_ok = bool((served_ids[:, 0] == t5_cfg["decoder_start_token_id"])
                    .all())
    excess = int(((gap > 2 * eps * (1 + 1e-3)) & live).sum())
    out = {"prefix_err": _rel(port_prefix, prefix), "logit_err": err[live],
           "token_excess": excess + (0 if start_ok else len(picks)),
           "logit_gap": float(gap.masked_fill(~live, 0).max())}
    if control:
        with ref.products_through(ref.fp8):
            c_prefix, c_logits, _ = _reference_decode(*args)
        c_err = (c_logits - ref_logits).norm(dim=-1) / ref_logits.norm(dim=-1)
        out["control"] = {"prefix_err": _rel(c_prefix, prefix),
                          "logit_err": c_err[live]}
    return out
