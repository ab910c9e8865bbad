"""Serving API: answer (image, question) pairs end to end.

Counterpart of ``multimodalpromptretrieval_tpu/serve.py``:

    exp = ServingExperiment(cfg, ...)        # serving.py
    server = MPRServer(exp)                   # loads exp.model_path if any
    server.stage_images(images, image_ids)    # once per image corpus
    answers = server.answer(images, questions, tasks, image_ids=image_ids)

Images are encoded once per unique id through the ViT (token 0 is the
retrieval embedding, all tokens the T5 prefix) and stay on the device.
With retrieval on, each chunk of ``batch_size`` requests runs the FUSED
step when token-exactness is provable (``retrieval/hints.py``): CLIP text
tower -> (img + txt) L2 top-k -> majority vote + quantifier bucket -> hint
splice -> T5 encode -> greedy decode, with no index fetch and no host
re-tokenization. Otherwise (``prompt_fastpath=False``, or a question whose
junction with the hint is not boundary-safe) the host-prompt path fetches
the top-k indices once, formats the hints on the host and re-tokenizes.

The other variants (text-only, prediction head, BAN, the ResNet tower) take
the per-batch path, chunk by chunk in request order: the hints come from the
CLIP towers (the ViT, also for an RN model: quirk #2)
over each request's images and questions and one top-k (none for BAN,
whose prompts never carry one), the prompts are tokenized per chunk, and
the predict step gets the chunk's images where the variant reads them. A
head variant answers ``label2ans`` of its class ids. Its answer depends on
the rows that share its chunk (the head reads the chunk's longest-prompt
position), so the chunks are the JAX server's: consecutive ``batch_size``
rows, never re-sorted.

With the LM generator (``MPRGenConfig.lm``, ``models/moe_lm.py``) the
fused chunk ends in the LM's prefill over [prefix || prompt] and its
greedy decode in T5's place; its weights stay in the compute dtype (the
serving copy shares them), and ``quantize`` and ``spec_decode`` raise
``ValueError`` (the experiment refuses a mesh: tp, the sharded server).

Options, as in the JAX server: ``quantize="int8"`` serves the T5 blocks
with int8 W8A8 weights (``ops/quant.py``, made from the fp32 masters before
the compute copy; retrieval ranks stay those of full precision), and
``"int8_all"`` the CLIP towers too; ``spec_decode=S`` verifies the vote
winner's answer tokens as drafts, S a decoder pass (fused path only; the
same answers); ``length_sort=True`` re-chunks a request of more than one
chunk by the predicted answer length (one extra retrieval fetch; answers
in the caller's order).

``submit`` returns with up to ``pipeline_depth`` chunks queued or running,
and ``result()`` drains them in submission order. Each chunk's device
work runs on the server's one dispatcher thread (FIFO), inside inference
mode and on the server's CUDA stream, which it enters itself: both are
thread-local. The decode's host EOS check after each step (or pass) blocks
that thread only, while the caller tokenizes the next chunk and
detokenizes the last. A chunk's error is raised by ``result()``, and by
the next ``submit`` once the chunk has failed.

With ``train/profiling`` on, the server records its spans (``mpr.serve.``
submit, request, stage, prepare, queue_wait, chunk, run, fetch, consume,
wait; ``mpr.text.`` encode, decode, clip_tokenize), each carrying its
request's ``request_id`` and the chunk's index, and counts
``serve.chunks.fused``, ``serve.chunks.host`` and ``serve.rows``.

Under a mesh whose "data" axis is wider than 1 (the experiment's
``mesh``, from its ``parallelism`` key over the process group; the JAX
server's steps over ``exp.mesh``), every process runs the same server on
the same requests and each chunk's rows are split over "data": the chunk
is padded to ``batch_size`` B by repeating its last row, and data index d
runs rows ``[d * B / n, (d + 1) * B / n)`` of it (the CLIP text tower, K4
against the whole replicated index, the vote, the splice, the T5 encoder
and the decode, or the variant's predict, on its block only). The
chunk's ids come back in row order through ``parallel/mesh.gather_rows``
into fixed (B / n, 1 + max_new_tokens) buffers (a rank's decode may stop
at its own rows' EOS), and every rank returns all the answers. Staging
splits each chunk of B unique images the same way, and the (U, E) and (U,
P, d) tables are gathered once, bit for bit. Host work (tokenizing, the
host path's retrieval fetch and the per-batch path's hints) is
replicated. Every collective is issued on the dispatcher thread, so each
rank issues them in one order. Ranks that differ only along "model",
"pipe" or "seq" run their data index's block whole.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.data.batching import (
    bucket_width,
    encode_unique_chunks,
    pad_rows,
)
from multimodalpromptretrieval_tpu_torch.models import moe_lm
from multimodalpromptretrieval_tpu_torch.models.clip import (
    clip_encode_text,
    clip_image_tokens,
    truncate_text_ids,
)
from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    MPRGen,
    MPRGenConfig,
    cast_compute,
    compute_dtype,
    generative_predict_from_prefix,
    image_prefix_from_tokens,
    variant_predict,
)
from multimodalpromptretrieval_tpu_torch.ops.quant import quantize_params
from multimodalpromptretrieval_tpu_torch.ops.topk import l2_topk
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh
from multimodalpromptretrieval_tpu_torch.retrieval.hints import (
    build_draft_tables,
    build_hint_tables,
    splice_hints,
    vote_rows,
)
from multimodalpromptretrieval_tpu_torch.retrieval.index import (
    QUANTIFIER_BUCKETS,
)
from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt
from multimodalpromptretrieval_tpu_torch.train import profiling


# ---------------------------------------------------------------------------
# Device steps (the JAX package's parallel/mesh.py steps, without a mesh)
# ---------------------------------------------------------------------------


def image_embed_prefix_step(params: MPRGen, cfg: MPRGenConfig,
                            images: torch.Tensor):
    """(B, 3, R, R) -> (pooled CLIP embedding (B, E), T5 prefix (B, P, d)):
    ONE ViT pass per image feeds retrieval and the decode prefix."""
    with profiling.span("mpr.clip.vit"):
        tokens = clip_image_tokens(params.clip, cfg.clip,
                                   images.to(compute_dtype(cfg)))
        return tokens[:, 0], image_prefix_from_tokens(params, cfg, tokens)


def prefix_predict_step(params: MPRGen, cfg: MPRGenConfig,
                        batch: Dict[str, torch.Tensor],
                        max_new_tokens: int = 20) -> torch.Tensor:
    """Greedy ids over precomputed prefixes (host-prompt path)."""
    return generative_predict_from_prefix(
        params, cfg, batch["prefix"], batch["input_ids"],
        batch["text_mask"], max_new_tokens)


def fused_serve_step(params: MPRGen, cfg: MPRGenConfig,
                     batch: Dict[str, torch.Tensor], index: torch.Tensor,
                     index_sq: torch.Tensor, aid: torch.Tensor,
                     hint_ids: torch.Tensor, hint_len: torch.Tensor, *,
                     k: int, use_quantifier: bool, eos_id: int,
                     max_new_tokens: int = 20,
                     skip_first: bool = False,
                     draft_ids: Optional[torch.Tensor] = None,
                     spec_block: int = 0) -> torch.Tensor:
    """One serve chunk on the device: CLIP text tower -> (img + txt) L2
    top-k -> majority vote + quantifier bucket -> hint splice -> T5 encode
    -> greedy decode. batch = {prefix (B, P, d), q_ids (B, W) question ids
    padded to the final width (no EOS), q_len (B,), clip_text_ids (B, Lc),
    img_emb (B, E)}. With ``draft_ids`` (the draft table,
    ``retrieval/hints.build_draft_tables``) and ``spec_block`` > 0, each
    row drafts its vote winner's answer tokens (speculative decode)."""
    txt = clip_encode_text(params.clip, cfg.clip,
                           batch["clip_text_ids"]).float()
    query = torch.cat([batch["img_emb"].float(), txt], dim=1)
    _, idx = l2_topk(query, index, k, index_sq=index_sq,
                     skip_first=skip_first)
    rows = vote_rows(aid[idx.long()], use_quantifier).long()
    ids, mask = splice_hints(batch["q_ids"], batch["q_len"], hint_ids[rows],
                             hint_len[rows], eos_id)
    drafts = None
    if spec_block > 0 and draft_ids is not None:
        winner = rows // len(QUANTIFIER_BUCKETS) if use_quantifier else rows
        drafts = draft_ids[winner]
    return generative_predict_from_prefix(params, cfg, batch["prefix"], ids,
                                          mask, max_new_tokens,
                                          draft_ids=drafts,
                                          spec_block=spec_block)


def steps_run(tokens: np.ndarray, eos_id: int) -> int:
    """Decode steps a greedy call ran: it stops when every row has emitted
    EOS (or after max_new_tokens)."""
    hit = tokens[:, 1:] == eos_id
    per_row = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1,
                       tokens.shape[1] - 1)
    return int(per_row.max(initial=0))


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class AnswerHandle:
    """Ticket for a :meth:`MPRServer.submit` request. ``result()`` blocks
    until its answers are complete (older requests drain first) and raises
    the error of a chunk of the request that failed. ``request_id``: the
    request's number on its server, which its spans carry."""

    def __init__(self, server: "MPRServer", n_chunks: int,
                 request_id: int = -1):
        self._server = server
        self.request_id = request_id
        self._chunks = n_chunks
        self._remaining = n_chunks
        self._error: Optional[BaseException] = None
        # length-sorted dispatch: sorted row i is the caller's row _perm[i]
        self._perm: Optional[np.ndarray] = None
        self.answers: List[str] = []

    def done(self) -> bool:
        return self._remaining == 0

    def result(self) -> List[str]:
        self._server._drain(self)
        if self._error is not None:
            if self._server._failed is self._error:
                self._server._failed = None  # raised here, not by submit
            raise self._error
        if self._perm is not None:  # restore the caller's order, once
            out: List[str] = [""] * len(self.answers)
            for pos, orig in enumerate(self._perm):
                out[orig] = self.answers[pos]
            self.answers, self._perm = out, None
        return self.answers


class MPRServer:
    """``load_checkpoint``: answer from ``experiment.model_path`` when that
    file exists (the trained checkpoint), as the JAX server does; the
    experiment's params are replaced by it (not for the LM generator,
    which has no checkpoint: the file is not read). With the LM generator
    ``quantize`` and ``spec_decode`` raise ``ValueError``. ``quantize``,
    ``spec_decode``,
    ``length_sort``: the module docstring. Under a mesh
    with "data" above 1 every process of the group constructs the server
    and makes the same calls (module docstring); a "data" axis that does
    not divide ``batch_size`` raises ``ValueError``."""

    def __init__(self, experiment, load_checkpoint: bool = True,
                 max_new_tokens: int = 20, prompt_fastpath: bool = True,
                 pipeline_depth: int = 1, quantize: Optional[str] = None,
                 spec_decode: int = 0, length_sort: bool = False):
        if quantize not in (None, "int8", "int8_all"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        mcfg = experiment.model_cfg
        mesh = experiment.mesh
        if mcfg.lm is not None:
            # the experiment refused a mesh and the checkpoint keys
            moe_lm.refuse_options(quantize=quantize, spec_decode=spec_decode)
        self.mesh = mesh if mesh.n_data > 1 else None
        if self.mesh is not None and experiment.batch_size % mesh.n_data:
            raise ValueError(
                f"parallelism: data={mesh.n_data} does not divide the "
                f"serving chunk batch_size={experiment.batch_size}")
        if (load_checkpoint and mcfg.lm is None
                and os.path.exists(experiment.model_path)):
            experiment.params, _, _ = ckpt.load_checkpoint(
                experiment.model_path, mcfg,
                device=experiment.params.t5.shared.device)
        self.exp = experiment
        self.device = (experiment.params.lm.embed.device
                       if mcfg.lm is not None
                       else experiment.params.t5.shared.device)
        self.max_new_tokens = max_new_tokens
        self.prompt_fastpath = prompt_fastpath
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.spec_decode = max(0, int(spec_decode))
        self.length_sort = bool(length_sort)
        # (handle, future of the chunk's ids, whether they are class ids)
        self._queue: List[tuple] = []
        self._failed: Optional[BaseException] = None  # not raised yet
        # the serving weights: int8 from the fp32 masters (the masters stay
        # as they are), then the compute-dtype copy, made once (JAX casts
        # inside each jit)
        masters = experiment.params
        if quantize is not None:
            masters = quantize_params(masters, t5=True,
                                      clip=quantize == "int8_all")
        self.params = cast_compute(masters, mcfg)
        # the per-batch path's retrieval embeds with these towers (fp32, or
        # int8 under "int8_all"), as the fused path's tables do
        self._retrieval_clip = masters.clip
        if experiment.retrieval_index is not None:
            experiment.retrieval_index.is_training_phase = False
        self._staged = None  # stage_images cache: (id -> row, emb, prefix)
        self._hint_tables = None  # None = not built; False = unavailable
        self._draft_tables = None  # built beside them when spec_decode > 0
        self._hint_src = None
        # chunks served per path ("host": the host-prompt and per-batch
        # paths), and greedy decode steps run
        self.chunks = {"fused": 0, "host": 0}
        self.decode_steps = 0
        # requests submitted; the one being submitted (id, its start for
        # the request span)
        self._requests = 0
        self._request = (-1, 0)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # params and index were produced on the default stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        # one thread runs every chunk's device work, in submission order;
        # it exits once the server is collected
        self._dispatcher = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mpr-dispatch")

    @contextlib.contextmanager
    def _on_device(self):
        """Inference mode, on the server's stream (CUDA only). Both are
        thread-local: each thread that queues device work enters them."""
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with torch.inference_mode(), stream:
            yield

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _ensure_hint_tables(self):
        """Build (once) the pre-tokenized hint tables of the fused path,
        and the draft tables beside them under ``spec_decode``; None when
        the corpus / tokenizer cannot support it."""
        exp = self.exp
        src = (id(exp.retrieval_index), len(exp.retrieval_index),
               len(getattr(exp.tokenizer, "added", {})), exp.use_quantifier)
        if self._hint_src != src:
            self._hint_tables = self._draft_tables = None
            self._hint_src = src
        if self._hint_tables is None:
            self._hint_tables = build_hint_tables(
                exp.retrieval_index, exp.tokenizer,
                use_quantifier=exp.use_quantifier) or False
            if self._hint_tables and self.spec_decode:
                self._draft_tables = build_draft_tables(
                    exp.retrieval_index, exp.tokenizer,
                    max_length=self.max_new_tokens)
        return self._hint_tables or None

    def _encode_unique(self, images, image_ids: Sequence):
        """Encode each UNIQUE image once -> (id -> table row, (U, E)
        retrieval embeddings, (U, P, d) prefixes), both left on the
        device. Images cross to the card in the compute dtype. Under a
        mesh each data index encodes its block of every chunk of
        ``batch_size`` images and the tables are gathered once, bit for
        bit."""
        exp, mcfg = self.exp, self.exp.model_cfg
        first: dict = {}
        for i, iid in enumerate(image_ids):
            first.setdefault(iid, i)
        if not first:
            return {}, None, None
        items = list(first.values())
        B = exp.batch_size

        def encode():
            embs, prefs = [], []
            for s in range(0, len(items), B):
                chunk = items[s:s + B]
                x = torch.from_numpy(np.stack(
                    [np.asarray(images[chunk[i]], np.float32)
                     for i in self._rows(len(chunk))]))
                x = x.to(compute_dtype(mcfg))
                with profiling.span("mpr.serve.stage.upload"):
                    x = x.to(self.device)
                emb, pref = image_embed_prefix_step(self.params, mcfg, x)
                embs.append(emb)
                prefs.append(pref)
            tables = (torch.cat(embs), torch.cat(prefs))
            if self.mesh is not None:
                tables = tuple(self._gather_table(t, len(items))
                               for t in tables)
            return tables

        with profiling.span("mpr.serve.stage"):
            emb, pref = self._collective(encode)
        return {iid: j for j, iid in enumerate(first)}, emb, pref

    def _rows(self, k: int) -> np.ndarray:
        """The rows of a chunk of ``k`` rows that this process runs: all of
        them; under a mesh, its data index's block of the chunk padded to
        ``batch_size`` by repeating the last row."""
        if self.mesh is None:
            return np.arange(k)
        B, n = self.exp.batch_size, self.mesh.n_data
        b = B // n
        return np.minimum(np.arange(B), k - 1)[self.mesh.index * b:
                                                (self.mesh.index + 1) * b]

    def _gather_rows(self, ids: torch.Tensor, k: int) -> torch.Tensor:
        """A chunk's ids from the data indices' blocks, in row order, the
        fill rows dropped (the chunk's own ids without a mesh)."""
        if self.mesh is None:
            return ids
        return pmesh.gather_rows(ids, self.mesh)[:k]

    def _gather_table(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """A staged table from the data indices' blocks of each chunk
        (:meth:`_encode_unique`), bit for bit, in item order: ``n`` rows."""
        parts = pmesh.gather_bits(t, self.mesh)  # (n_data, C * b, ...)
        D, b = self.mesh.n_data, self.exp.batch_size // self.mesh.n_data
        chunks = parts.shape[1] // b
        rest = tuple(t.shape[1:])
        return (parts.reshape((D, chunks, b) + rest).transpose(0, 1)
                .reshape((chunks * D * b,) + rest)[:n])

    def _collective(self, fn):
        """``fn()``, where its collectives keep one order on every process:
        under a mesh on the dispatcher thread, behind the queued chunks,
        in inference mode on the server's stream; else here."""
        if self.mesh is None:
            return fn()
        return self._dispatcher.submit(self._in_mode, fn).result()

    def stage_images(self, images, image_ids: Sequence) -> None:
        """Encode a corpus of images once and keep the retrieval-embedding
        and prefix tables on the device, keyed by id; requests whose ids
        are all staged skip the image upload. Re-staging replaces it."""
        with self._on_device():
            self._staged = self._encode_unique(images, image_ids)

    def _dispatch_chunk_retrieval(self, questions: Sequence[str], emb_dev,
                                  rows: np.ndarray):
        """One chunk's text tower + (img + txt) top-k, not fetched."""
        exp = self.exp
        with profiling.span("mpr.text.clip_tokenize"):
            ids = truncate_text_ids(
                exp.clip_tokenizer.tokenize(list(questions)))
        txt = clip_encode_text(self.params.clip, exp.model_cfg.clip,
                               self._tensor(ids))
        img = emb_dev[self._tensor(rows)]
        q = torch.cat([img.float(), txt.float()], dim=1)
        return exp.retrieval_index.topk(q, k=exp.k)[1]

    def _dispatch_all_retrieval(self, questions: Sequence[str], emb_dev,
                                rowmap: np.ndarray) -> np.ndarray:
        """Every chunk's retrieval, fetched to the host in ONE copy. Shared
        by the host path and the length-sort pre-pass."""
        B = self.exp.batch_size
        return torch.cat([self._dispatch_chunk_retrieval(
            questions[s:s + B], emb_dev, rowmap[s:s + B])
            for s in range(0, len(questions), B)]).cpu().numpy()

    def _length_sort_order(self, questions: Sequence[str],
                           rowmap: np.ndarray, emb_dev) -> np.ndarray:
        """Stable row order by predicted answer length: one retrieval
        pre-pass, and the length of each row's formatted hint (its
        majority answer) as the key. The fused chunks still run their own
        retrieval, so the answers stay token-exact; the pre-pass only
        chooses each chunk's rows."""
        exp = self.exp
        idx_np = self._dispatch_all_retrieval(questions, emb_dev, rowmap)
        hints = exp.retrieval_index.format_prompts(
            idx_np, use_quantifier=exp.use_quantifier)
        return np.argsort(np.asarray([len(h) for h in hints]), kind="stable")

    def answer(self, images, questions: Sequence[str],
               tasks: Optional[Sequence[str]] = None,
               image_ids: Optional[Sequence] = None) -> List[str]:
        """Synchronous one-shot: ``submit(...).result()``."""
        return self.submit(images, questions, tasks,
                           image_ids=image_ids).result()

    def submit(self, images, questions: Sequence[str],
               tasks: Optional[Sequence[str]] = None,
               image_ids: Optional[Sequence] = None) -> AnswerHandle:
        """images: (N, 3, R, R) preprocessed; returns an
        :class:`AnswerHandle` whose ``result()`` yields the N answers.
        Returns with up to ``pipeline_depth`` chunks queued or running.

        ``image_ids`` (optional): a stable id per row; rows sharing an id
        share one ViT pass, and ids passed to :meth:`stage_images` skip
        the image upload (``images`` is then not touched)."""
        self._raise_failed()
        exp, mcfg = self.exp, self.exp.model_cfg
        n = len(questions)
        if n == 0:
            return AnswerHandle(self, 0)
        tasks = list(tasks) if tasks is not None else ["open"] * n
        classify = mcfg.use_prediction_head or mcfg.use_ban
        rid = self._requests
        self._requests += 1
        self._request = (rid, profiling.now_ns())
        with self._on_device(), profiling.span("mpr.serve.submit",
                                               request_id=rid):
            if not mcfg.use_image_info or classify or mcfg.resnet is not None:
                return self._answer_plain(images, questions, tasks, classify)
            ids_for_dedup = (list(image_ids) if image_ids is not None
                             else list(range(n)))
            if (self._staged is not None
                    and all(i in self._staged[0] for i in ids_for_dedup)):
                pos, emb_dev, pref_dev = self._staged
            else:
                pos, emb_dev, pref_dev = self._encode_unique(
                    images, ids_for_dedup)
            rowmap = np.asarray([pos[i] for i in ids_for_dedup])
            if exp.retrieval_index is not None and self.prompt_fastpath:
                ht = self._ensure_hint_tables()
                if ht is not None:
                    prompts = [f"Answer the {t} question: " + q
                               for q, t in zip(questions, tasks)]
                    if all(exp.tokenizer.concat_safe(p, ht.first_char)
                           for p in prompts):
                        perm = None
                        if self.length_sort and n > exp.batch_size:
                            perm = self._length_sort_order(
                                questions, rowmap, emb_dev)
                            prompts = [prompts[i] for i in perm]
                            questions = [questions[i] for i in perm]
                            rowmap = rowmap[perm]
                        handle = self._answer_fused(prompts, questions,
                                                    rowmap, emb_dev, pref_dev)
                        handle._perm = perm
                        return handle
            return self._answer_host(questions, tasks, rowmap, emb_dev,
                                     pref_dev)

    def _hints(self, images, questions: Sequence[str]) -> List[str]:
        """The per-batch path's retrieval hints: each row's image and
        question through the CLIP towers in chunks of ``batch_size``, then
        one top-k over the request. Empty without an index, and always
        under BAN (the reference's BAN prompt is task prefix + question,
        quirk #9)."""
        exp = self.exp
        if exp.retrieval_index is None or exp.model_cfg.use_ban:
            return [""] * len(questions)
        with profiling.span("mpr.text.clip_tokenize"):
            ids = exp.clip_tokenizer.tokenize(list(questions))
        out = encode_unique_chunks(
            list(range(len(questions))),
            lambda i: (np.asarray(images[i], np.float32), ids[i]),
            lambda x: x,
            lambda x: exp._clip_embed(*x, clip=self._retrieval_clip),
            exp.batch_size)
        return exp.retrieval_index.retrieve(
            out[0].float(), use_quantifier=exp.use_quantifier, k=exp.k)

    def _answer_plain(self, images, questions, tasks,
                      classify: bool) -> AnswerHandle:
        """Per-batch path (text-only, prediction head, BAN, the ResNet
        tower): hints for the whole request, then per chunk of
        ``batch_size`` consecutive rows the prompts tokenized and the
        predict step on the chunk's images when the variant reads them
        (``use_image_info`` or BAN)."""
        exp, mcfg = self.exp, self.exp.model_cfg
        B = exp.batch_size
        n = len(questions)
        needs_image = mcfg.use_image_info or mcfg.use_ban
        hints = self._hints(images, questions)

        def prepare(s: int):
            texts = [f"Answer the {t} question: " + q + h
                     for q, t, h in zip(questions[s:s + B], tasks[s:s + B],
                                        hints[s:s + B])]
            with profiling.span("mpr.text.encode"):
                rows, lens = exp.tokenizer.encode_rows(
                    texts, max_length=mcfg.max_source_length)
            width = bucket_width(int(lens.max()), 32, mcfg.max_source_length)
            ids, mask = pad_rows(rows, lens, width)
            k, mine = len(texts), self._rows(len(texts))
            # the head reads the chunk's longest prompt, on every block
            longest = int(mask.sum(axis=1).max())
            imgs = (np.stack([np.asarray(images[s + i], np.float32)
                              for i in mine])
                    if needs_image else None)
            self.chunks["host"] += 1
            profiling.count("serve.chunks.host")
            profiling.count("serve.rows", k)

            def run():
                batch = {"input_ids": self._tensor(ids[mine]),
                         "text_mask": self._tensor(mask[mine])}
                if self.mesh is not None:
                    batch["longest"] = self._tensor(longest)
                if imgs is not None:
                    batch["images"] = self._tensor(imgs)
                return self._gather_rows(variant_predict(
                    self.params, mcfg, batch, self.max_new_tokens), k)
            return run

        return self._run_pipeline(range(0, n, B), prepare, classify)

    def _answer_host(self, questions, tasks, rowmap, emb_dev,
                     pref_dev) -> AnswerHandle:
        """Host-prompt path: retrieval indices fetched once, hints
        formatted and prompts re-tokenized on the host per chunk."""
        exp, mcfg = self.exp, self.exp.model_cfg
        B = exp.batch_size
        n = len(questions)
        idx_np = (self._dispatch_all_retrieval(questions, emb_dev, rowmap)
                  if exp.retrieval_index is not None else None)

        def prepare(s: int):
            hints = ([""] * len(questions[s:s + B]) if idx_np is None
                     else exp.retrieval_index.format_prompts(
                         idx_np[s:s + B], use_quantifier=exp.use_quantifier))
            texts = [f"Answer the {t} question: " + q + h
                     for q, t, h in zip(questions[s:s + B], tasks[s:s + B],
                                        hints)]
            with profiling.span("mpr.text.encode"):
                rows, lens = exp.tokenizer.encode_rows(
                    texts, max_length=mcfg.max_source_length)
            width = bucket_width(int(lens.max()), 32, mcfg.max_source_length)
            ids, mask = pad_rows(rows, lens, width)
            k, mine = len(texts), self._rows(len(texts))
            gather = rowmap[s:s + B][mine]
            self.chunks["host"] += 1
            profiling.count("serve.chunks.host")
            profiling.count("serve.rows", k)

            def run():
                batch = {"input_ids": self._tensor(ids[mine]),
                         "text_mask": self._tensor(mask[mine]),
                         "prefix": pref_dev[self._tensor(gather)]}
                return self._gather_rows(prefix_predict_step(
                    self.params, mcfg, batch, self.max_new_tokens), k)
            return run

        return self._run_pipeline(range(0, n, B), prepare)

    def _answer_fused(self, prompts: Sequence[str], questions: Sequence[str],
                      rowmap: np.ndarray, emb_dev, pref_dev) -> AnswerHandle:
        """Fused path: per chunk the host only tokenizes the question
        prefix; retrieval, vote, splice and decode run on the device.
        Token-exact vs the host path (the caller checked boundary
        safety)."""
        exp, mcfg = self.exp, self.exp.model_cfg
        ht = self._hint_tables
        index = exp.retrieval_index
        B = exp.batch_size
        n = len(prompts)
        spec = self.spec_decode if self._draft_tables is not None else 0
        drafts = self._draft_tables.ids if spec else None

        def prepare(s: int):
            with profiling.span("mpr.text.encode"):
                rows, lens = exp.tokenizer.encode_rows(prompts[s:s + B],
                                                       add_eos=False)
            width = bucket_width(int(lens.max()) + ht.max_hint_len + 1,
                                 32, mcfg.max_source_length)
            q_ids, _ = pad_rows(rows, lens, width)
            q_len = np.minimum(lens, width).astype(np.int32)
            with profiling.span("mpr.text.clip_tokenize"):
                cids = truncate_text_ids(
                    exp.clip_tokenizer.tokenize(list(questions[s:s + B])))
            k, mine = len(rows), self._rows(len(rows))
            gather = rowmap[s:s + B][mine]
            self.chunks["fused"] += 1
            profiling.count("serve.chunks.fused")
            profiling.count("serve.rows", k)

            def run():
                g = self._tensor(gather)
                batch = {"q_ids": self._tensor(q_ids[mine]),
                         "q_len": self._tensor(q_len[mine]),
                         "clip_text_ids": self._tensor(cids[mine]),
                         "prefix": pref_dev[g], "img_emb": emb_dev[g]}
                return self._gather_rows(fused_serve_step(
                    self.params, mcfg, batch, index.embeddings,
                    index.index_sq, ht.aid, ht.hint_ids, ht.hint_len,
                    k=exp.k, use_quantifier=exp.use_quantifier,
                    eos_id=exp.tokenizer.eos_id,
                    max_new_tokens=self.max_new_tokens,
                    skip_first=index.is_training_phase, draft_ids=drafts,
                    spec_block=spec), k)
            return run

        return self._run_pipeline(range(0, n, B), prepare)

    def _in_mode(self, fn):
        """On the dispatcher thread: ``fn()`` in inference mode on the
        server's stream."""
        with self._on_device():
            return fn()

    def _dispatch(self, run: Callable[[], torch.Tensor],
                  chunk: tuple) -> np.ndarray:
        """On the dispatcher thread: :meth:`_run_chunk` in the chunk's
        span. ``chunk``: (the request's id, the chunk's index in it,
        whether it is the last, the request's start and the chunk's
        queueing, from ``profiling.now_ns``): the queue wait is recorded
        first, and the request's span ends after its last chunk."""
        rid, index, last, t_request, t_queued = chunk
        profiling.record("mpr.serve.queue_wait", t_queued,
                         profiling.now_ns(), request_id=rid, chunk=index)
        with profiling.span("mpr.serve.chunk", request_id=rid, chunk=index):
            ids = self._run_chunk(run)
        if last:
            profiling.record("mpr.serve.request", t_request,
                             profiling.now_ns(), request_id=rid)
        return ids

    def _run_chunk(self, run: Callable[[], torch.Tensor]) -> np.ndarray:
        """On the dispatcher thread: a chunk's device work, in inference
        mode on the server's stream, and its ids fetched."""
        with self._on_device():
            with profiling.span("mpr.serve.run"):
                ids = run()
            with profiling.span("mpr.serve.fetch"):
                return ids.cpu().numpy()

    def _run_pipeline(self, starts, prepare,
                      classify: bool = False) -> AnswerHandle:
        """Per chunk, ``prepare(start)`` does the host work on the calling
        thread and returns the device work, which the dispatcher thread
        runs; the oldest chunk is consumed once more than
        ``pipeline_depth`` are queued or running. ``submit`` returns with
        the last ones still there; ``result()`` drains them. ``classify``:
        the chunks return class ids, not token ids."""
        starts = list(starts)
        rid, t_request = self._request
        handle = AnswerHandle(self, len(starts), rid)
        for i, s in enumerate(starts):
            with profiling.span("mpr.serve.prepare", request_id=rid,
                                chunk=i):
                run = prepare(s)
            chunk = (rid, i, i == len(starts) - 1, t_request,
                     profiling.now_ns())
            self._queue.append(
                (handle, self._dispatcher.submit(self._dispatch, run, chunk),
                 classify))
            while len(self._queue) > self.pipeline_depth:
                self._consume_one()
        return handle

    def _consume_one(self) -> None:
        """The oldest chunk's ids -> its handle's answers (detokenized, or
        class ids through ``label2ans``, on the calling thread). The error
        of a chunk that failed is kept for its handle's ``result()`` and
        for the next ``submit``."""
        handle, future, classify = self._queue.pop(0)
        index = handle._chunks - handle._remaining
        handle._remaining -= 1
        with profiling.span("mpr.serve.consume",
                            request_id=handle.request_id, chunk=index):
            try:
                with profiling.span("mpr.serve.wait"):
                    preds = future.result()
            except Exception as e:  # noqa: BLE001 (raised again, see above)
                handle._error = handle._error or e
                self._failed = self._failed or e
                return
            exp = self.exp
            if classify:
                handle.answers.extend(exp.label2ans[int(c)] for c in preds)
                return
            self.decode_steps += steps_run(preds,
                                           exp.model_cfg.eos_token_id)
            with profiling.span("mpr.text.decode"):
                for row in preds:
                    handle.answers.append(exp.tokenizer.decode(
                        row, skip_special_tokens=True))

    def _raise_failed(self) -> None:
        """Raise, before new work is queued, the error of a chunk that has
        failed and that no ``result()`` has raised yet. The queue is FIFO:
        the chunks before a failed one are done too, and are consumed on
        the way."""
        while any(f.done() and f.exception() is not None
                  for _, f, _ in self._queue):
            self._consume_one()
        if self._failed is not None:
            error, self._failed = self._failed, None
            raise error

    def _drain(self, handle: AnswerHandle) -> None:
        while not handle.done():
            self._consume_one()
