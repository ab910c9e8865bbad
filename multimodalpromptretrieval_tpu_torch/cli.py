"""Command line of the port: the JAX package's ``main.py`` verbs on the
same JSON config.

    python -m multimodalpromptretrieval_tpu_torch.cli --train --config c.json
    python -m multimodalpromptretrieval_tpu_torch.cli --resume --config c.json
    python -m multimodalpromptretrieval_tpu_torch.cli --test --config c.json
    python -m multimodalpromptretrieval_tpu_torch.cli --serve --config c.json \\
        [--requests requests.jsonl] [--quantize int8|int8_all] \\
        [--spec-decode 4] [--length-sort] [--trace DIR]
    python -m multimodalpromptretrieval_tpu_torch.cli --eval --config c.json \\
        [--qid 1234]
    [--model_file models/foo.npz] [--device cpu]
    [--coordinator host:port --num_processes N --process_id I]

Counterpart of ``multimodalpromptretrieval_tpu/cli.py``. It runs on the card
unless ``--device`` names another device (``--device cpu``), the
counterpart of ``--platform``. ``--eval`` writes the attention figures of
``--qid`` (or of each id in ``logs/correct_ids.txt``) with the weights of
the checkpoint when there is one (``train/visualize.py``). The process-group
flags, or torchrun's environment (``WORLD_SIZE``), make the process join a
``torch.distributed`` group before the experiment is built
(``parallel/multihost.py``); the ``parallelism`` config key then runs data,
tensor, pipeline or sequence parallelism over it, and ``--serve`` answers
the request stream on every process, each chunk's rows split over
"data". ``--gpu_id`` is accepted and ignored, as in the JAX package.
``--serve --trace DIR`` serves under the profiler with the program's spans
on (``train/profiling``): ``DIR/trace.json``, the Chrome trace with the
spans in it, and ``DIR/spans.json``, their totals, counters and last raw
spans, written at exit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train", help="train a model", action="store_true")
    p.add_argument("--resume", help="Resume model training",
                   action="store_true")
    p.add_argument("--test", help="test a model", action="store_true")
    p.add_argument("--eval", help="evaluate a model", action="store_true")
    p.add_argument("--serve", action="store_true",
                   help="answer JSONL requests from stdin (or --requests): "
                        'one object per line {"question": ..., "task": '
                        '"open", "image_name": <name in the dataset image '
                        'cache> | "image": <image file path>}; answers '
                        'stream to stdout as {"answer": ...} in order')
    p.add_argument("--requests",
                   help="serve: read requests from this JSONL file "
                        "instead of stdin")
    p.add_argument("--quantize", choices=["int8", "int8_all"],
                   help="serve with int8 W8A8 weights (ops/quant; 'int8' "
                        "keeps retrieval ranks those of full precision)")
    p.add_argument("--spec-decode", type=int, default=0,
                   help="serve: hint-draft speculative decode block size "
                        "(0 = lockstep greedy; the same answers)")
    p.add_argument("--length-sort", action="store_true",
                   help="serve: re-chunk each request by predicted answer "
                        "length (answers stay in request order)")
    p.add_argument("--trace", metavar="DIR",
                   help="serve: write DIR/trace.json (the profiler's Chrome "
                        "trace with the program's spans) and DIR/spans.json "
                        "(span totals, counters, last spans) at exit")
    p.add_argument("--config", help="config file name in the config folder")
    p.add_argument("--gpu_id", help="ignored")
    p.add_argument("--model_file",
                   help="optional path to model to save/load")
    p.add_argument("--qid", help="Question ID to analyze")
    p.add_argument("--device",
                   help="torch device to run on (default: the CUDA card)")
    # several processes: the same command in each, with its process id;
    # omitted values come from torchrun's environment (MASTER_ADDR, ...)
    p.add_argument("--coordinator",
                   help="host:port of process 0; enables multi-process mode")
    p.add_argument("--num_processes", type=int,
                   help="number of processes in the job")
    p.add_argument("--process_id", type=int,
                   help="this process's rank in the job")
    return p


@contextlib.contextmanager
def traced(log_dir: str):
    """The program's spans on and the profiler running for the block;
    ``log_dir/trace.json`` and ``log_dir/spans.json`` (``snapshot()``)
    written when it ends."""
    from multimodalpromptretrieval_tpu_torch.train import profiling

    profiling.enable()
    try:
        with profiling.trace(log_dir):
            yield
    finally:
        profiling.enable(False)
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump(profiling.snapshot(), f)


def serve_stream(exp, stream, out, quantize=None, spec_decode: int = 0,
                 length_sort: bool = False) -> int:
    """Drive :class:`serve.MPRServer` over a JSONL request stream.

    Each input line is one request: ``{"question": str, "task": str
    (default "open"), "image_name": <name in the dataset's preprocessed
    image cache> | "image": <path to an image file>}``. Responses stream
    to ``out`` in request order, one line per request: ``{"answer": str}``
    on success, ``{"error": str}`` for a request that could not be served
    (malformed JSON, missing or invalid fields, unknown image_name,
    unreadable image file). A bad request never takes down the stream or
    the other requests in its batch. Requests are batched to the
    experiment's batch size and pipelined (two chunks queued or running
    while the host reads the next batch). ``quantize``, ``spec_decode``,
    ``length_sort``: the :class:`serve.MPRServer` options. Returns the
    number of response lines written (answers + errors).
    """
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer

    server = MPRServer(exp, quantize=quantize, pipeline_depth=2,
                       spec_decode=spec_decode, length_sort=length_sort)
    size = exp.model_cfg.clip.image_resolution
    path_cache: dict = {}

    def resolve(req):
        name = req.get("image_name")
        if name is not None:
            return name, exp.images[name]
        path = req.get("image")
        if path is None:
            raise ValueError("request needs 'image_name' or 'image'")
        if path not in path_cache:
            from PIL import Image

            from multimodalpromptretrieval_tpu_torch.ops.image import (
                preprocess_pil_images,
            )

            with Image.open(path) as im:
                if im.mode != "RGB":
                    im = im.convert("RGB")
                path_cache[path] = preprocess_pil_images(
                    [im.copy()], size=size, device=exp.device)[0]
            # bounded: a long stream over many distinct files would
            # otherwise keep every preprocessed array (~600 KB at 224 px)
            while len(path_cache) > 4096:
                path_cache.pop(next(iter(path_cache)))
        return path, path_cache[path]

    def parse(line: str):
        """-> ("ok", id, img, question, task) | ("err", message).

        The broad except is deliberate: this is the protocol boundary of
        a long-running server, and any per-request failure (bad JSON,
        missing fields, unknown image_name, PIL decode error) must become
        an in-order {"error": ...} response, not a process crash."""
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            q = req.get("question")
            if not isinstance(q, str) or not q:
                raise ValueError("request needs a non-empty string "
                                 "'question'")
            task = req.get("task", "open")
            if not isinstance(task, str):
                raise ValueError("'task' must be a string")
            rid, img = resolve(req)
            return ("ok", rid, img, q, task)
        except Exception as e:  # noqa: BLE001 (see the docstring)
            return ("err", f"{type(e).__name__}: {e}")

    B = exp.batch_size
    pending: list = []  # (AnswerHandle | None, per-row error layout)
    total = 0

    def emit(handle, layout):
        nonlocal total
        answers = iter(handle.result()) if handle is not None else iter(())
        for err in layout:
            out.write(json.dumps({"answer": next(answers)} if err is None
                                 else {"error": err}) + "\n")
            total += 1
        out.flush()

    def flush(buf):
        ok = [b for b in buf if b[0] == "ok"]
        layout = [None if b[0] == "ok" else b[1] for b in buf]
        h = None
        if ok:
            _, ids, imgs, qs, tasks = zip(*ok)
            h = server.submit(np.stack(imgs), list(qs), list(tasks),
                              image_ids=list(ids))
        pending.append((h, layout))

    buf: list = []
    for line in stream:
        line = line.strip()
        if not line:
            continue
        buf.append(parse(line))
        if len(buf) < B:
            continue
        flush(buf)
        buf = []
        while len(pending) > 1:  # keep one request in flight
            emit(*pending.pop(0))
    if buf:
        flush(buf)
    for h, layout in pending:
        emit(h, layout)
    return total


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from multimodalpromptretrieval_tpu_torch.parallel import multihost

    joined = (args.coordinator or args.num_processes is not None
              or args.process_id is not None or "WORLD_SIZE" in os.environ)
    if joined:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, device=args.device)
    try:
        _run(args)
    finally:
        if joined:
            multihost.shutdown()


def _run(args) -> None:
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        run_from_config,
    )

    exp, _ = run_from_config(args.config, train=args.train,
                             resume=args.resume, test=args.test,
                             model_file=args.model_file, device=args.device)
    if args.serve:
        stream = open(args.requests) if args.requests else sys.stdin
        try:
            with (traced(args.trace) if args.trace
                  else contextlib.nullcontext()):
                serve_stream(exp, stream, sys.stdout,
                             quantize=args.quantize,
                             spec_decode=args.spec_decode,
                             length_sort=args.length_sort)
        finally:
            if args.requests:
                stream.close()
    if args.eval:
        from multimodalpromptretrieval_tpu_torch.train.visualize import (
            visualize_correct_ids,
        )

        if os.path.exists(exp.model_path):
            exp.load_weights()
        visualize_correct_ids(exp, qid=args.qid)


if __name__ == "__main__":
    main()
