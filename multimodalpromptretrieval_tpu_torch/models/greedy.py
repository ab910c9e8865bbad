"""The greedy decode of both generators (``models/t5.py``,
``models/moe_lm.py``), written once; each keeps its own step and state.

:func:`hold` picks the path from the generator's key (config and shapes),
the parts its segments read and its state's factory: on CUDA tensors
without tensor parallelism (:func:`use_graphs`) the key's graphs
(``ops/graphs.keyed``) under their lock, else a new state run as plain
calls. :func:`decode` runs ``step(state, run, t)``, which reads column
``t`` of the ids, runs its segments through ``run`` (a plain call, a
capture or a replay) and gives the logits of column ``t + 1``. A key's
first decode runs its first step as plain calls (which builds and warms
what the segments launch), then captures the segments once; later steps
replay them. While ``run.capturing`` a step skips its Python calls (those
the benchmark replaces at call time, the LM head) and returns nothing. The
emit: argmax on the compute-dtype logits, first maximum on ties, pad after
a row's EOS; with ``early_stop`` a host check after every emitted token.

Under ``train/profiling``, ``prefix`` the generator's (``"t5"``, ``"lm"``):
spans ``mpr.<prefix>.decode.step`` a step, in it ``.eos_sync`` around the
check; counters ``<prefix>.decode_steps``, ``<prefix>.eos_syncs``,
``<prefix>.decode_graph_steps`` (steps replayed) and
``<prefix>.decode_graph_captures`` (sets of graphs captured).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from multimodalpromptretrieval_tpu_torch.ops import graphs
from multimodalpromptretrieval_tpu_torch.train import profiling


def use_graphs(device: torch.device, tp=None) -> bool:
    """The segments run as CUDA graphs on the card without tensor
    parallelism (whose reduces are collectives)."""
    return device.type == "cuda" and tp is None


class Run:
    """How a step runs its segments: ``run(i, fn, *args)`` runs segment
    ``i`` through ``segment``; ``capturing``: the step skips its Python
    calls (a capture records the segments only)."""

    def __init__(self, segment: Callable, capturing: bool = False):
        self.segment, self.capturing = segment, capturing

    def __call__(self, i: int, fn: Callable, *args):
        return self.segment(i, fn, *args)


PLAIN = Run(lambda i, fn, *args: fn(*args))


def hold(key: tuple, parts: Iterable, make_state: Callable,
         device: torch.device, body: Callable, tp=None):
    """``body(state, g)``: the key's graphs ``g`` and their state under
    their lock on the graph path, else ``make_state()`` and None."""
    if not use_graphs(device, tp):
        return body(make_state(), None)
    g = graphs.keyed(key, parts, make_state, device)
    with g.lock:
        g.begin()
        return body(g.state, g)


def decode(prefix: str, step: Callable, state, g: Optional[graphs.Graphs],
           ids: torch.Tensor, *, eos: int, pad: int,
           first: Optional[torch.Tensor] = None,
           early_stop: bool = True) -> torch.Tensor:
    """Fill ``ids`` (B, 1 + n) int32, column 0 set: column 1 from ``first``
    (the prefill's logits) when given, then a step a column, until every
    row has emitted EOS (``early_stop``) or the columns are out. Steps run
    as plain calls, or as the replays of ``g`` once it is captured."""
    finished = torch.zeros_like(ids[:, 0], dtype=torch.bool)
    t0 = 0
    if first is not None:
        finished, t0 = _emit(ids, 0, first, finished, eos, pad), 1
        if early_stop and _all_finished(prefix, finished):
            return ids
    for t in range(t0, ids.shape[1] - 1):
        with profiling.span(f"mpr.{prefix}.decode.step"):
            profiling.count(f"{prefix}.decode_steps")
            run = PLAIN
            if g is not None and (g.graphs or t > t0):
                if not g.graphs:
                    g.capture(lambda segment: step(state, Run(segment, True),
                                                   t))
                    profiling.count(f"{prefix}.decode_graph_captures")
                run = Run(g.replay)
                profiling.count(f"{prefix}.decode_graph_steps")
            finished = _emit(ids, t, step(state, run, t), finished, eos, pad)
            if early_stop and _all_finished(prefix, finished):
                break
    return ids


def _emit(ids: torch.Tensor, t: int, logits: torch.Tensor,
          finished: torch.Tensor, eos: int, pad: int) -> torch.Tensor:
    """Column ``t + 1`` of ``ids``: the argmax of ``logits`` (B, V), the
    first maximum on ties, pad where a row had finished. -> the rows that
    have now emitted EOS."""
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt = torch.where(finished, pad, nxt)
    ids[:, t + 1] = nxt
    return finished | (nxt == eos)


def _all_finished(prefix: str, finished: torch.Tensor) -> bool:
    """The host check (one sync); the server runs the decode on its
    dispatcher thread, so the sync holds no caller."""
    with profiling.span(f"mpr.{prefix}.decode.eos_sync"):
        profiling.count(f"{prefix}.eos_syncs")
        return bool(finished.all())
