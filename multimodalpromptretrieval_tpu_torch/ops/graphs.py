"""CUDA graphs of a greedy decode step's kernel chains (``models/greedy.py``
runs them for both generators).

A step is cut at the calls that stay Python calls (the attention kernels,
the router and the experts, the LM head: the benchmark replaces them at
call time, which a graph would hide) into segments, each a function of the
decode's fixed buffers and of earlier segments' outputs. A set of graphs
(:class:`Graphs`) captures them once and replays them in order, each
rewriting its kept outputs in place; :func:`keyed` makes the key, and
:data:`KEYS` holds the sets by key, the least recently used dropped first.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Iterable, List

import torch

from multimodalpromptretrieval_tpu_torch.ops.quant import QWeight


class Graph:
    """One segment captured on the card: :meth:`capture` records
    ``fn(*args)``'s launches on the set's side stream into its memory pool
    and keeps the outputs; :meth:`replay` launches them again on the
    current stream, which rewrites those outputs in place."""

    def __init__(self, pool, stream):
        self.pool, self.stream = pool, stream
        self.graph = torch.cuda.CUDAGraph()
        self.out = None

    def capture(self, fn, *args):
        with torch.cuda.stream(self.stream):
            # thread_local: the server's other threads keep queuing work
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")
            try:
                self.out = fn(*args)
            finally:
                self.graph.capture_end()
        return self.out

    def replay(self):
        self.graph.replay()
        return self.out


class Graphs:
    """The graphs of one key: the segments of a step, in order, over this
    key's ``state`` (the model's fixed buffers), captured once and sharing
    one memory pool (they replay in the order they were captured). Its
    decodes run one at a time (``lock``); a decode on another stream than
    the last first waits for it (:meth:`begin`)."""

    def __init__(self, state, device: torch.device):
        self.state, self.device = state, device
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.graphs: List[Graph] = []
        self.lock = threading.Lock()
        self.stream = None

    def begin(self) -> None:
        now = torch.cuda.current_stream(self.device)
        if self.stream is not None and self.stream != now:
            now.wait_stream(self.stream)
        self.stream = now

    def capture(self, step) -> None:
        """Capture the segments that ``step(segment)`` runs, in order; on
        a failure none is kept."""
        def segment(i, fn, *args):
            g = Graph(self.pool, self.side)
            self.graphs.append(g)
            return g.capture(fn, *args)

        try:
            step(segment)
        except BaseException:
            self.graphs.clear()
            raise

    def replay(self, i: int, fn: Callable, *args):
        return self.graphs[i].replay()


class GraphKeys:
    """At most ``max_keys`` sets of graphs by key, the least recently used
    dropped first."""

    def __init__(self, max_keys: int):
        self.max_keys = max_keys
        self._sets: "collections.OrderedDict[tuple, Graphs]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: tuple, make: Callable[[], Graphs]) -> Graphs:
        """The set of ``key``, made by ``make()`` (not yet captured) on its
        first call."""
        with self._lock:
            g = self._sets.pop(key, None)
            if g is None:
                g = make()
            self._sets[key] = g
            while len(self._sets) > self.max_keys:
                self._sets.popitem(last=False)
        return g

    def clear(self) -> None:
        with self._lock:
            self._sets.clear()

    def __len__(self) -> int:
        return len(self._sets)


# the sets of both decodes; a server uses one or two
KEYS = GraphKeys(max_keys=4)


def keyed(shape_key: tuple, parts: Iterable, make_state: Callable,
          device: torch.device) -> Graphs:
    """The graphs of ``shape_key`` (the model's config and shapes), the
    GEMMs' math flags, which a capture fixes, and the (address, dtype) of
    each tensor the segments read: ``parts``' tensors and every parameter
    and int8 payload of its modules. New tensors (a reload) make a new
    key, an update in place is read live. Made over ``make_state()`` (not
    yet captured) on the key's first call."""
    matmul = torch.backends.cuda.matmul
    key = shape_key + (matmul.allow_tf32,
                       matmul.allow_bf16_reduced_precision_reduction,
                       tuple((t.data_ptr(), t.dtype) for t in _tensors(parts)))
    return KEYS.get(key, lambda: Graphs(make_state(), device))


def _tensors(parts: Iterable):
    """A tensor part itself; a module's parameters and int8 payloads."""
    for part in parts:
        if isinstance(part, torch.Tensor):
            yield part
            continue
        for m in part.modules():
            yield from (p for p in m._parameters.values() if p is not None)
            yield from (t for w in vars(m).values() if isinstance(w, QWeight)
                        for t in (w.q8, w.q_scale))
