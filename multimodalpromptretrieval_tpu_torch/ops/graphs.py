"""CUDA graphs of a greedy decode step's kernel chains, shared by the two
generators' decodes (``models/t5.py``, ``models/moe_lm.py``).

A step is cut at the calls that stay Python calls (the attention kernels,
the router and the experts, the LM head: the benchmark replaces them at
call time, which a graph would hide) into segments: the norms, products,
residual adds and cache writes between them, each a function of the
decode's fixed buffers and of earlier segments' outputs. A key's first
decode runs its first step as plain calls (which builds and warms what the
segments launch), then captures the segments once (:class:`Graphs`); every
later step replays them in order, each rewriting its kept outputs in place.
The segment functions, the state and the key belong to each model; this
module holds what they share: the capture and replay, the key's makeup
and the sets of graphs by key (:func:`keyed`; :data:`KEYS`, the least
recently used dropped first) and the choice of the path
(:func:`use_graphs`).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Iterable, List

import torch


def call(i: int, fn: Callable, *args):
    """A segment run as plain calls (the CPU, tensor parallelism, a key's
    first step)."""
    return fn(*args)


def use_graphs(device: torch.device, tp=None) -> bool:
    """The segments run as CUDA graphs on the card without tensor
    parallelism (whose reduces are collectives)."""
    return device.type == "cuda" and tp is None


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


def keyed(shape_key: tuple, weights: Iterable[torch.Tensor],
          make_state: Callable, device: torch.device) -> Graphs:
    """The graphs of ``shape_key`` (the model's config and shapes), the
    GEMMs' math flags, which a capture fixes, and the (address, dtype) of
    each tensor of ``weights`` the segments read: new tensors (a reload)
    make a new key, an update in place is read live. Made over
    ``make_state()`` (not yet captured) on the key's first call."""
    matmul = torch.backends.cuda.matmul
    key = shape_key + (matmul.allow_tf32,
                       matmul.allow_bf16_reduced_precision_reduction,
                       tuple((t.data_ptr(), t.dtype) for t in weights))
    return KEYS.get(key, lambda: Graphs(make_state(), device))
