"""The greedy loop alone (``models/greedy.py``), on a toy step over a
table of logits on the CPU, no model: the emit (argmax with the first
maximum on ties, pad after a row's EOS) against a plain Python reference
with rows that finish at different steps, one EOS check an emitted token,
and on emulated graphs a key's first decode running its first step plain,
then capturing once, and every later decode only replaying."""

import pytest

torch = pytest.importorskip("torch")

from multimodalpromptretrieval_tpu_torch.models import greedy  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import graphs  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import profiling  # noqa: E402
from torch_graph_emulation import emulate, fresh  # noqa: E402,F401

B, V, N, EOS, PAD = 3, 8, 5, 1, 0


def _table(eos_at=(2, 4, None)):
    """(N, B, V) logits: row b emits EOS at column ``eos_at[b]`` (never at
    None); at column 3 row 2 has two maxima, at 5 and 7."""
    lg = torch.rand((N, B, V), generator=torch.Generator().manual_seed(0))
    lg[:, :, EOS] = -1.0
    for b, col in enumerate(eos_at):
        if col is not None:
            lg[col - 1, b, EOS] = 2.0
    lg[2, 2, 5] = lg[2, 2, 7] = 3.0
    return lg


def _want(lg) -> list:
    """The ids by plain Python: the first maximum, pad after EOS."""
    rows = []
    for b in range(B):
        row, done = [PAD], False
        for t in range(N):
            scores = lg[t, b].tolist()
            best = max(range(V), key=lambda v: (scores[v], -v))
            row.append(PAD if done else best)
            done = done or best == EOS
        rows.append(row)
    return rows


class _State:
    def __init__(self):
        self.x = torch.zeros(())  # the steps' segments have run x times


def _step(lg, calls):
    def step(st, run, t):
        kind = ("capture" if run.capturing else
                "plain" if run is greedy.PLAIN else "replay")
        calls.append((t, kind))
        run(0, lambda s: s.x.add_(1), st)
        return None if run.capturing else lg[t]
    return step


def _decode(lg, first, g=None, state=None, early_stop=True, calls=None):
    ids = torch.full((B, 1 + N), PAD, dtype=torch.int32)
    calls = [] if calls is None else calls
    return greedy.decode("toy", _step(lg, calls), state or _State(), g, ids,
                         eos=EOS, pad=PAD, first=lg[0] if first else None,
                         early_stop=early_stop)


def _counters():
    c = profiling.snapshot()["counters"]
    return {k: c.get("toy." + k, 0) for k in (
        "decode_steps", "eos_syncs", "decode_graph_steps",
        "decode_graph_captures")}


@pytest.mark.parametrize("first", [False, True], ids=["t5", "lm"])
@pytest.mark.parametrize("early_stop", [False, True])
def test_emit_pads_after_eos_and_takes_the_first_maximum(first, early_stop):
    """Rows done at columns 2 and 4 and never: the Python reference's ids,
    the tie at the first maximum, a step a column after the prefill's, and
    one EOS check an emitted token under ``early_stop``."""
    lg = _table()
    calls = []
    ids = _decode(lg, first, early_stop=early_stop, calls=calls)
    assert ids.tolist() == _want(lg)
    assert ids[2, 3] == 5 and ids[0, 3:].eq(PAD).all()
    assert [t for t, _ in calls] == list(range(int(first), N))
    assert {kind for _, kind in calls} == {"plain"}
    counts = _counters()
    assert counts["decode_steps"] == N - int(first)
    assert counts["eos_syncs"] == (N if early_stop else 0)
    assert counts["decode_graph_steps"] == counts["decode_graph_captures"] == 0


@pytest.mark.parametrize("first", [False, True], ids=["t5", "lm"])
def test_the_loop_stops_once_every_row_has_emitted_eos(first):
    """Every row done at column 2 (at column 1 for the LM's prefill): no
    step after, one check an emitted token."""
    lg = _table(eos_at=(2, 2, 2) if not first else (1, 1, 1))
    calls = []
    ids = _decode(lg, first, calls=calls)
    emitted = 1 if first else 2
    assert ids[:, emitted].eq(EOS).all()
    assert ids[:, emitted + 1:].eq(PAD).all()
    counts = _counters()
    assert counts["decode_steps"] == len(calls) == emitted - int(first)
    assert counts["eos_syncs"] == emitted


@pytest.mark.parametrize("first", [False, True], ids=["t5", "lm"])
def test_first_decode_runs_plain_then_captures_once(monkeypatch, first):
    """On emulated graphs through :func:`greedy.hold`: the key's first
    decode runs its first step plain, captures at its second and replays
    from there; a second decode only replays; a new key captures anew. The
    capture leaves no write in the state and the ids equal the plain
    path's."""
    emulate(monkeypatch)
    lg = _table()
    want = _decode(lg, first)
    profiling.reset()
    weight = torch.zeros(2)
    t0 = int(first)

    def decode(key):
        calls = []

        def body(st, g):  # a key's state outlives its decodes
            st.x.zero_()
            return _decode(lg, first, g, st, calls=calls), st.x.item()

        return greedy.hold(key, (weight,), _State, torch.device("cpu"),
                           body), calls

    (ids, runs), calls = decode(("a",))
    assert torch.equal(ids, want) and runs == N - t0
    assert calls == [(t0, "plain"), (t0 + 1, "capture")] + [
        (t, "replay") for t in range(t0 + 1, N)]
    (ids, runs), calls = decode(("a",))
    assert torch.equal(ids, want) and runs == N - t0
    assert calls == [(t, "replay") for t in range(t0, N)]
    decode(("b",))
    assert len(graphs.KEYS) == 2
    counts = _counters()
    assert counts["decode_graph_captures"] == 2
    assert counts["decode_graph_steps"] == 3 * (N - t0) - 2
    assert counts["decode_steps"] == 3 * (N - t0)
