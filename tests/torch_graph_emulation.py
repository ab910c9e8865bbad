"""What the greedy decode's graph tests share (``models/greedy.py`` over
either generator): the CUDA graphs emulated on the CPU, the ``device``
fixture that runs a scenario on emulated graphs and on the card, and each
generator's tiny model, inputs and wrappers, which keep what the
benchmark's wrappers keep (each LM-head call's logits; for the LM also each
router call's experts, each K11 call's ``key_ok`` and ``length`` and the
expert calls)."""

import pytest
import torch

from multimodalpromptretrieval_tpu_torch.models import greedy, moe_lm
from multimodalpromptretrieval_tpu_torch.models import t5 as pt5
from multimodalpromptretrieval_tpu_torch.ops import graphs, mla, moe
from multimodalpromptretrieval_tpu_torch.train import profiling

STEPS = 6
COUNTERS = ("decode_steps", "decode_graph_steps", "decode_graph_captures")


class EmulatedGraph:
    """A segment "captured" on the CPU: run once for its outputs with every
    tensor of the decode state it wrote put back (a capture launches
    nothing), then re-run at each replay into those same outputs (a replay
    rewrites them in place)."""

    def __init__(self, pool, stream):
        pass

    def capture(self, fn, *args):
        kept = [(t, t.clone()) for a in args
                if not isinstance(a, torch.nn.Module)
                for t in getattr(a, "__dict__", {}).values()
                if isinstance(t, torch.Tensor)]
        self.fn, self.args = fn, args
        self.out = fn(*args)
        for t, saved in kept:
            t.copy_(saved)
        return self.out

    def replay(self):
        new = self.fn(*self.args)
        pairs = (zip(self.out, new) if isinstance(self.out, tuple)
                 else [(self.out, new)])
        with torch.inference_mode():
            for held, value in pairs:
                if held is not value:
                    held.copy_(value)
        return self.out


def emulate(monkeypatch) -> None:
    """CPU tensors take the graph path, with :class:`EmulatedGraph`."""
    monkeypatch.setattr(graphs, "Graph", EmulatedGraph)
    monkeypatch.setattr(greedy, "use_graphs", lambda dev, tp: tp is None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh():
    """No key kept from another test (its weights' addresses may come
    back), the program's counters on and cleared."""
    graphs.KEYS.clear()
    profiling.enable()
    profiling.reset()
    yield
    graphs.KEYS.clear()
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(params=["emulated",
                        pytest.param("card", marks=pytest.mark.cuda)])
def device(request, monkeypatch):
    """The device of the graph path: the CPU with emulated graphs, or the
    card."""
    if request.param == "card":
        return card()
    emulate(monkeypatch)
    return torch.device("cpu")


class T5:
    """The T5 decode at a width of t5-small or t5-large (2 decoder layers,
    d_kv 64, the kernels' head dim), from encoder states."""

    prefix, prefill = "t5", 0  # no token before the first step
    SHAPES = {"t5_small": (512, 8, 2048), "t5_large": (1024, 16, 4096)}
    VOCAB = 1000  # apart from W and 3W: the wrappers tell the head by it

    def __init__(self, shape: str = "t5_small"):
        self.shape = shape

    def model(self, device, dtype=torch.float32, seed=0):
        """Seeded weights; the pad (start) embedding zeroed, since a random
        T5 otherwise re-emits its input token at every step."""
        d, h, ff = self.SHAPES[self.shape]
        cfg = pt5.T5Config(vocab_size=self.VOCAB, d_model=d, d_kv=64, d_ff=ff,
                           num_layers=1, num_decoder_layers=2, num_heads=h)
        params = pt5.T5(cfg, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            params.shared[cfg.pad_token_id] = 0.0
        return cfg, params.to(device, dtype)

    @staticmethod
    def inputs(cfg, device, dtype=torch.float32, B=4, L=7, seed=1):
        g = torch.Generator().manual_seed(seed)
        hidden = torch.randn((B, L, cfg.d_model), generator=g)
        mask = torch.ones((B, L), dtype=torch.int32)
        mask[0, L // 2:] = 0
        return hidden.to(device, dtype), mask.to(device)

    @staticmethod
    def generate(cfg, params, inputs, steps, early_stop=False):
        return pt5.t5_greedy_decode(params, cfg, *inputs,
                                    max_new_tokens=steps,
                                    early_stop=early_stop)

    @staticmethod
    def wrap(m, cfg, seen) -> None:
        dense = pt5.dense

        def lm_dense(x, weight, bias=None):
            y = dense(x, weight, bias)
            if x.dim() == 2 and y.shape[-1] == cfg.vocab_size:
                seen["logits"].append(y.clone())
            return y

        m.setattr(pt5, "dense", lm_dense)

    @staticmethod
    def renew(params) -> None:
        block = params.decoder.block[1]
        block.ff_ln = torch.nn.Parameter(block.ff_ln * 1.5)
        block.self_attn.o.weight = torch.nn.Parameter(
            block.self_attn.o.weight.flip(0))


class LM:
    """The LM decode on a tiny model with a dense first layer, 8 experts,
    2 a token and 1 shared, from a prefix and left-padded prompts. K11 in
    bf16 takes a latent width of 512 and a rope width a multiple of 32,
    K10 widths that are multiples of 64."""

    prefix, prefill = "lm", 1  # the prefill's token
    TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                moe_intermediate_size=64, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=4,
                n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2,
                kv_lora_rank=512, qk_nope_head_dim=16, qk_rope_head_dim=32,
                v_head_dim=16, init_std=0.1)

    def model(self, device, dtype=torch.float32, seed=0, **kw):
        cfg = moe_lm.LMConfig(**{**self.TINY, **kw})
        lm = moe_lm.MoELM(cfg, torch.Generator().manual_seed(seed))
        return cfg, moe_lm.hold_in(lm.to(device), dtype)

    @staticmethod
    def inputs(cfg, device, dtype=torch.float32, B=4, P=3, W=7, seed=1):
        """A prefix and right-padded prompts of B different lengths (one of
        them W, one of them 1)."""
        g = torch.Generator().manual_seed(seed)
        prefix = torch.randn((B, P, cfg.hidden_size), generator=g)
        ids = torch.zeros((B, W), dtype=torch.long)
        mask = torch.zeros((B, W), dtype=torch.long)
        lens = [W, 1] + torch.randint(1, W + 1, (B - 2,), generator=g).tolist()
        for b, n in enumerate(lens):
            ids[b, :n] = torch.randint(2, cfg.vocab_size, (n,), generator=g)
            mask[b, :n] = 1
        return prefix.to(device, dtype), ids.to(device), mask.to(device)

    @staticmethod
    def generate(cfg, lm, inputs, steps):
        return moe_lm.lm_generate(lm, cfg, *inputs, max_new_tokens=steps)

    @staticmethod
    def wrap(m, cfg, seen) -> None:
        seen.update(routes=[], k11=[], experts=0)
        head, route = moe_lm.lm_head, moe.route
        experts, attend = moe.moe_experts, mla.mla_decode_attention

        def lm_head(x, weight):
            y = head(x, weight)
            seen["logits"].append(y.clone())
            return y

        def route_(h, *a, **kw):
            idx, w = route(h, *a, **kw)
            seen["routes"].append(idx.clone())
            return idx, w

        def moe_experts(h, idx, w, gate_up, down):
            seen["experts"] += 1
            return experts(h, idx, w, gate_up, down)

        def mla_decode(q_lat, q_pe, cache, key_ok, length, scale):
            seen["k11"].append((key_ok, length))
            return attend(q_lat, q_pe, cache, key_ok, int(length), scale)

        m.setattr(moe_lm, "lm_head", lm_head)
        m.setattr(moe, "route", route_)
        m.setattr(moe, "moe_experts", moe_experts)
        m.setattr(mla, "mla_decode_attention", mla_decode)

    @staticmethod
    def renew(lm) -> None:
        layer = lm.layers[1]
        layer.ffn_norm = torch.nn.Parameter(layer.ffn_norm * 1.5)
        layer.kvb = torch.nn.Parameter(layer.kvb.flip(0))


def run(gen, monkeypatch, cfg, model, inputs, *, plain=False, steps=STEPS,
        mode=torch.inference_mode, **kw):
    """(ids, what the wrappers saw, the counters of this call without the
    generator's prefix); ``plain``: the plain loop on the same device."""
    seen = {"logits": []}
    with monkeypatch.context() as m:
        gen.wrap(m, cfg, seen)
        if plain:
            m.setattr(greedy, "use_graphs", lambda dev, tp: False)
        before = dict(profiling.snapshot()["counters"])
        with mode():
            ids = gen.generate(cfg, model, inputs, steps, **kw)
        after = profiling.snapshot()["counters"]
    names = {k: f"{gen.prefix}.{k}" for k in COUNTERS}
    return ids, seen, {k: after.get(n, 0) - before.get(n, 0)
                       for k, n in names.items()}


def same(gen, got, want) -> None:
    """Identical ids, steps, LM-head logits a step and routes a call."""
    (ids, seen, counts), (ids0, seen0, counts0) = got, want
    assert torch.equal(ids.cpu(), ids0.cpu())
    assert counts["decode_steps"] == counts0["decode_steps"]
    assert len(seen0["logits"]) == gen.prefill + counts0["decode_steps"]
    for name in ("logits", "routes"):
        assert len(seen.get(name, ())) == len(seen0.get(name, ()))
        for j, (a, b) in enumerate(zip(seen.get(name, ()),
                                       seen0.get(name, ()))):
            assert torch.equal(a, b), f"{name} {j} differ"
