"""The routing controls of the LM cells' check: the program with a fault
in its router that moves a token's experts among near ties, everything
else as served.

    python3 -m portbench.lm_route_control --fault bias_half \\
        --workload kimi-vl-a3b.serve-pass --seed <n> --seconds <s>

takes ``portbench.run``'s arguments after ``--fault`` and prints its
lines. The faults:

* ``bias_half``: the correction bias at half its value in the ranking (a
  bias scaled or stored wrong). It moves the choices among experts whose
  ``score + bias`` lie within about 0.01-0.03 of the 6th: mostly within
  the check's ``route_tol``, where the reference takes the program's
  choice, so ``logit_err`` cannot see it; ``route_flip_share`` does.
* ``router_bf16``: the scores computed in bf16 (the product of the
  hidden state and the router weight rounded to bf16, the sigmoid in
  bf16; the bias added and the top k taken in fp32). Its rounding, at
  most ~0.002 in a score, is smaller than what the program's bf16 hidden
  state already moves (the flips' margins reach 0.03-0.04), so no limit
  of the check sees it.

Never a benchmark run.
"""

import argparse
import sys

from portbench import run


def route_bf16(h, weight, bias, top_k: int, scale: float,
               normalize: bool = True):
    """``ops.moe.route`` with the scores computed in bf16."""
    import torch

    scores = torch.sigmoid(torch.matmul(h.bfloat16(),
                                        weight.bfloat16().t())).float()
    _, idx = torch.topk(scores + bias.float(), top_k, dim=-1)
    w = scores.gather(-1, idx)
    if normalize:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * scale


def fault(name: str):
    """The router of fault ``name`` (module docstring), over the program's
    ``ops.moe.route`` as it is when this is called."""
    if name == "router_bf16":
        return route_bf16
    if name != "bias_half":
        raise ValueError(f"unknown fault {name!r}")
    from multimodalpromptretrieval_tpu_torch.ops import moe

    route = moe.route

    def bias_half(h, weight, bias, top_k: int, scale: float,
                  normalize: bool = True):
        return route(h, weight, bias * 0.5, top_k, scale, normalize)
    return bias_half


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--fault", choices=("bias_half", "router_bf16"),
                        required=True)
    args, rest = parser.parse_known_args(argv)
    from multimodalpromptretrieval_tpu_torch.ops import moe

    moe.route = fault(args.fault)  # before served_lm.Capture wraps it
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
