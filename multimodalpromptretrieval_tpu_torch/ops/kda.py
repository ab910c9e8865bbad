"""Kimi Delta Attention (KDA): the recurrent layers of the Kimi-Linear LM
generator (``models/moe_lm.py``).

Replaces no TPU kernel: the JAX package has no linear attention. The port
added it for Kimi-Linear-48B-A3B, whose KDA layers (Kimi Linear technical
report, arXiv:2510.26692; fla-org's ``KimiDeltaAttention``) carry, per row
and head, a (K x V) fp32 state S through a gated delta rule with a decay
for each key channel:

    S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t * scale,        alpha_t = exp(g_t)

q_t and k_t are L2-normalised here (eps 1e-6, as fla's
``use_qk_l2norm_in_kernel``); ``g`` (the log-decay, <= 0) and ``beta``
come in fp32, q / k / v in the compute dtype, and the state is fp32
throughout. A token whose ``valid`` flag is 0 (a pad) is an identity step
(beta 0, g 0): the state passes it unchanged.

* :func:`kda_prefill` (K12 on a CUDA tensor): the tokens of a prefill
  from a zero state, the final state written into ``state``; the chunked
  WY / UT form in chunks of 64 (:func:`kda_prefill_reference` is its plain
  version, the same arithmetic batched in torch, :func:`kda_chunked` the
  chunked form from any state). q / k / v come in before the layer's
  short causal convolution, which it applies first with SiLU
  (:func:`short_conv`), as the prefill needs no other copy of them.
* :func:`kda_decode` (K13 on a CUDA tensor): one token a row, the state
  updated in place (:func:`kda_decode_reference`).

Both kernels are CUDA C++ (``csrc/kda.cu``, which says what bounds them
and how they are built) and take K = V = 128. A CPU tensor takes the plain
version; a CUDA tensor the kernel, or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build

CHUNK = 64
NORM_EPS = 1e-6
_WIDTH = 128  # K and V the kernels take
_DTYPES = (torch.float32, torch.bfloat16)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    """``x / sqrt(sum x^2 + 1e-6)`` over the last axis, in fp32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + NORM_EPS)


def kda_decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, beta: torch.Tensor,
                         state: torch.Tensor, scale: float,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain step. ``q`` / ``k`` (B, H, K), ``v`` (B, H, V), ``g`` (B,
    H, K) fp32, ``beta`` (B, H) fp32, ``state`` (B, H, K, V) fp32, updated
    in place; -> o (B, H, V) in ``q``'s dtype (into ``out`` if given)."""
    qn, kn = l2norm(q), l2norm(k)
    S = state * g.float().exp()[..., None]
    u = beta.float()[..., None] * (
        v.float() - torch.einsum("bhk,bhkv->bhv", kn, S))
    S = S + kn[..., None] * u[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", qn, S) * scale
    state.copy_(S)
    if out is None:
        return o.to(q.dtype)
    return out.copy_(o)


def short_conv(x: torch.Tensor, taps: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """SiLU of the depthwise causal convolution of ``x`` (B, L, C) with
    ``taps`` (C, W) (the oldest input first), the inputs at pads and before
    token 0 zero; fp32."""
    W, L = taps.shape[1], x.shape[1]
    xp = torch.nn.functional.pad(x.float() * valid[..., None],
                                 (0, 0, W - 1, 0))
    y = sum(xp[:, i:i + L] * taps[:, i].float() for i in range(W))
    return torch.nn.functional.silu(y)


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor, valid: torch.Tensor,
                state: torch.Tensor, scale: float, chunk: int = CHUNK
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chunked form from the state ``state`` (B, H, K, V) fp32
    before the first token. ``q`` / ``k`` (B, L, H, K), ``v`` (B, L, H,
    V), ``g`` (B, L, H, K) fp32, ``beta`` (B, L, H) fp32, ``valid`` (B, L)
    (0: an identity step); -> (o (B, L, H, V) in ``q``'s dtype, the state
    after the last token, fp32).

    A chunk of C tokens from the state S0, with G the within-chunk cumsum
    of g and Gamma = exp(G): A[r, j] = beta_r sum_c k_r k_j exp(G_r - G_j)
    (j < r), P[r, j] = sum_c q_r k_j exp(G_r - G_j) (j <= r); (I + A) U =
    beta (V - (Gamma k) S0); O = scale ((Gamma q) S0 + P U); S = Gamma_C S0
    + (exp(G_C - G) k)^T U."""
    B, L, H, K = q.shape
    ok = valid.bool()[:, :, None]
    qn = l2norm(q) * ok[..., None]
    kn = l2norm(k) * ok[..., None]
    vf = v.float() * ok[..., None]
    gf = torch.where(ok[..., None], g.float(), 0.0)
    bf = torch.where(ok, beta.float(), 0.0)
    n = -(-L // chunk)
    pad = n * chunk - L

    def blocks(t):  # (B, L, H, ...) -> (n, B, H, C, ...), pads identity
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.view(B, n, chunk, H, *t.shape[3:])
        return t.movedim(3, 2).movedim(1, 0)

    qs, ks, vs, gs = blocks(qn), blocks(kn), blocks(vf), blocks(gf)
    bs = blocks(bf[..., None])[..., 0]
    incl = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=q.device).tril()
    strict = incl.tril(-1)
    eye = torch.eye(chunk, device=q.device)
    S = state.float()
    outs = []
    for c in range(n):
        qc, kc, vc, bc = qs[c], ks[c], vs[c], bs[c]
        G = gs[c].cumsum(dim=-2)  # (B, H, C, K)
        diff = G[..., :, None, :] - G[..., None, :, :]
        decay = diff.masked_fill(~incl[..., None], float("-inf")).exp()
        A = torch.einsum("bhrc,bhjc,bhrjc->bhrj", kc, kc, decay)
        A = A * bc[..., None] * strict
        P = torch.einsum("bhrc,bhjc,bhrjc->bhrj", qc, kc, decay)
        rhs = bc[..., None] * (vc - (kc * G.exp()) @ S)
        U = torch.linalg.solve_triangular(eye + A, rhs, upper=False,
                                          unitriangular=True)
        outs.append(scale * ((qc * G.exp()) @ S + P @ U))
        last = G[..., -1:, :]
        S = (last.exp().transpose(-1, -2) * S
             + ((last - G).exp() * kc).transpose(-1, -2) @ U)
    o = torch.stack(outs).movedim(0, 1).movedim(3, 2)  # (B, n, C, H, V)
    return o.reshape(B, n * chunk, H, -1)[:, :L].to(q.dtype), S


def kda_prefill_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          g: torch.Tensor, beta: torch.Tensor,
                          valid: torch.Tensor, state: torch.Tensor,
                          scale: float, taps: torch.Tensor) -> torch.Tensor:
    """The plain prefill: ``q`` / ``k`` / ``v`` the inputs of their short
    convolutions (:func:`short_conv` of each with a third of ``taps`` (3 x
    H x K, W), from zeros before token 0), then :func:`kda_chunked` from a
    zero state, the state after the last token written into ``state``
    (only written); -> o (B, L, H, V) in ``q``'s dtype."""
    q, k, v = (short_conv(t.flatten(2), w, valid.bool()).view(t.shape)
               for t, w in zip((q, k, v), taps.chunk(3)))
    o, S = kda_chunked(q, k, v, g, beta, valid, torch.zeros_like(state),
                       scale)
    state.copy_(S)
    return o


def _check(name: str, q, k, v, g, beta, state, *rest):
    _build.require_cuda(name, q, k, v, g, beta, state, *rest)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q / k / v {q.dtype} / {k.dtype} / "
                        f"{v.dtype}")
    if g.dtype != torch.float32 or beta.dtype != torch.float32 or (
            state.dtype != torch.float32):
        raise TypeError(f"{name}: g, beta and the state are fp32")
    if q.shape[-1] != _WIDTH or v.shape[-1] != _WIDTH:
        raise ValueError(f"{name}: the kernel takes K = V = {_WIDTH}, got "
                         f"{q.shape[-1]} and {v.shape[-1]}")
    if not state.is_contiguous():
        raise ValueError(f"{name}: the state must be contiguous")


def kda_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor,
               scale: float, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """One KDA step a row, the state updated in place; the arguments of
    :func:`kda_decode_reference`."""
    if q.device.type == "cpu":
        return kda_decode_reference(q, k, v, g, beta, state, scale, out)
    _check("kda_decode", q, k, v, g, beta, state)
    B, H, K = q.shape
    if tuple(k.shape) != (B, H, K) or tuple(v.shape) != (B, H, K) or tuple(
            g.shape) != (B, H, K) or tuple(beta.shape) != (B, H) or tuple(
                state.shape) != (B, H, K, K):
        raise ValueError(f"kda_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, g "
                         f"{tuple(g.shape)}, beta {tuple(beta.shape)}, state "
                         f"{tuple(state.shape)}")
    if out is None:
        out = torch.empty_like(v)
    elif out.dtype != q.dtype or not out.is_contiguous() or (
            out.shape != v.shape):
        raise ValueError("kda_decode: out must be a contiguous (B, H, V) "
                         "tensor of q's dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    g, beta = g.contiguous(), beta.contiguous()
    lib = _build.library()
    _build.check(lib.mpr_kda_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        beta.data_ptr(), state.data_ptr(), out.data_ptr(), B, H, K, K,
        float(scale), 0 if q.dtype == torch.float32 else 1,
        _build.stream_handle(q)), "mpr_kda_decode")
    _build.count_launch("kda_decode")
    return out


def kda_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor, valid: torch.Tensor,
                state: torch.Tensor, scale: float,
                taps: torch.Tensor) -> torch.Tensor:
    """The tokens of a prefill from a zero state, the final state written
    into ``state``; the arguments of :func:`kda_prefill_reference`. On the
    card ``q`` / ``k`` / ``v`` may be views with any (batch, token) strides
    whose heads lie 128 apart, and ``taps`` has at most 4 a channel, in
    q's dtype."""
    if q.device.type == "cpu":
        return kda_prefill_reference(q, k, v, g, beta, valid, state, scale,
                                     taps)
    _check("kda_prefill", q, k, v, g, beta, state, valid, taps)
    B, L, H, K = q.shape
    if tuple(k.shape) != (B, L, H, K) or tuple(v.shape) != (B, L, H, K) or (
            tuple(g.shape) != (B, L, H, K)) or tuple(beta.shape) != (
                B, L, H) or tuple(valid.shape) != (B, L) or tuple(
                    state.shape) != (B, H, K, K):
        raise ValueError(f"kda_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, g "
                         f"{tuple(g.shape)}, beta {tuple(beta.shape)}, valid "
                         f"{tuple(valid.shape)}, state {tuple(state.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != K:
            raise ValueError(f"kda_prefill: {name}'s heads must lie {K} "
                             "apart, each contiguous")
    if taps.dtype != q.dtype or tuple(taps.shape[:1]) != (3 * H * K,) or (
            not 1 <= taps.shape[1] <= 4):
        raise ValueError(f"kda_prefill: taps {tuple(taps.shape)} "
                         f"{taps.dtype}, want ({3 * H * K}, <= 4) {q.dtype}")
    g, beta, taps = g.contiguous(), beta.contiguous(), taps.contiguous()
    valid = valid.to(torch.int8).contiguous()
    out = torch.empty((B, L, H, K), dtype=q.dtype, device=q.device)
    lib = _build.library()
    _build.check(lib.mpr_kda_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        beta.data_ptr(), valid.data_ptr(), state.data_ptr(), out.data_ptr(),
        taps.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), B, L, H, K, K, taps.shape[1], float(scale),
        0 if q.dtype == torch.float32 else 1, _build.stream_handle(q)),
        "mpr_kda_prefill")
    _build.count_launch("kda_prefill")
    return out
