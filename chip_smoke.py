#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]
        [--phases kernels,serve,features,check,train,cli,variants,pretrained,
                  eval,parallel,model_parallel,seq_parallel,sharded_serve,
                  t5_large,lm]

1. Builds the port's kernels from the sources in this checkout (nvcc for the
   CUDA C++ kernels, Triton for the norms) and prints the build time.
2. Compares each of the nine kernels, and the LM generator's two (K10
   ``moe_experts``, K11 ``mla_decode_attention``), with its plain PyTorch
   version on the card, in fp32 and bf16, at the paths' shapes; prints the error against
   the stated tolerance and the device time per call of both, and for one
   headline case per kernel the least time the card could take (bytes moved
   over the memory rate, or operations over the peak rate) and the time of
   the one PyTorch call that computes the same function (a yardstick; no
   path uses it; for the L2 top-k, which has none, the two calls a user
   would write: ``two_calls_ms``). Compares the backward of the
   differentiable kernels (K1, K5, K8, K2, K3) with autograd through their
   plain versions. Holds K1, K7 and K8 to their plain versions at the
   model_parallel phase's own shapes too: a tensor-parallel rank's 4 heads
   (K1, K7 at W=256, K8) and the pipeline's 64- and 32-row microbatches
   (K8 in the decoder's causal self-attention and its cross-attention over
   the 82 encoder positions), forward and backward. Holds K1-K4 and K7
   to their plain versions at the shapes a sharded_serve rank gives them:
   256 rows of a 512-row chunk (fp32 and bf16) and 4 rows of the 8-row
   small input (fp32), through the ViT, the CLIP text tower and the T5
   encoder (K1, K2, K3), K4 against the 1,230-row index and K7. Holds K1,
   K3, K4, K6 and K7 to their plain versions at the t5_large phase's shapes
   (16 heads, width 1024, B = 128, 114 encoder positions), fp32 and bf16,
   each with its device time, bound and library call, and K6 / K7 beside
   their recorded times before the redesign. Holds K10 and K11 to their
   plain versions at the ``kimi-vl-a3b.serve-pass`` cell's shapes, fp32
   and bf16: K10 at a decode step (512 tokens x 6 of 64 experts, 3,072
   rows, tiles of 64) and at a prefill chunk (512 rows x 114 tokens =
   58,368 tokens x 6, tiles of 128), d 2,048, width 1,408; K11 at B 512,
   16 heads, 512 + 64, over 114 and 134 cached tokens; each with its
   device time, bound and library call (``torch._grouped_mm`` over the
   sorted rows for K10, where the card's torch has it; ``scaled_dot_
   product_attention`` with 16 query heads over one shared key head for
   K11).
3. Drives two serving paths at full width (t5-small + CLIP ViT-B/32, bf16,
   chunk B=512, retrieval k=1, seeded random weights): a 1,230-entry
   retrieval corpus embedded by the port's CLIP, 512 staged images, 1,536
   questions sent as two submits, the second queued behind the first. The
   main path is the north-star config (row attention in the towers and the
   encoder, the default ``decode_attention_impl="indicator"``): K1-K4 and
   K7. The second, "pallas" path sets ``attention_impl="pallas"`` in both
   towers and the encoder and ``decode_attention_impl="pallas"``: K8, K6
   and K4 (``serving.SERVE_PATHS``). The kernels' launch counts are reset
   just before each path and read just after.
4. Checks each path's result: every request answered through the fused
   path, each of its kernels launched, finite staged tables, and the kernel
   path agreeing with the plain versions (CPU, fp32) on a small input.
5. Drives the server's options on the main path's load (``features``):
   ``quantize="int8"`` and ``"int8_all"``, ``spec_decode=4`` and
   ``length_sort=True``, each printing the share of answers identical to
   the bf16 main path (length sort must give them all); a perfect-draft
   speculative decode of one chunk (S + 1 = 5 tokens a pass: 4 passes for
   20 tokens); ``submit`` returning while its last chunk still runs, with
   the serial answers; QA/s serial and with ``pipeline_depth=2``; the int8
   GEMM against the bf16 one and the verification pass's block attention,
   each with its bound; and the card against the CPU at fp32 on a small
   input under spec decode and length sort (identical greedy ids) and int8
   (7 of 8 rows identical: the row quantization can turn a kernel's 1e-6
   difference into an int8 step).
   Runs the kernel check of the two attention kernels that no model calls
   (K5, K9: ``multimodalpromptretrieval_tpu_torch.kernel_check``).
6. Drives the train path at full width (the JAX ``bench.py`` train stage:
   t5-small + CLIP ViT-B/32, row attention, fp32 masters with bf16 compute,
   B=128, 32 prompt tokens behind the 50-token prefix, dropout 0.1):
   retrieval hints through the CLIP towers and K4, the vision-token table
   through the ViT (K1, K2) once, then 2 warm-up and 20 timed steps of
   loss -> backward -> AdamW on one fixed batch. Checks finite, falling
   loss, K1 6 and K3 13 launches per step, frozen CLIP bit-identical, and a
   small fp32 step on the card (kernels) against the CPU (plain versions).
7. Drives the disk-data entry points at full width (t5-small + CLIP
   ViT-B/32 at 224 px, bf16, row attention, the indicator decode, k=1,
   B=128): a synthetic SLAKE written with numpy alone to a temporary
   directory, its image caches preprocessed on the card; ``run_from_config``
   trains one epoch and tests; ``cli.serve_stream`` then answers the 384
   test questions through a NEW experiment, whose server loads the trained
   checkpoint. Checks the checkpoint and ``performance.txt``, the streamed
   answers against ``MPRServer.answer`` and against a server holding the
   trained weights, and K1-K4 and K7 launched on the path.
8. Drives the text-only (``use_image_info: 0``), prediction-head and BAN
   variants on the main path's load through ``MPRServer``'s per-batch path
   (each request's images, B=512, 1,536 questions, k=1; head and BAN with
   the synthetic ROCO index appended by ``use_additional_retrieval_data``):
   QA/s, chunks and the launches of K1-K4 and K7, each launched where the
   variant's path runs it and K7 (head, BAN) or K4 (BAN) not at all; K4
   over the extended index against its plain version; 8 rows of each
   variant at fp32 on the card against the CPU (identical class or greedy
   ids); 2 + 5 train steps of head and BAN (finite, falling loss, CLIP
   untouched).
9. Drives the pretrained weights (``pretrained``): (a) the main path's
   seeded parameters exported by the port's ``t5_to_hf``,
   ``clip_to_openai`` and ``mprgen_to_reference_state_dict``, saved as
   torch files and loaded by new experiments on the main load through
   ``t5_checkpoint`` / ``clip_checkpoint`` and ``reference_checkpoint``:
   the parameters bit-identical, the served answers and the small input's
   greedy ids identical; (c) the mapping MLP trained on the card over the
   corpus' CLIP features (falling loss, top-5 retrieval accuracy), written
   and served through ``mapping_checkpoint`` (card vs CPU at fp32); (b)
   RN50x4 + t5-small at full width: a seeded OpenAI-layout RN50x4 loaded
   through ``vision_checkpoint`` with PubMedCLIP's prefix, 1,536 questions
   at B=512 on the per-batch path (QA/s, chunks, the launches of K1-K4 and
   K7), 8 rows card vs CPU at fp32 (identical greedy ids; the RN grid and
   its ``rn_proj`` prefix within 1e-4), then 2 + 5
   train steps with the RN grid table (finite, falling loss, the ResNet
   and CLIP untouched).
10. Drives ``--eval`` (``eval``) at full width on the cli phase's data
   (seeded weights, so each greedy decode runs its 20 steps): the test
   split's hints, then ``train/visualize.attention_maps`` of 32 test
   questions on the fp32 masters (ms per example, synced; K1, K2, K3, K7
   and K4 launched); the shapes of the encoder, decoder and cross maps,
   every probability row summing to 1 within 1e-3, the answer the decode
   of the ids, and 2 questions card vs CPU at fp32 (identical ids, maps and
   logits within 1e-5 of their largest value); the figures where
   matplotlib and PIL are installed and the dataset has image files.
11. Drives data parallelism (``parallel``) on the train path's load: (a) a
   one-process NCCL group runs the data-parallel train step bit for bit
   as the plain step over 3 steps (bf16, dropout 0.1); (b) the work of
   ``tests/torch_multihost_worker.py`` on its "train" load in this process
   and then in two gloo ranks on the one card, 64 rows each of the global
   B=128: 3 fp32 steps at dropout 0 (losses within 1e-5 of the largest;
   the summed step-1 gradients within 1e-5 of each leaf's largest value
   of this process's gradients of the same two row blocks; at most one
   trainable parameter element in 100,000 past 1e-5 of the largest value,
   the frozen ones equal), 2 + 10 timed bf16 steps at dropout 0.1 (ms a
   step and examples/s beside one process's), ``test()`` of the cli
   checkpoint at fp32 (``performance.txt`` written by rank 0 alone, equal
   to one process's) and ``sharded_l2_topk`` (K4 on each rank's block, 12
   launches a rank) identical to one K4 over the whole index at N = 1,230
   and 5,000, k = 1, 15, 64, ``skip_first`` off and on. The phase's
   launches are (a)'s and the ranks'.
12. Drives tensor and pipeline parallelism (``model_parallel``) on the
   train path's load, each configuration as gloo ranks on the one card
   (``tests/torch_multihost_worker.py --load train --par NAME``) against
   one process on the card: (a) ``{"model": 2}`` under "row" (K1 at 4
   heads and K3 on each rank), (b) ``{"pipe": 2}`` under "pallas" (K8 in
   each stage; 2 and 4 microbatches), (c) ``{"pipe": 2, "model": 2}`` on
   four ranks under "pallas" (K8 at 4 heads). Each: 3 fp32 steps at
   dropout 0 (the losses within 1e-5 of the largest; each rank's step-1
   gradients against one process's cut to its pieces and the parameters
   after, gathered, with at most one element in 10,000 past 1e-5 of the
   largest value, the frozen ones equal; under "pipe" the gradients are
   held against one process's of the same microbatch row blocks, and the
   whole batch's difference is printed beside the ReLU gates that the
   whole-batch and row-block forwards set apart), the kernel launches a
   step a rank, 2 + 10 timed bf16 steps at dropout 0.1 (ms a step, examples/s,
   beside one process's) and the step's collectives alone (the Megatron
   all_reduce, a pipeline hop, the stage-held gradients' all_reduce); under
   (a) and (b) ``test()`` of the cli checkpoint at fp32 (the answers one
   process's; K7 at 4 heads under (a)) and at bf16 (the answers that
   differ, counted). Under (a) also the tensor-parallel greedy decode of
   the first train batch on the seeded weights at fp32, 20 steps with
   ``early_stop`` off: the ids one process's, some rows past the first
   step (the cli checkpoint answers EOS there), K7 launched.
13. Drives sequence parallelism (``seq_parallel``) on the train path's load
   as two gloo ranks on the one card under ``{"seq": 2}`` (41 of the 82
   positions a rank; ``tests/torch_multihost_worker.py --load train --par
   sp``) against one process on the card: ``sp_t5_encode`` of t5-small at
   B = 2, L = 4,096, fp32, within 2e-5 (plus 2e-5 of the value) of one
   process's ``t5_encode`` under "xla" (K1 stops at L = 1,536); 3 fp32
   steps at dropout 0 (the losses within 1e-5 of the largest; the step-1
   gradients with at most one element in 10,000 past 1e-5 of each leaf's
   largest value of one process's gradients with the SP forward's ReLU
   gates imposed, the gates the two fp32 forwards set apart counted and
   the difference from one process's own gradients printed; the
   parameters after with at most one element in 10,000 past 1e-5 of the
   largest value, the frozen ones equal; the SP step
   launches no kernel: its encoder is the plain ring and RMSNorm, as in
   the JAX package); 2 + 10 timed bf16 steps at dropout 0.1 (ms a step and
   examples/s beside one process's); a ring hop and the gradient
   ``all_reduce``, each alone; ``test()`` of the cli checkpoint at fp32
   (the answers one process's, K7 launched on each rank).
14. Drives the data-sharded server (``sharded_serve``): the main path's
   load (bf16, B = 512, 512 staged images, 1,536 questions in two
   submits, row attention, the indicator decode, k = 1) in one process
   and as two gloo ranks on the one card under ``{"data": 2}`` (256 rows
   of each chunk a rank; ``--par serve``): the rows each rank's steps
   ran (256 a chunk and a staged table block, 4 of the small input); QA/s
   of each; K1-K4 and K7
   launched on each rank (counts a rank, from 0 around the timed window);
   every rank's answers all of them and equal, the bf16 answers that
   differ from one process's counted; the staging gather and a chunk's
   token gather, each alone; 8 requests at fp32 (one question on 8
   images, B = 8: 4 rows a rank) with greedy ids identical to one
   process's at B = 4, which runs the same row blocks.
15. Drives t5-large + CLIP ViT-B/32 (``t5_large``) at full width, the JAX
   ``bench.py`` ``t5_large`` stage on the synthetic open corpus (answers of
   2-8 tokens; 1,230 corpus entries, 1,536 questions): one epoch of
   ``TrainingExperiment.train()`` from ``north_star_t5_large_train_setup``
   (B = 64, the "xla" T5 with remat, bf16 AdamW moments, dropout 0.1: ms a
   step with the first two apart, examples/s, ``max_memory_allocated``,
   finite losses, no kernel launched by the steps) and its parameters-only
   checkpoint (its size, no optimizer array); then
   ``north_star_t5_large_setup`` (row attention, bf16, B = 128), whose
   first server loads that checkpoint, serving fp, ``quantize="int8"`` and
   ``spec_decode=4`` over a warm-up and 3 timed windows each (QA/s median,
   min and max; chunks, decode steps and the launches of K1-K4 and K7 a
   window: K7 48 a decode step, none under spec decode, whose pass is the
   plain block attention; the answers that differ from fp's), and the same
   three over one window each on the seeded weights, whose decodes run
   their 20 steps; the card against the CPU at fp32 on 4 requests at full
   depth (greedy ids identical under fp, int8 and spec decode); 3 fp32
   train steps at full width with 2 + 2 layers under the trainer's
   overrides, card vs CPU with the card's ReLU gates imposed (losses and
   step-1 gradients within 1e-4, parameters within 1e-4 of the largest
   but for one element in 100,000: AdamW's first updates turn a
   gradient's rounding noise near 0 into a move of up to lr).
16. Drives the LM generator (``lm``): Kimi-VL-A3B's language model at its
   published widths (hidden 2,048, MLA 512 + 64, 64 experts of 1,408, 6 a
   token, vocabulary 163,840) cut to 4 layers (the dense one, then 3 MoE
   layers), held in bf16, behind CLIP ViT-B/32, chunk B = 512, k = 1, the
   synthetic open corpus (1,536 questions, prompts at the 64-token limit):
   a warm-up window, then one window with the launch counts reset just
   before it and read just after: K10 once a MoE layer of each prefill and
   step, K11 once a layer of each step, K1-K4 in the towers, retrieval and
   norms; every question answered through the fused path. Then the LM
   alone at 2 layers (dense, MoE), fp32, 4 rows, 6 tokens: the card's
   greedy ids identical to the CPU's (plain versions) and each step's
   logits within 1e-4 of the largest.

Prints the card's name and power limit, one JSON line of per-kernel results
and, last, ``{"ok": true, "device": {...}}``. Exits non-zero, with no result
line, when there is no CUDA device, a kernel does not build or disagrees, or
any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNELS = {
    "row_attention_packed": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/row_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/row_attention.py:171"),
    "fused_layer_norm": dict(
        route="triton",
        source="multimodalpromptretrieval_tpu_torch/ops/_norm_triton.py",
        replaces="multimodalpromptretrieval_tpu/ops/norm.py:35"),
    "fused_rms_norm": dict(
        route="triton",
        source="multimodalpromptretrieval_tpu_torch/ops/_norm_triton.py",
        replaces="multimodalpromptretrieval_tpu/ops/norm.py:47"),
    "l2_topk": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/l2_topk.cu",
        replaces="multimodalpromptretrieval_tpu/ops/topk.py:53"),
    "decode_attention": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/decode_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/decode_attention.py:190"),
    "decode_attention_fused": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/decode_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/decode_attention.py:312"),
    "flash_attention": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/flash_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/attention.py:62"),
    "row_attention": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/row_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/row_attention.py:34"),
    "short_attention": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/short_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/short_attention.py:27"),
    # the LM generator's kernels: the JAX package has no such layer
    "moe_experts": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/moe_experts.cu",
        replaces="none"),
    "mla_decode_attention": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/mla_decode.cu",
        replaces="none"),
}
# each path's kernels (the serving paths' configs: serving.SERVE_PATHS); a
# kernel's "launches" come from the first path that runs it
PATH_KERNELS = {
    "main": ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
             "l2_topk", "decode_attention_fused"),
    "pallas": ("flash_attention", "decode_attention", "l2_topk"),
    "kernel_check": ("row_attention", "short_attention"),
    "train": ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
              "l2_topk"),
    "cli": ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
            "l2_topk", "decode_attention_fused"),
    "features": ("row_attention_packed", "fused_layer_norm",
                 "fused_rms_norm", "l2_topk", "decode_attention_fused"),
    "variants": ("row_attention_packed", "fused_layer_norm",
                 "fused_rms_norm", "l2_topk", "decode_attention_fused"),
    # the RN50x4 path (per batch): the fp32 ViT and text tower and K4 for
    # the hints, the T5 encoder, K7 decode
    "pretrained": ("row_attention_packed", "fused_layer_norm",
                   "fused_rms_norm", "l2_topk", "decode_attention_fused"),
    # --eval: the ViT, the T5 encoder and the decode of each example, K4 in
    # the test split's hints
    "eval": ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
             "l2_topk", "decode_attention_fused"),
    # data parallelism: each rank's train steps (K1, K3), K4 on each
    # rank's index block
    "parallel": ("row_attention_packed", "fused_rms_norm", "l2_topk"),
    # tensor and pipeline parallelism: TP steps (K1, K3), the stages (K8),
    # the TP test() decode (K7)
    "model_parallel": ("row_attention_packed", "fused_rms_norm",
                       "flash_attention", "decode_attention_fused"),
    # sequence parallelism: the set-up (hints K4, the ViT's token table K1,
    # K2) and test() (K1-K4, K7); the SP step itself launches none
    "seq_parallel": ("row_attention_packed", "fused_layer_norm",
                     "fused_rms_norm", "l2_topk", "decode_attention_fused"),
    # the data-sharded server: the main path's kernels on each rank's rows
    "sharded_serve": ("row_attention_packed", "fused_layer_norm",
                      "fused_rms_norm", "l2_topk", "decode_attention_fused"),
    # t5-large: the trainer's set-up (hints K4, the ViT's token table K1,
    # K2; its "xla" T5 steps none) and the servers' windows (K1-K4; K7 in
    # the lockstep decodes)
    "t5_large": ("row_attention_packed", "fused_layer_norm",
                 "fused_rms_norm", "l2_topk", "decode_attention_fused"),
    # the LM generator: the towers and retrieval (K1-K4), the LM's norms
    # (K3), its experts (K10) and latent decode attention (K11)
    "lm": ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
           "l2_topk", "moe_experts", "mla_decode_attention"),
}
PHASES = ("kernels", "serve", "features", "check", "train", "cli",
          "variants", "pretrained", "eval", "parallel", "model_parallel",
          "seq_parallel", "sharded_serve", "t5_large", "lm")
# the server options of the features phase
FEATURES = (("int8", dict(quantize="int8")),
            ("int8_all", dict(quantize="int8_all")),
            ("spec_decode=4", dict(spec_decode=4)),
            ("length_sort", dict(length_sort=True)))
SERVE_PATH_NAMES = ("main", "pallas")

# NVIDIA's published peaks of the H100 SXM at its 700 W limit: memory rate,
# dense bf16 and int8 on the tensor cores, fp32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12,
              torch.float32: 67e12}


def bound(nbytes: float, flops: float, peak: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    """Bytes of the given inputs and outputs, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time per call: CUDA events around ``iters`` calls that
    the host queues behind a sleep kernel, so that the device runs them back
    to back and the host's dispatch (tens of us per wrapper call, longer
    than a decode-step kernel runs) does not gap them. The sleep lasts about
    twice the host time of an unhidden run of the same calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles a second is about the H100's boost clock; a lower clock
    # only lengthens the sleep
    torch.cuda._sleep(int(2 * host_s * 2e9) + 2_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(ref: torch.Tensor) -> float:
    """One bf16 ulp at the output's scale (its largest magnitude)."""
    return 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


class Checks:
    def __init__(self):
        self.failures = []
        self.results = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def expect(self, ok: bool, what: str) -> None:
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def compare(self, kernel, case, got, want, tol, fn=None, plain=None,
                headline=None, store=True):
        """``headline``: for the kernel's one reported case, a dict with
        ``bytes`` and ``flops`` of the call, the ``peak`` rate of its
        operations, ``library`` (a function that makes the one PyTorch call
        computing the same thing, or None when there is none) and, where
        there is none, optionally ``two_calls`` (the PyTorch calls a user
        would write instead: timed and printed, compared with nothing).
        ``store=False``: the same numbers printed for another case, the
        kernel's reported ones left as they are. ``headline["earlier"]``,
        where given: the case's time before its kernel's redesign, as
        recorded (printed beside the new one, compared with nothing)."""
        err = (got.float() - want.float()).abs().max().item()
        res = self.results[kernel]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        line = f"{kernel} {case}: max_abs_err={err:.3g} (tol {tol:.3g})"
        if fn is not None:
            ms, plain_ms = time_ms(fn), time_ms(plain)
            line += f", kernel {ms:.4f} ms"
            if headline and headline.get("earlier"):
                line += f", earlier {headline['earlier']}"
            line += f", plain {plain_ms:.4f} ms"
            if headline:
                got_ms = dict(ms=ms, plain_ms=plain_ms, library_ms=None)
                got_ms["bound_ms"], got_ms["bound_by"] = bound(
                    headline["bytes"], headline["flops"], headline["peak"])
                line += (f", bound {got_ms['bound_ms']:.4f} ms by "
                         f"{got_ms['bound_by']}")
                library = headline.get("library")
                if library is not None:
                    got_ms["library_ms"] = time_ms(library)
                    # a yardstick with its own rounding: compared loosely
                    lib_err = (library().float().reshape(want.shape)
                               - want.float()).abs().max().item()
                    line += (f", library call {got_ms['library_ms']:.4f} ms "
                             f"(differs from plain by {lib_err:.3g})")
                    loose = 16 * bf16_ulp(want)
                    if lib_err > loose:
                        self.failures.append(
                            f"{kernel} {case}: library call differs by "
                            f"{lib_err:.3g} > {loose:.3g}")
                two_calls = headline.get("two_calls")
                if two_calls is not None:
                    # what a user would write where no one call does it;
                    # timed only, its tie order is not held to anything
                    line += f", two_calls_ms {time_ms(two_calls):.4f}"
                if store:
                    res.update(got_ms)
        self.expect(bool(err <= tol) and bool(torch.isfinite(got).all()),
                    line)

    def compare_grads(self, kernel, case, got, want, rel_tol=None, ulps=None):
        """Gradients of a Function on the card against autograd through the
        plain version: relative to the largest magnitude (fp32) or in bf16
        ulps of it."""
        for name, g, w in zip(("d" + n for n in case[1]), got, want):
            err = (g.float() - w.float()).abs().max().item()
            tol = (rel_tol * w.float().abs().max().item() if ulps is None
                   else ulps * bf16_ulp(w.float()))
            self.expect(bool(err <= tol) and bool(torch.isfinite(g).all()),
                        f"{kernel} backward {case[0]} {name}"
                        f"{tuple(g.shape)}: max_abs_err={err:.3g} "
                        f"(tol {tol:.3g})")


def input_makers(dev):
    """Seeded makers of the kernel phase's inputs on ``dev``: ``randn(*shape,
    dtype=)`` and ``key_mask(B, L)`` ((B, L) int32, each row's first L // 2
    to L keys valid)."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def key_mask(B, L):
        lens = torch.randint(L // 2, L + 1, (B,), generator=gen, device=dev)
        return (torch.arange(L, device=dev)[None, :]
                < lens[:, None]).to(torch.int32)

    return randn, key_mask


def check_kernels(checks: Checks, dev) -> None:
    randn, key_mask = input_makers(dev)
    check_row_attention(checks, randn, key_mask)
    check_norms(checks, randn)
    check_topk(checks, randn)
    check_decode_attention(checks, randn, key_mask)
    check_flash_attention(checks, randn, key_mask)
    check_row_attention_qkv(checks, randn, key_mask)
    check_short_attention(checks, randn)
    check_backward(checks, randn, key_mask)
    check_model_parallel_shapes(checks, randn, key_mask)
    check_sharded_serve_shapes(checks, randn, key_mask)
    check_t5_large_shapes(checks, randn, key_mask)
    check_lm_kernels(checks, randn)


def sdpa(q, k, v, mask=None, causal=False, scale=None):
    """The library yardstick of the attention kernels over (B, H, L, Dh)
    views; ``mask`` a boolean (B, 1, 1, Lk) key mask."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, scale=scale)


def attention_work(B, H, Lq, Lk, Dh, dt, *tensors):
    """Bytes of ``tensors`` and the operations of two matrix products per
    head (2 * Lq * Lk * Dh multiply-adds each), at ``dt``'s peak."""
    return dict(bytes=nbytes(*tensors), flops=4.0 * B * H * Lq * Lk * Dh,
                peak=PEAK_FLOPS[dt])


def check_row_attention(checks: Checks, randn, key_mask) -> None:
    from multimodalpromptretrieval_tpu_torch.ops import row_attention

    print("K1 row attention (CUDA) vs row_attention_packed_reference:")
    cases = [  # name, B, L, W, H, scale, causal, bias+mask
        ("vit", 512, 50, 768, 12, 64 ** -0.5, False, False),
        ("text", 512, 16, 512, 8, 64 ** -0.5, True, False),
        ("t5_enc_L82", 512, 82, 512, 8, 1.0, False, True),
        ("t5_enc_L562", 128, 562, 512, 8, 1.0, False, True),
    ]
    for name, B, L, W, H, scale, causal, with_bias in cases:
        for dt in (torch.float32, torch.bfloat16):
            qkv = randn(B, L, 3 * W, dtype=dt)
            bias = mask = None
            if with_bias:
                bias = randn(H, L, L, dtype=dt)
                mask = key_mask(B, L)
            kw = dict(heads=H, scale=scale, causal=causal)
            kernel = row_attention.row_attention_packed
            reference = row_attention.row_attention_packed_reference
            fn = lambda: kernel(qkv, bias, mask, **kw)  # noqa: E731
            plain = lambda: reference(qkv, bias, mask, **kw)  # noqa: E731
            want = plain()
            tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
            headline = None
            if name == "vit" and dt == torch.bfloat16:
                hq, hk, hv = (x.transpose(1, 2) for x in
                              qkv.view(B, L, 3, H, 64).unbind(2))
                headline = attention_work(B, H, L, L, 64, dt, qkv, want)
                headline["library"] = lambda: sdpa(  # noqa: E731
                    hq, hk, hv, scale=scale).transpose(1, 2)
            checks.compare("row_attention_packed",
                           f"{name} {str(dt)[6:]} qkv{tuple(qkv.shape)}",
                           fn(), want, tol, fn, plain, headline)


def check_norms(checks: Checks, randn) -> None:
    from multimodalpromptretrieval_tpu_torch.ops import norm

    print("K2 / K3 norms (Triton) vs their plain versions:")
    for rows, W in ((512 * 50, 768), (512 * 82, 512)):
        for dt in (torch.float32, torch.bfloat16):
            x = (randn(rows, W) * 2 + 0.5).to(dt)
            w, b = randn(W, dtype=dt), randn(W, dtype=dt)
            for kernel, fn, plain in (
                    ("fused_layer_norm",
                     lambda: norm.fused_layer_norm(x, w, b),
                     lambda: norm.fused_layer_norm_reference(x, w, b)),
                    ("fused_rms_norm",
                     lambda: norm.fused_rms_norm(x, w),
                     lambda: norm.fused_rms_norm_reference(x, w))):
                want = plain()
                tol = 1e-5 if dt == torch.float32 else bf16_ulp(want)
                headline = None
                is_ln = kernel == "fused_layer_norm"
                if dt == torch.bfloat16 and W == (768 if is_ln else 512):
                    F = torch.nn.functional
                    # the reductions and the scaling run in fp32 outside
                    # the tensor cores: about 8 (LayerNorm) or 5 (RMSNorm)
                    # operations per element
                    headline = dict(
                        bytes=nbytes(x, want, w, b if is_ln else None),
                        flops=(8.0 if is_ln else 5.0) * rows * W,
                        peak=PEAK_FLOPS[torch.float32],
                        library=(lambda: F.layer_norm(x, (W,), w, b, 1e-5))
                        if is_ln else
                        (lambda: F.rms_norm(x, (W,), w, 1e-6)))
                checks.compare(kernel, f"{str(dt)[6:]} x({rows}, {W})",
                               fn(), want, tol, fn, plain, headline)


def check_topk(checks: Checks, randn) -> None:
    from multimodalpromptretrieval_tpu_torch.ops import topk

    print("K4 L2 top-k (CUDA) vs l2_topk_reference:")
    # the serving and training fetches (k = 1, 15, each with the
    # training-phase skip) on normal embeddings; then k past 32 at the
    # serving corpus size on small-integer embeddings, whose distances are
    # exact (normal ones tie within an fp32 rounding deep in the ranking,
    # where the kernel's sums and cuBLAS's may order two rows either way):
    # query 0 is corpus row 3, which has a copy at row N // 2
    normal = (randn(512, 1024), {N: randn(N, 1024) for N in (1230, 5000)})
    gen = torch.Generator(device=normal[0].device).manual_seed(2)
    ints = lambda *shape: torch.randint(  # noqa: E731
        -2, 3, shape, generator=gen, device=gen.device).float()
    tie_index = ints(1230, 1024)
    tie_index[1230 // 2] = tie_index[3]
    tie_query = ints(512, 1024)
    tie_query[0] = tie_index[3]
    cases = [("normal", N, k, skip) for N in (1230, 5000) for k in (1, 15)
             for skip in (False, True)]
    cases += [("integer", 1230, k, skip) for k, skip in (
        (32, True), (33, False), (64, False), (128, False))]
    for kind, N, k, skip in cases:
        query, index = ((normal[0], normal[1][N]) if kind == "normal"
                        else (tie_query, tie_index))
        sq = torch.sum(index * index, dim=-1)
        index_t = index.t()
        fn = lambda: topk.l2_topk(  # noqa: E731
            query, index, k, index_sq=sq, skip_first=skip)
        fetch = k + 1 if skip else k
        plain = lambda: topk.l2_topk_reference(  # noqa: E731
            query, index, fetch, sq)
        d, i = fn()
        rd, ri = plain()
        if skip:
            rd, ri = rd[:, 1:], ri[:, 1:]
        case = f"{kind} N={N} k={k} skip_first={skip}"
        checks.expect(bool(torch.equal(i, ri)),
                      f"l2_topk {case}: indices identical")
        # distances are fp32 dot products (2 * B * N * D operations)
        # outside the tensor cores
        work = dict(bytes=nbytes(query, index, sq, d, i),
                    flops=2.0 * 512 * N * 1024,
                    peak=PEAK_FLOPS[torch.float32])
        headline = None
        if kind == "normal" and N == 1230 and k == 1 and not skip:
            # no one PyTorch call computes distance + top-k (it takes two):
            # the dots, then the k smallest (the norms and the square root
            # a user would add are left out)
            headline = dict(work, two_calls=lambda: torch.topk(  # noqa: E731
                torch.matmul(query, index_t), k, largest=False))
        elif N == 1230 and not skip and k in (15, 64, 128):
            # the same yardstick as the headline's: dots, then the k
            # smallest (timed, compared with nothing)
            print("  l2_topk {}: bound {:.4f} ms by {}, two_calls_ms "
                  "{:.4f}".format(case, *bound(work["bytes"], work["flops"],
                                               work["peak"]),
                                  time_ms(lambda: torch.topk(  # noqa: E731
                                      torch.matmul(query, index_t), k,
                                      largest=False))))
        checks.compare("l2_topk", case + " distances", d, rd, 1e-3, fn,
                       plain, headline)


# recorded times of K6 / K7 before their redesign, the earlier kernel's
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): (kernel, case, dtype)
# -> ms, or "not measured"
DECODE_EARLIER = {
    ("decode_attention", "cross", "bfloat16"): "0.0367 ms",
    ("decode_attention_fused", "cross", "bfloat16"): "0.0373 ms",
    ("decode_attention_fused", "t5_large cross", "bfloat16"): "0.0379 ms",
    ("decode_attention_fused", "t5_large cross", "float32"): "0.0479 ms",
    ("decode_attention_fused", "t5_large self", "bfloat16"): "0.0068 ms",
    ("decode_attention_fused", "t5_large self", "float32"): "0.0072 ms",
}
DECODE_KERNELS = ("decode_attention", "decode_attention_fused")


def decode_case(checks: Checks, da, name, case, q, k, v, bias, mask, H,
                dt, timed):
    """One K6 / K7 case against its plain version; ``timed``: with its
    device ms, the earlier ms, bound and library call (SDPA over the head
    views; the mask or the bias as its additive term)."""
    B, T, W = k.shape
    kernel = getattr(da, name)
    plain_fn = (da.decode_attention_reference if name == "decode_attention"
                else da.decode_attention_indicator_reference)
    fn = lambda: kernel(q, k, v, bias, mask, heads=H)  # noqa: E731
    plain = lambda: plain_fn(q, k, v, bias, mask, heads=H)  # noqa: E731
    want = plain()
    tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
    dname = str(dt)[6:]
    work = None
    if timed:
        hq = q.reshape(B, 1, H, 64).transpose(1, 2)
        hk, hv = (x.view(B, T, H, 64).transpose(1, 2) for x in (k, v))
        add = (bias[None, :, None, :].to(dt) if bias is not None
               else (mask != 0)[:, None, None, :])
        # K7's products are rounded one by one: not a matrix product
        work = attention_work(
            B, H, 1, T, 64,
            torch.float32 if name == "decode_attention_fused" else dt,
            q, k, v, bias, mask, want)
        work["library"] = lambda: sdpa(  # noqa: E731
            hq, hk, hv, add, scale=1.0).transpose(1, 2)
        work["earlier"] = DECODE_EARLIER.get((name, case, dname),
                                             "not measured")
    checks.compare(name, f"{case} {dname} B={B} T={T} W={W} H={H}", fn(),
                   want, tol, fn if timed else None, plain if timed else None,
                   work, store=timed and case == "cross"
                   and dt == torch.bfloat16)


def check_decode_attention(checks: Checks, randn, key_mask) -> None:
    """K6 / K7 at the decode loop's shapes: self-attention reads q as a
    column slice of the (B, 3W) qkv rows with the (H, T) bias row;
    cross-attention reads the (B, 82, W) encoder caches with the key
    mask; the eval phase's batch of one; a row whose keys are all masked
    (uniform probabilities)."""
    from multimodalpromptretrieval_tpu_torch.ops import decode_attention as da

    print("K6 / K7 decode attention (CUDA) vs decode_attention_reference / "
          "decode_attention_indicator_reference:")
    H, W = 8, 512
    for case, B, T in (("self", 512, 20), ("cross", 512, 82),
                       ("eval cross", 1, 82), ("masked row", 16, 82)):
        for dt in (torch.float32, torch.bfloat16):
            k, v = randn(B, T, W, dtype=dt), randn(B, T, W, dtype=dt)
            if case == "self":
                q = randn(B, 3 * W, dtype=dt)[:, :W]
                bias, mask = randn(H, T), None
            else:
                q, bias, mask = randn(B, W, dtype=dt), None, key_mask(B, T)
                if case == "masked row":
                    mask[3] = 0
            for name in DECODE_KERNELS:
                decode_case(checks, da, name, case, q, k, v, bias, mask, H,
                            dt, timed=case in ("self", "cross"))


def check_flash_attention(checks: Checks, randn, key_mask) -> None:
    """K8 over the (B, H, L, 64) head views of packed QKV rows, as the
    towers and the encoder call it under attention_impl="pallas"."""
    from multimodalpromptretrieval_tpu_torch.ops import attention

    print("K8 flash attention (CUDA) vs flash_attention_reference:")
    cases = [  # name, B, H, L, scale, causal, bias + mask
        ("vit", 512, 12, 50, 64 ** -0.5, False, False),
        ("text", 512, 8, 16, 64 ** -0.5, True, False),
        ("t5_enc_L82", 512, 8, 82, 1.0, False, True),
        ("t5_enc_L562", 128, 8, 562, 1.0, False, True),
        ("causal_L4096", 1, 8, 4096, 64 ** -0.5, True, False),
    ]
    for name, B, H, L, scale, causal, with_bias in cases:
        for dt in (torch.float32, torch.bfloat16):
            qkv = randn(B, L, 3, H, 64, dtype=dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            bias = mask = None
            if with_bias:
                bias, mask = randn(1, H, L, L), key_mask(B, L)
            kw = dict(causal=causal, scale=scale)
            fn = lambda: attention.flash_attention(  # noqa: E731
                q, k, v, bias, mask, **kw)
            plain = lambda: attention.flash_attention_reference(  # noqa: E731
                q, k, v, bias, mask, **kw)
            want = plain()
            tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
            headline = None
            if name == "vit" and dt == torch.bfloat16:
                headline = attention_work(B, H, L, L, 64, dt, qkv, want)
                headline["library"] = lambda: sdpa(  # noqa: E731
                    q, k, v, scale=scale)
            checks.compare("flash_attention",
                           f"{name} {str(dt)[6:]} q{tuple(q.shape)}", fn(),
                           want, tol, fn, plain, headline)


def check_row_attention_qkv(checks: Checks, randn, key_mask) -> None:
    """K5 over three separately allocated (B, L, W) tensors."""
    from multimodalpromptretrieval_tpu_torch.ops import row_attention as ra

    print("K5 row attention over q, k, v (CUDA) vs row_attention_reference:")
    cases = [  # name, B, L, W, H, scale, bias+mask
        ("vit", 512, 50, 768, 12, 64 ** -0.5, False),
        ("text", 512, 16, 512, 8, 64 ** -0.5, False),
        ("t5_enc_L82", 128, 82, 512, 8, 1.0, True),
    ]
    for name, B, L, W, H, scale, with_bias in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (randn(B, L, W, dtype=dt) for _ in range(3))
            bias = mask = None
            if with_bias:
                bias = randn(H, L, L, dtype=dt)
                mask = key_mask(B, L)
            kw = dict(heads=H, scale=scale)
            fn = lambda: ra.row_attention(q, k, v, bias, mask, **kw)  # noqa: E731
            plain = lambda: ra.row_attention_reference(  # noqa: E731
                q, k, v, bias, mask, **kw)
            want = plain()
            tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
            headline = None
            if name == "vit" and dt == torch.bfloat16:
                hq, hk, hv = (x.view(B, L, H, 64).transpose(1, 2)
                              for x in (q, k, v))
                headline = attention_work(B, H, L, L, 64, dt, q, k, v, want)
                headline["library"] = lambda: sdpa(  # noqa: E731
                    hq, hk, hv, scale=scale).transpose(1, 2)
            checks.compare("row_attention",
                           f"{name} {str(dt)[6:]} q{tuple(q.shape)}", fn(),
                           want, tol, fn, plain, headline)


def check_short_attention(checks: Checks, randn) -> None:
    """K9 over (B, H, L, 64) head views of packed QKV rows and, at the ViT
    shape, over three contiguous (B, H, L, 64) tensors."""
    from multimodalpromptretrieval_tpu_torch.ops import short_attention as sa

    print("K9 short attention (CUDA) vs short_attention_reference:")
    both = (torch.float32, torch.bfloat16)
    cases = [  # name, B, H, L, scale, dtypes
        ("vit", 512, 12, 50, 64 ** -0.5, both),
        ("text", 512, 8, 16, 64 ** -0.5, both),
        ("t5_enc_L82", 128, 8, 82, 1.0, both),
        ("L128", 128, 8, 128, 64 ** -0.5, both),
        ("vit_contiguous", 512, 12, 50, 64 ** -0.5, (torch.bfloat16,)),
    ]
    for name, B, H, L, scale, dtypes in cases:
        for dt in dtypes:
            qkv = randn(B, L, 3, H, 64, dtype=dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            if name == "vit_contiguous":
                q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            fn = lambda: sa.short_attention(q, k, v, scale=scale)  # noqa: E731
            plain = lambda: sa.short_attention_reference(  # noqa: E731
                q, k, v, scale=scale)
            want = plain()
            tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
            headline = None
            if name == "vit" and dt == torch.bfloat16:
                headline = attention_work(B, H, L, L, 64, dt, qkv, want)
                headline["library"] = lambda: sdpa(  # noqa: E731
                    q, k, v, scale=scale)
            checks.compare("short_attention",
                           f"{name} {str(dt)[6:]} q{tuple(q.shape)}", fn(),
                           want, tol, fn, plain, headline)


def check_backward(checks: Checks, randn, key_mask) -> None:
    """The Functions' backward on the card (kernel forward, the JAX
    package's backward math) against ``torch.autograd.grad`` through the
    plain versions, on the same inputs and cotangent, at the train step's
    shapes. fp32: 1e-4 of the largest gradient magnitude. bf16: the
    attention backward recomputes the scores from an input-dtype product
    and rounds ``ds`` before ``dq`` / ``dk``, where autograd through the
    plain version keeps fp32, so it is held to 4 bf16 ulps of the largest
    magnitude; the norms' backward is the plain version's own."""
    from multimodalpromptretrieval_tpu_torch.ops import attention as fa
    from multimodalpromptretrieval_tpu_torch.ops import norm
    from multimodalpromptretrieval_tpu_torch.ops import row_attention as ra

    print("backward of K1, K5, K8, K2, K3 vs autograd through the plain "
          "versions:")
    B, L, W, H = 128, 82, 512, 8
    for dt in (torch.float32, torch.bfloat16):
        tols = (dict(rel_tol=1e-4) if dt == torch.float32
                else dict(ulps=4))
        mask = key_mask(B, L)
        bias = randn(H, L, L, dtype=dt).requires_grad_()
        # T5's scale is 1.0: q is drawn small, for scores of unit scale
        qkv = randn(B, L, 3 * W)
        qkv[..., :W] *= 0.125
        qkv = qkv.to(dt).requires_grad_()
        g = randn(B, L, W, dtype=dt)
        for causal in (False, True):
            kw = dict(heads=H, scale=1.0, causal=causal)
            got = torch.autograd.grad(
                ra.row_attention_packed(qkv, bias, mask, **kw), (qkv, bias),
                g)
            want = torch.autograd.grad(
                ra.row_attention_packed_reference(qkv, bias, mask, **kw),
                (qkv, bias), g)
            checks.compare_grads(
                "row_attention_packed",
                (f"{str(dt)[6:]} causal={causal}", ("qkv", "bias")), got,
                want, **tols)
        q, k, v = (randn(B, L, W, dtype=dt).requires_grad_()
                   for _ in range(3))
        kw = dict(heads=H, scale=0.125)
        got = torch.autograd.grad(ra.row_attention(q, k, v, bias, mask, **kw),
                                  (q, k, v, bias), g)
        want = torch.autograd.grad(
            ra.row_attention_reference(q, k, v, bias, mask, **kw),
            (q, k, v, bias), g)
        checks.compare_grads("row_attention",
                             (str(dt)[6:], ("q", "k", "v", "bias")), got,
                             want, **tols)
        # K8 in a pipeline stage: a microbatch of 64 rows, the (1, H, L, L)
        # encoder bias and key mask, and the decoder's causal self-attention
        hb = randn(1, H, L, L, dtype=dt).requires_grad_()
        qh = (randn(64, H, L, 64) * 0.125).to(dt).requires_grad_()
        kh, vh = (randn(64, H, L, 64, dtype=dt).requires_grad_()
                  for _ in range(2))
        gh = randn(64, H, L, 64, dtype=dt)
        for causal in (False, True):
            args = (qh, kh, vh, hb, mask[:64])
            got = torch.autograd.grad(
                fa.flash_attention(*args, causal=causal), (qh, kh, vh, hb),
                gh)
            want = torch.autograd.grad(
                fa.flash_attention_reference(*args, causal=causal),
                (qh, kh, vh, hb), gh)
            checks.compare_grads(
                "flash_attention",
                (f"{str(dt)[6:]} causal={causal}", ("q", "k", "v", "bias")),
                got, want, **tols)
        for kernel, rows, width in (("fused_layer_norm", 128 * 50, 768),
                                    ("fused_rms_norm", B * L, W)):
            x = (randn(rows, width) * 2 + 0.5).to(dt).requires_grad_()
            vecs = [randn(width, dtype=dt).requires_grad_()
                    for _ in range(2 if kernel == "fused_layer_norm" else 1)]
            gy = randn(rows, width, dtype=dt)
            got = torch.autograd.grad(getattr(norm, kernel)(x, *vecs),
                                      (x, *vecs), gy)
            want = torch.autograd.grad(
                getattr(norm, kernel + "_reference")(x, *vecs), (x, *vecs),
                gy)
            checks.compare_grads(kernel, (str(dt)[6:], ("x", "w", "b")),
                                 got, want, **tols)


def check_model_parallel_shapes(checks: Checks, randn, key_mask) -> None:
    """K1, K7 and K8 at the model_parallel phase's shapes against their
    plain versions, fp32 within 2e-5 and bf16 within one ulp of the
    output's largest value forward; the backward of K1 and K8 as
    :func:`check_backward` holds it. K1 in the tensor-parallel row encoder:
    (128, 82) rows of a rank's 4 heads (W = 256) with its 4 rows of the
    8-head bias. K7 in the tensor-parallel ``test()`` decode: B=128, 4
    heads, self (T=20, bias) and cross (82 keys, mask). K8 in a pipeline
    stage under "pallas": each microbatch (64 rows at 8 heads, 32 at 8, 64
    at 4 under TP x PP) through the encoder (82 keys, the (1, H, 82, 82)
    bias, mask), the decoder's causal self-attention (T=8, the (1, H, 8, 8)
    bias) and its cross-attention (8 queries over 82 keys, mask), on the
    head views of the block's projections."""
    from multimodalpromptretrieval_tpu_torch.ops import attention as fa
    from multimodalpromptretrieval_tpu_torch.ops import decode_attention as da
    from multimodalpromptretrieval_tpu_torch.ops import row_attention as ra

    print("K1 / K7 / K8 at the model_parallel phase's shapes vs their plain "
          "versions:")
    L, T, Dh = 82, 8, 64
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt)[6:]
        tols = (dict(rel_tol=1e-4) if dt == torch.float32
                else dict(ulps=4))

        def fwd_tol(want):
            return 2e-5 if dt == torch.float32 else bf16_ulp(want)

        # K1: model rank 1 of 2 (the bias's rows 4-7: an offset view)
        B, H = 128, 4
        W = H * Dh
        mask = key_mask(B, L)
        bias = randn(2 * H, L, L, dtype=dt)[H:].requires_grad_()
        qkv = randn(B, L, 3 * W)
        qkv[..., :W] *= 0.125
        qkv = qkv.to(dt).requires_grad_()
        kw = dict(heads=H, scale=1.0)
        got = ra.row_attention_packed(qkv, bias, mask, **kw)
        want = ra.row_attention_packed_reference(qkv, bias, mask, **kw)
        case = f"tp heads={H} {dname} qkv{tuple(qkv.shape)}"
        checks.compare("row_attention_packed", case, got.detach(),
                       want.detach(), fwd_tol(want))
        g = randn(B, L, W, dtype=dt)
        checks.compare_grads(
            "row_attention_packed", (case, ("qkv", "bias")),
            torch.autograd.grad(got, (qkv, bias), g),
            torch.autograd.grad(want, (qkv, bias), g), **tols)

        # K7: the TP decode's self- and cross-attention at 4 heads
        for name, Tk in (("self", 20), ("cross", L)):
            k, v = randn(B, Tk, W, dtype=dt), randn(B, Tk, W, dtype=dt)
            if name == "self":
                q = randn(B, 3 * W, dtype=dt)[:, :W]
                b, m = randn(H, Tk), None
            else:
                q, b, m = randn(B, W, dtype=dt), None, key_mask(B, Tk)
            want = da.decode_attention_indicator_reference(q, k, v, b, m,
                                                           heads=H)
            checks.compare(
                "decode_attention_fused",
                f"tp {name} {dname} B={B} T={Tk} W={W} H={H}",
                da.decode_attention_fused(q, k, v, b, m, heads=H), want,
                fwd_tol(want))

        # K8: the pipeline stages' microbatches
        for rows, H in ((64, 8), (32, 8), (64, 4)):
            mask = key_mask(rows, L)
            for name, Lq, Lk in (("enc", L, L), ("dec_self", T, T),
                                 ("dec_cross", T, L)):
                # T5's scale is 1.0: q is drawn small, for scores of
                # unit scale
                if name == "dec_cross":
                    q = (randn(rows, Lq, H, Dh) * 0.125).to(dt)
                    q = q.transpose(1, 2)
                    kv = randn(rows, Lk, 2, H, Dh, dtype=dt)
                    k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
                else:
                    qkv = randn(rows, Lq, 3, H, Dh)
                    qkv[:, :, 0] *= 0.125
                    q, k, v = (qkv.to(dt)[:, :, i].transpose(1, 2)
                               for i in range(3))
                b = (None if name == "dec_cross"
                     else randn(1, H, Lq, Lk, dtype=dt).requires_grad_())
                m = None if name == "dec_self" else mask
                causal = name == "dec_self"
                ins = [t.detach().requires_grad_() for t in (q, k, v)]
                if b is not None:
                    ins.append(b)
                got = fa.flash_attention(*ins[:3], b, m, causal=causal)
                want = fa.flash_attention_reference(*ins[:3], b, m,
                                                    causal=causal)
                case = (f"{name} {dname} q{tuple(q.shape)} "
                        f"k{tuple(k.shape)}")
                checks.compare("flash_attention", case, got.detach(),
                               want.detach(), fwd_tol(want))
                g = randn(*got.shape, dtype=dt)
                checks.compare_grads(
                    "flash_attention",
                    (case, ("q", "k", "v", "bias")[:len(ins)]),
                    torch.autograd.grad(got, ins, g),
                    torch.autograd.grad(want, ins, g), **tols)


def check_sharded_serve_shapes(checks: Checks, randn, key_mask) -> None:
    """K1-K4 and K7 at the shapes a sharded_serve rank gives them, against
    their plain versions: 256 rows (a rank's half of a 512-row chunk) in
    fp32 and bf16, and 4 rows (its half of the 8-row small input) in fp32.
    K1: the ViT's (rows, 50, 2304) at 12 heads, the CLIP text tower's
    (rows, 32, 1536), causal, at 8 heads, the T5 encoder's (rows, 82, 1536)
    with the (8, 82, 82) bias and the key mask; K2 on the ViT's (rows * 50,
    768) and the text tower's (rows * 32, 512); K3 on the encoder's
    (rows * 82, 512); K4 with q (rows, 1024) against the 1,230-row index,
    k = 1; K7's self-attention (T = 20, the (8, 20) bias, q a column slice
    of the (rows, 1536) projections) and cross-attention (82 keys, mask).
    Forward tolerances as the headline cases: fp32 within 2e-5 (attention)
    or 1e-5 (norms), bf16 within one ulp of the output's largest value, K4's
    indices identical and distances within 1e-3."""
    from multimodalpromptretrieval_tpu_torch.ops import decode_attention as da
    from multimodalpromptretrieval_tpu_torch.ops import norm
    from multimodalpromptretrieval_tpu_torch.ops import row_attention as ra
    from multimodalpromptretrieval_tpu_torch.ops import topk

    print("K1-K4 / K7 at the sharded_serve phase's per-rank shapes vs their "
          "plain versions:")
    index = randn(1230, 1024)
    sq = torch.sum(index * index, dim=-1)
    for rows, dtypes in ((256, (torch.float32, torch.bfloat16)),
                         (4, (torch.float32,))):
        for dt in dtypes:
            dname = str(dt)[6:]
            fp32 = dt == torch.float32
            for name, L, W, H, scale, causal, with_bias in (
                    ("vit", 50, 768, 12, 64 ** -0.5, False, False),
                    ("text", 32, 512, 8, 64 ** -0.5, True, False),
                    ("t5_enc", 82, 512, 8, 1.0, False, True)):
                qkv = randn(rows, L, 3 * W, dtype=dt)
                bias = randn(H, L, L, dtype=dt) if with_bias else None
                mask = key_mask(rows, L) if with_bias else None
                kw = dict(heads=H, scale=scale, causal=causal)
                want = ra.row_attention_packed_reference(qkv, bias, mask,
                                                         **kw)
                checks.compare(
                    "row_attention_packed",
                    f"sharded {name} {dname} qkv{tuple(qkv.shape)}",
                    ra.row_attention_packed(qkv, bias, mask, **kw), want,
                    2e-5 if fp32 else bf16_ulp(want))
            for kernel, n, W in (("fused_layer_norm", rows * 50, 768),
                                 ("fused_layer_norm", rows * 32, 512),
                                 ("fused_rms_norm", rows * 82, 512)):
                x = (randn(n, W) * 2 + 0.5).to(dt)
                vecs = [randn(W, dtype=dt)
                        for _ in range(2 if kernel == "fused_layer_norm"
                                       else 1)]
                want = getattr(norm, kernel + "_reference")(x, *vecs)
                checks.compare(kernel, f"sharded {dname} x({n}, {W})",
                               getattr(norm, kernel)(x, *vecs), want,
                               1e-5 if fp32 else bf16_ulp(want))
            H, W = 8, 512
            for case, T in (("self", 20), ("cross", 82)):
                k, v = randn(rows, T, W, dtype=dt), randn(rows, T, W,
                                                          dtype=dt)
                if case == "self":
                    q = randn(rows, 3 * W, dtype=dt)[:, :W]
                    bias, mask = randn(H, T), None
                else:
                    q = randn(rows, W, dtype=dt)
                    bias, mask = None, key_mask(rows, T)
                want = da.decode_attention_indicator_reference(
                    q, k, v, bias, mask, heads=H)
                checks.compare(
                    "decode_attention_fused",
                    f"sharded {case} {dname} B={rows} T={T} W={W}",
                    da.decode_attention_fused(q, k, v, bias, mask, heads=H),
                    want, 2e-5 if fp32 else bf16_ulp(want))
            if not fp32:
                continue  # K4 runs in fp32 whatever the compute dtype
            query = randn(rows, 1024)
            d, i = topk.l2_topk(query, index, 1, index_sq=sq)
            rd, ri = topk.l2_topk_reference(query, index, 1, sq)
            case = f"sharded q({rows}, 1024) N=1230 k=1"
            checks.expect(bool(torch.equal(i, ri)),
                          f"l2_topk {case}: indices identical")
            checks.compare("l2_topk", case + " distances", d, rd, 1e-3)


# the t5_large phase's encoder length (the 50 prefix tokens and the open
# corpus' prompts: the longest question and hint of every chunk bucket to
# the config's max_source_length, 64) and its CLIP text tower's (the open
# corpus' long questions fill the 77-token context in every chunk); the
# phase checks both
T5_LARGE_L_ENC = 114
T5_LARGE_L_TEXT = 77


def check_t5_large_shapes(checks: Checks, randn, key_mask) -> None:
    """K1-K4, K6 and K7 at the shapes of the t5_large phase's serving chunks
    (B = 128; t5-large: d_model 1024, 16 heads of 64, L_enc = 114), against
    their plain versions at the headline tolerances (fp32 within 2e-5, or
    1e-5 for the norms; bf16 within one ulp of the output's largest value;
    K4's indices identical, distances within 1e-3), each with its device ms
    beside the plain version's, its bound and the library call's time (K4:
    the two calls). K1: the ViT's packed (128, 50, 2304) qkv at 12 heads,
    the CLIP text tower's (128, 77, 1536), causal, at 8 heads, and the
    encoder's (128, 114, 3072) at 16 heads with the (16, 114, 114) bias and
    the key mask (T5's scale 1.0: q drawn small, for scores of unit scale);
    K2 on the ViT's (128 * 50, 768) and the text tower's (128 * 77, 512);
    K3 on (128 * 114, 1024); K6 and K7 cross-attention (114 keys, mask)
    and self-attention (T = 20, the (16, 20) bias, q a column slice of the
    (128, 3072) projections), at W = 1024: a warp per row and head, four
    a block, 512 blocks; K4 with q (128, 1024) against the 1,230-row
    index, k = 1."""
    from multimodalpromptretrieval_tpu_torch.ops import decode_attention as da
    from multimodalpromptretrieval_tpu_torch.ops import norm
    from multimodalpromptretrieval_tpu_torch.ops import row_attention as ra
    from multimodalpromptretrieval_tpu_torch.ops import topk

    print("K1-K4 / K6 / K7 at the t5_large phase's shapes vs their plain "
          "versions:")
    B, L, H, Dh = 128, T5_LARGE_L_ENC, 16, 64
    W = H * Dh
    F = torch.nn.functional
    for dt in (torch.float32, torch.bfloat16):
        dname, fp32 = str(dt)[6:], dt == torch.float32

        def tol(want):
            return 2e-5 if fp32 else bf16_ulp(want)

        for name, Lk, Hk, scale, causal, with_bias in (
                ("vit", 50, 12, 64 ** -0.5, False, False),
                ("text", T5_LARGE_L_TEXT, 8, 64 ** -0.5, True, False),
                ("enc", L, H, 1.0, False, True)):
            qkv = randn(B, Lk, 3 * Hk * Dh)
            if with_bias:
                qkv[..., :Hk * Dh] *= 0.125
            qkv = qkv.to(dt)
            bias = randn(Hk, Lk, Lk, dtype=dt) if with_bias else None
            mask = key_mask(B, Lk) if with_bias else None
            kw = dict(heads=Hk, scale=scale, causal=causal)
            fn = lambda: ra.row_attention_packed(  # noqa: E731
                qkv, bias, mask, **kw)
            plain = lambda: ra.row_attention_packed_reference(  # noqa: E731
                qkv, bias, mask, **kw)
            want = plain()
            hq, hk, hv = (x.transpose(1, 2) for x in
                          qkv.view(B, Lk, 3, Hk, Dh).unbind(2))
            add = None
            if with_bias:
                add = (bias[None].float() + torch.where(
                    mask[:, None, None, :] != 0, 0.0, -1e9)).to(dt)
            work = attention_work(B, Hk, Lk, Lk, Dh, dt, qkv, bias, mask,
                                  want)
            if causal:  # the products below the diagonal alone
                work["flops"] *= (Lk + 1) / (2 * Lk)
            work["library"] = lambda: sdpa(  # noqa: E731
                hq, hk, hv, add, causal, scale).transpose(1, 2)
            checks.compare("row_attention_packed",
                           f"t5_large {name} {dname} qkv{tuple(qkv.shape)} "
                           f"H={Hk}", fn(), want, tol(want), fn, plain, work,
                           store=False)

        for kernel, n, Wn in (("fused_layer_norm", B * 50, 768),
                              ("fused_layer_norm", B * T5_LARGE_L_TEXT, 512),
                              ("fused_rms_norm", B * L, W)):
            x = (randn(n, Wn) * 2 + 0.5).to(dt)
            w = randn(Wn, dtype=dt)
            is_ln = kernel == "fused_layer_norm"
            b = randn(Wn, dtype=dt) if is_ln else None
            vecs = (w, b) if is_ln else (w,)
            fn = lambda: getattr(norm, kernel)(x, *vecs)  # noqa: E731
            plain = lambda: getattr(  # noqa: E731
                norm, kernel + "_reference")(x, *vecs)
            want = plain()
            # about 8 (LayerNorm) or 5 (RMSNorm) fp32 operations an element
            work = dict(bytes=nbytes(x, w, b, want),
                        flops=(8.0 if is_ln else 5.0) * n * Wn,
                        peak=PEAK_FLOPS[torch.float32],
                        library=(lambda: F.layer_norm(x, (Wn,), w, b, 1e-5))
                        if is_ln else (lambda: F.rms_norm(x, (Wn,), w, 1e-6)))
            checks.compare(kernel, f"t5_large {dname} x({n}, {Wn})", fn(),
                           want, 1e-5 if fp32 else bf16_ulp(want), fn, plain,
                           work, store=False)

        for case, T in (("self", 20), ("cross", L)):
            k, v = randn(B, T, W, dtype=dt), randn(B, T, W, dtype=dt)
            if case == "self":
                q = randn(B, 3 * W, dtype=dt)[:, :W]
                b, m = randn(H, T), None
            else:
                q, b, m = randn(B, W, dtype=dt), None, key_mask(B, T)
            for name in DECODE_KERNELS:
                decode_case(checks, da, name, f"t5_large {case}", q, k, v,
                            b, m, H, dt, timed=True)

    query, index = randn(B, 1024), randn(1230, 1024)
    sq = torch.sum(index * index, dim=-1)
    index_t = index.t()
    fn = lambda: topk.l2_topk(query, index, 1, index_sq=sq)  # noqa: E731
    plain = lambda: topk.l2_topk_reference(query, index, 1, sq)  # noqa: E731
    d, i = fn()
    rd, ri = plain()
    case = f"t5_large q({B}, 1024) N=1230 k=1"
    checks.expect(bool(torch.equal(i, ri)),
                  f"l2_topk {case}: indices identical")
    work = dict(bytes=nbytes(query, index, sq, d, i),
                flops=2.0 * B * 1230 * 1024, peak=PEAK_FLOPS[torch.float32],
                two_calls=lambda: torch.topk(  # noqa: E731
                    torch.matmul(query, index_t), 1, largest=False))
    checks.compare("l2_topk", case + " distances", d, rd, 1e-3, fn, plain,
                   work, store=False)


def serving_setup(seed: int, dev, path: str, params=None):
    from multimodalpromptretrieval_tpu_torch.serving import north_star_setup

    t0 = time.time()
    exp, tests, images = north_star_setup(seed, dev, path=path,
                                          params=params)
    torch.cuda.synchronize()
    cfg = exp.model_cfg
    print(f"{path} path setup: data, {'shared' if params else 'random'} "
          f"weights and a {len(exp.retrieval_index)}-entry index in "
          f"{time.time() - t0:.1f} s; T5 attention_impl="
          f"{cfg.t5.attention_impl!r}, decode_attention_impl="
          f"{cfg.t5.decode_attention_impl!r}, CLIP attention_impl="
          f"{cfg.clip.attention_impl!r}", flush=True)
    return exp, tests, images


def window_of(server, tests, images, on_submit=None):
    """The serve window: stage the images, then two submits (2 chunks, then
    the rest), the second queued behind the first; returns the answers.
    ``on_submit(chunks_so_far)`` runs as each ``submit`` returns."""
    names = [e["image_name"] for e in tests]
    unique = list(dict.fromkeys(names))
    questions = [e["question"] for e in tests]
    tasks = [e["task"] for e in tests]
    B = server.exp.batch_size
    staged = np.stack([images[n] for n in unique])
    parts = (slice(0, 2 * B), slice(2 * B, len(tests)))

    def window():
        server.stage_images(staged, unique)
        handles, chunks = [], 0
        for part in parts:
            handles.append(server.submit(None, questions[part],
                                         tasks[part], image_ids=names[part]))
            chunks += -(-len(questions[part]) // B)
            if on_submit is not None:
                on_submit(chunks)
        return [a for h in handles for a in h.result()]

    return window


def drive_path(checks: Checks, path: str, exp, tests, images):
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer

    server = MPRServer(exp, load_checkpoint=False)
    names = [e["image_name"] for e in tests]
    unique = list(dict.fromkeys(names))
    questions = [e["question"] for e in tests]
    B = exp.batch_size
    split = 2 * B
    serve_window = window_of(server, tests, images)

    serve_window()  # warm-up: allocator, cuBLAS heuristics, every width
    server.chunks = {"fused": 0, "host": 0}
    server.decode_steps = 0
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    answers = serve_window()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()

    n = len(questions)
    print(f"{path} path: {len(unique)} images staged, {n} questions in "
          f"2 submits, {seconds:.3f} s", flush=True)
    checks.expect(len(answers) == n and all(isinstance(a, str)
                                            for a in answers),
                  f"answers: {len(answers)} of {n}")
    n_chunks = -(-split // B) + -(-(n - split) // B)
    checks.expect(server.chunks == {"fused": n_chunks, "host": 0},
                  f"fused path engaged: {server.chunks}")
    print(f"  decode steps run: {server.decode_steps} over {n_chunks} "
          "chunks")
    for name in PATH_KERNELS[path]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the {path} path: "
                      f"{launches[name]}")
    _, emb, pref = server._staged
    checks.expect(bool(torch.isfinite(emb).all()
                       and torch.isfinite(pref).all()),
                  f"staged tables finite: emb {tuple(emb.shape)}, "
                  f"prefix {tuple(pref.shape)}")
    print(f"  e2e: {n / seconds:.1f} QA/s on {torch.cuda.get_device_name(0)}"
          " (staging + 2 submits, bf16, B=512, k=1)", flush=True)
    return launches


def check_small_input(checks: Checks, path: str, exp, tests,
                      images) -> None:
    """The kernel path (card, fp32) against the plain versions (CPU,
    fp32) on 8 requests, under the path's config: CLIP towers, T5 encoder
    and greedy ids."""
    from multimodalpromptretrieval_tpu_torch.models import clip, mprgen, t5
    from multimodalpromptretrieval_tpu_torch.serve import (
        image_embed_prefix_step,
    )

    cfg = dataclasses.replace(exp.model_cfg, compute_dtype="float32")
    entries = tests[:8]
    imgs = torch.from_numpy(np.stack([images[e["image_name"]]
                                      for e in entries]))
    cids = torch.from_numpy(clip.truncate_text_ids(
        exp.clip_tokenizer.tokenize([e["question"] for e in entries])))
    rows, lens = exp.tokenizer.encode_rows(
        [f"Answer the {e['task']} question: " + e["question"]
         for e in entries])
    ids = torch.from_numpy(rows)
    mask = (torch.arange(ids.shape[1])[None, :]
            < torch.from_numpy(lens)[:, None]).to(torch.int32)
    cpu_params = copy.deepcopy(exp.params).cpu()
    outs = {}
    for where, params in (("card", exp.params), ("cpu", cpu_params)):
        dev = params.t5.shared.device
        with torch.inference_mode():
            emb, pref = image_embed_prefix_step(params, cfg, imgs.to(dev))
            txt = clip.clip_encode_text(params.clip, cfg.clip, cids.to(dev))
            embeds = torch.cat([pref, params.t5.shared[ids.to(dev).long()]],
                               dim=1)
            full = torch.cat([torch.ones(pref.shape[:2], dtype=mask.dtype),
                              mask], dim=1).to(dev)
            enc = t5.t5_encode(params.t5, cfg.t5, embeds, full)
            toks = mprgen.generative_predict_from_prefix(
                params, cfg, pref, ids.to(dev), mask.to(dev))
        outs[where] = [x.cpu() for x in (emb, pref, txt, enc, toks)]
    for name, a, b in zip(("image embedding", "prefix", "text embedding",
                           "T5 encoder hidden"), outs["card"], outs["cpu"]):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        checks.expect(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale,
                      f"{path} path small input, {name} {tuple(a.shape)}: "
                      f"card vs cpu max_abs_err {err:.3g} (tol 1e-4 x "
                      f"{scale:.3g})")
    same = torch.equal(outs["card"][4], outs["cpu"][4])
    checks.expect(same, f"{path} path small input, greedy ids "
                  f"{tuple(outs['card'][4].shape)} identical on card and cpu")


def features_experiment(exp):
    """The main path's experiment with zero rows in its T5 embedding: the
    pad row, and every id past the tokenizer's vocabulary. A random tied
    head re-emits its input token and the decode starts from pad, and ids
    past the synthetic corpus' vocabulary decode to nothing, so the main
    path's random weights answer the empty string every time; with these
    rows zeroed the answers carry text (as the CPU tests make them), and
    comparing them means something."""
    fexp = copy.copy(exp)
    fexp.params = copy.deepcopy(exp.params)
    zero_unused_rows(fexp.params, len(exp.tokenizer))
    return fexp


def zero_unused_rows(params, n_tokens: int) -> None:
    """The pad row and every row past the tokenizer's vocabulary of T5's
    embedding set to zero, in place (see :func:`features_experiment`)."""
    with torch.no_grad():
        params.t5.shared[0] = 0.0
        params.t5.shared[n_tokens:] = 0.0


def drive_features(checks: Checks, exp, tests, images, card: str):
    """The server's options on the main path's load (``exp`` from
    :func:`features_experiment`). Launch counts are set to 0 before the
    option servers and read after them."""
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer

    n, B = len(tests), exp.batch_size
    n_chunks = -(-2 * B // B) + -(-(n - 2 * B) // B)
    base = MPRServer(exp, load_checkpoint=False)
    want = window_of(base, tests, images)()
    steps = base.decode_steps
    print(f"features: the bf16 main path's {len(want)} answers are the "
          f"baseline ({np.mean([bool(a) for a in want]):.4f} non-empty, "
          f"{len(set(want))} distinct, {steps} decode steps over {n_chunks} "
          f"chunks; first: {want[0]!r})", flush=True)

    _build.reset_launch_counts()
    for name, options in FEATURES:
        before = _build.launch_counts()
        server = MPRServer(exp, load_checkpoint=False, **options)
        window = window_of(server, tests, images)
        window()  # warm-up
        server.chunks = {"fused": 0, "host": 0}
        server.decode_steps = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = window()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in _build.launch_counts().items()
                  if v != before[k]}
        same = float(np.mean([a == b for a, b in zip(answers, want)]))
        checks.expect(len(answers) == n and server.chunks == {
            "fused": n_chunks, "host": 0},
            f"features {name}: {len(answers)} answers, chunks "
            f"{server.chunks}, {server.decode_steps} decode steps, "
            f"{n / seconds:.1f} QA/s (staging + 2 submits, bf16, B={B}) on "
            f"{card}; share identical to the bf16 main path {same:.4f}; "
            f"launches {counts}")
        if name == "length_sort":
            checks.expect(same == 1.0, "features length_sort: every answer "
                          "identical to the unsorted server's, in order")
        del server
    launches = _build.launch_counts()
    for name in PATH_KERNELS["features"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the features path: "
                      f"{launches[name]}")

    check_pipelined_submit(checks, exp, tests, images, want, card)
    check_perfect_drafts(checks, base, exp, tests)
    time_int8_gemm(checks)
    time_block_attention(checks)
    return launches


def check_pipelined_submit(checks: Checks, exp, tests, images, want,
                           card: str) -> None:
    """``submit`` returns while its last chunk still runs: a CUDA event
    recorded on the server's stream after each chunk's step is not yet
    recorded, or not yet complete, when ``submit`` returns. Then QA/s of
    three requests of one chunk each, answered one by one and pipelined
    (``h = submit(next); prev.result()``, ``pipeline_depth=2``)."""
    from multimodalpromptretrieval_tpu_torch import serve

    events = []
    step = serve.fused_serve_step

    def recorded(*args, **kw):
        out = step(*args, **kw)
        events.append(torch.cuda.Event())
        events[-1].record()
        return out

    unfinished = []

    def on_submit(chunks):
        unfinished.append(len(events) < chunks
                          or not events[chunks - 1].query())

    server = serve.MPRServer(exp, load_checkpoint=False, pipeline_depth=2)
    window_of(server, tests, images)()  # warm-up
    serve.fused_serve_step = recorded
    try:
        answers = window_of(server, tests, images, on_submit)()
    finally:
        serve.fused_serve_step = step
    checks.expect(all(unfinished) and answers == want,
                  f"pipelined submit (depth 2): the last chunk unfinished "
                  f"when submit returned in {sum(unfinished)} of "
                  f"{len(unfinished)} submits; answers identical to the "
                  "serial ones")

    B = exp.batch_size
    names = [e["image_name"] for e in tests]
    requests = [(None, [e["question"] for e in tests[s:s + B]],
                 [e["task"] for e in tests[s:s + B]], names[s:s + B])
                for s in range(0, len(tests), B)]
    staged = list(dict.fromkeys(names))
    rates = {}
    for depth in (1, 2):
        server = serve.MPRServer(exp, load_checkpoint=False,
                                 pipeline_depth=depth)
        server.stage_images(np.stack([images[x] for x in staged]), staged)
        for run in range(2):  # warm-up, then timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, prev = [], None
            for r in requests:
                if depth == 1:
                    got += server.answer(*r[:3], image_ids=r[3])
                    continue
                h = server.submit(*r[:3], image_ids=r[3])
                if prev is not None:
                    got += prev.result()
                prev = h
            if prev is not None:
                got += prev.result()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        rates[depth] = len(got) / seconds
        checks.expect(got == want, f"{len(requests)} requests of {B}, "
                      f"pipeline_depth={depth}: answers identical to the "
                      "window's")
    print(f"  QA/s over {len(requests)} requests of {B} staged questions: "
          f"serial {rates[1]:.1f}, pipelined (depth 2) {rates[2]:.1f} on "
          f"{card}", flush=True)


def check_perfect_drafts(checks: Checks, server, exp, tests) -> None:
    """One chunk of B=512 at bf16 through the T5 encoder (prompts without
    hints, the staged prefixes): the lockstep decode, then the speculative
    decode with the lockstep ids as drafts (share of identical rows,
    >= 0.99 required: the pass's GEMMs have other shapes than a step's, so
    bf16 may round a near tie the other way), then again with its own ids
    as drafts: every pass accepts S + 1 = 5 tokens, 4 passes for 20 (a
    chunk whose rows all end early takes fewer). Times a lockstep step
    against a verification pass."""
    from multimodalpromptretrieval_tpu_torch.models import t5
    from multimodalpromptretrieval_tpu_torch.serve import steps_run

    B, cfg, params = exp.batch_size, exp.model_cfg, server.params
    entries = tests[:B]
    pos, _, pref = server._staged
    rows, lens = exp.tokenizer.encode_rows(
        [f"Answer the {e['task']} question: " + e["question"]
         for e in entries])
    dev = pref.device
    ids = torch.from_numpy(rows).to(dev)
    mask = (torch.arange(ids.shape[1], device=dev)[None, :]
            < torch.from_numpy(lens).to(dev)[:, None]).to(torch.int32)
    with torch.inference_mode():
        prefix = pref[torch.tensor([pos[e["image_name"]] for e in entries],
                                   device=dev)]
        embeds = torch.cat([prefix, params.t5.shared[ids.long()]], dim=1)
        full = torch.cat([torch.ones(prefix.shape[:2], dtype=mask.dtype,
                                     device=dev), mask], dim=1)
        enc = t5.t5_encode(params.t5, cfg.t5, embeds, full)
        runs = {}
        for name in ("lockstep", "spec", "self"):
            drafts = (None if name == "lockstep" else
                      runs["lockstep" if name == "spec" else "spec"][0][:, 1:])
            stats = {}
            for _ in range(2):  # warm-up, then timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = (t5.t5_greedy_decode(params.t5, cfg.t5, enc, full)
                        if drafts is None else t5.t5_spec_greedy_decode(
                            params.t5, cfg.t5, enc, full, drafts, block=4,
                            stats=stats))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            runs[name] = (toks, seconds, stats.get("passes"))
    steps = steps_run(runs["lockstep"][0].cpu().numpy(), cfg.t5.eos_token_id)
    same = (runs["spec"][0] == runs["lockstep"][0]).all(1).float().mean()
    checks.expect(float(same) >= 0.99,
                  f"spec decode, lockstep ids as drafts (B={B}, bf16): "
                  f"share of rows identical to lockstep {float(same):.4f} "
                  f"(>= 0.99), {runs['spec'][2]} passes")
    # S + 1 = 5 tokens accepted a pass, over the spec decode's own rows
    passes = -(-steps_run(runs["spec"][0].cpu().numpy(),
                          cfg.t5.eos_token_id) // 5)
    checks.expect(runs["self"][2] == passes
                  and torch.equal(runs["self"][0], runs["spec"][0]),
                  f"spec decode, its own ids as drafts: {runs['self'][2]} "
                  f"passes ({passes} required: 5 tokens accepted a pass), "
                  "the same ids")
    print(f"  lockstep decode {1e3 * runs['lockstep'][1]:.2f} ms for "
          f"{steps} steps ({1e3 * runs['lockstep'][1] / max(steps, 1):.3f} "
          f"ms a step); spec decode {1e3 * runs['self'][1]:.2f} ms for "
          f"{runs['self'][2]} passes "
          f"({1e3 * runs['self'][1] / runs['self'][2]:.3f} ms a pass, "
          "S + 1 = 5 positions)", flush=True)


def time_int8_gemm(checks: Checks) -> None:
    """``dense_q8`` (row quantization, the library int8 GEMM, the scale
    epilogue) against the bf16 ``dense`` at the decode step's shapes and
    the encoder's FF shape; the GEMM alone against its exact plain version
    at the decode shape. Bounds: bytes (x in bf16, int8 weight and fp32
    scale, bf16 output) over the memory rate, 2 M N K operations over the
    int8 peak (bf16: its weight in bf16, the bf16 peak)."""
    from multimodalpromptretrieval_tpu_torch.ops import layers, quant

    print("int8 W8A8 dense (library int8 GEMM) vs bf16 dense:")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, M, K, N in (("decode qkv", 512, 512, 1536),
                          ("decode FF wi", 512, 512, 2048),
                          ("decode FF wo", 512, 2048, 512),
                          ("encoder FF wi", 512 * 82, 512, 2048)):
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        w = torch.randn((N, K), generator=gen, device="cuda")
        qw, wb = quant.quantize_kernel(w), w.bfloat16()
        q_ms = time_ms(lambda: quant.dense_q8(x, qw))
        b_ms = time_ms(lambda: layers.dense(x, wb))
        xq, _ = quant.quantize_rows(x)
        mm_ms = time_ms(lambda: quant.int8_matmul(xq, qw.q8))
        q_bound = bound(2 * M * K + N * K + 4 * N + 2 * M * N,
                        2.0 * M * N * K, PEAK_FLOPS[torch.int8])
        b_bound = bound(2 * (M * K + N * K + M * N), 2.0 * M * N * K,
                        PEAK_FLOPS[torch.bfloat16])
        line = (f"  {name} ({M} x {K} -> {N}): dense_q8 {q_ms:.4f} ms "
                f"(int8 GEMM alone {mm_ms:.4f}), bound {q_bound[0]:.4f} by "
                f"{q_bound[1]}; bf16 dense {b_ms:.4f} ms, bound "
                f"{b_bound[0]:.4f} by {b_bound[1]}")
        if M == 512 and N == 1536:
            cpu_w = quant.QWeight(qw.q8.cpu(), qw.q_scale.cpu())
            exact = (torch.equal(quant.int8_matmul(xq, qw.q8).cpu(),
                                 quant.int8_matmul_reference(xq.cpu(),
                                                             cpu_w.q8))
                     and torch.equal(quant.dense_q8(x, qw).cpu(),
                                     quant.dense_q8(x.cpu(), cpu_w)))
            checks.expect(exact, line + "; int32 accumulator and output "
                          "identical to the plain version's (CPU)")
        else:
            print(line, flush=True)


def time_block_attention(checks: Checks) -> None:
    """The verification pass's block attention (plain torch, as in the JAX
    package) at its two shapes, B=512, S + 1 = 5 queries a row, bf16:
    self-attention over the T + S = 24 cache slots with a (B, 5, H, 24)
    bias, cross-attention over 82 encoder keys with a mask. Bound: bytes of
    q, k, v, bias or mask and the output, and 4 B (S+1) T W operations (the
    products are rounded one by one: not a matrix product) over the fp32
    peak. Library: SDPA with the same additive bias, on no path."""
    from multimodalpromptretrieval_tpu_torch.ops import decode_attention as da

    print("block attention of the verification pass (plain torch):")
    randn, key_mask = input_makers(torch.device("cuda"))
    B, S, H, W = 512, 5, 8, 512
    for case, T in (("self", 24), ("cross", 82)):
        q = randn(B, S, W, dtype=torch.bfloat16)
        k, v = (randn(B, T, W, dtype=torch.bfloat16) for _ in range(2))
        bias = mask = None
        if case == "self":
            bias = randn(B, S, H, T)
            add = bias.transpose(1, 2)
        else:
            mask = key_mask(B, T)
            add = torch.where(mask[:, None, None, :] != 0, 0.0, -1e9)
        fn = lambda: da.block_attention_indicator(  # noqa: E731
            q, k, v, heads=H, bias=bias, kv_mask=mask)
        hq = q.view(B, S, H, 64).transpose(1, 2)
        hk, hv = (x.view(B, T, H, 64).transpose(1, 2) for x in (k, v))
        lib = lambda: sdpa(hq, hk, hv, add.to(q.dtype), scale=1.0)  # noqa: E731
        out = fn()
        ms, lib_ms = time_ms(fn), time_ms(lib)
        b_ms, by = bound(nbytes(q, k, v, bias, mask, out),
                         4.0 * B * S * T * W, PEAK_FLOPS[torch.float32])
        checks.expect(bool(torch.isfinite(out).all()),
                      f"  {case} (B={B}, S+1={S}, T={T}, W={W}): "
                      f"{ms:.4f} ms, bound {b_ms:.4f} by {by}, SDPA "
                      f"{lib_ms:.4f} ms")


def check_small_features(checks: Checks, exp, tests, images) -> None:
    """The card (kernels) against the CPU (plain versions) at fp32, on
    small inputs: the speculative decode on 8 requests through the prefix
    step and a length-sorted server (chunks of 4) on 12 requests, with the
    card's retrieval index and staged image tables on both sides: greedy
    ids (answers) identical. int8 (T5 blocks, the serving default) on the
    8 requests from the card's prefix on both sides: each int8 product is
    exact on both (``time_int8_gemm`` and the card tests hold it bit for
    bit), but the row quantization turns the kernels' 1e-6 fp32 differences
    into whole int8 steps now and then, so a near tie of the argmax may
    fall the other way: 7 of 8 rows identical are required, the share
    printed."""
    from multimodalpromptretrieval_tpu_torch.models import mprgen
    from multimodalpromptretrieval_tpu_torch.ops import quant
    from multimodalpromptretrieval_tpu_torch.retrieval.index import (
        RetrievalIndex,
    )
    from multimodalpromptretrieval_tpu_torch.serve import (
        MPRServer,
        image_embed_prefix_step,
    )

    cfg = dataclasses.replace(exp.model_cfg, compute_dtype="float32")
    entries = tests[:8]
    imgs = torch.from_numpy(np.stack([images[e["image_name"]]
                                      for e in entries]))
    rows, lens = exp.tokenizer.encode_rows(
        [f"Answer the {e['task']} question: " + e["question"]
         for e in entries])
    ids = torch.from_numpy(rows)
    mask = (torch.arange(ids.shape[1])[None, :]
            < torch.from_numpy(lens)[:, None]).to(torch.int32)
    cpu_params = copy.deepcopy(exp.params).cpu()
    with torch.inference_mode():
        _, card_pref = image_embed_prefix_step(exp.params, cfg,
                                               imgs.to(exp.device))
    outs = {}
    for where, params in (("card", exp.params), ("cpu", cpu_params)):
        dev = params.t5.shared.device
        q8 = quant.quantize_params(params, t5=True)
        q8_all = quant.quantize_params(params, t5=True, clip=True)
        with torch.inference_mode():
            int8 = mprgen.generative_predict_from_prefix(
                q8, cfg, card_pref.to(dev), ids.to(dev), mask.to(dev))
            _, pref = image_embed_prefix_step(q8_all, cfg, imgs.to(dev))
            int8_all = mprgen.generative_predict_from_prefix(
                q8_all, cfg, pref, ids.to(dev), mask.to(dev))
            _, pref = image_embed_prefix_step(params, cfg, imgs.to(dev))
            lock = mprgen.generative_predict_from_prefix(
                params, cfg, pref, ids.to(dev), mask.to(dev))
            drafts = lock[:, 1:].clone()
            drafts[::2, 4:] = 5  # half the rows diverge after 4 tokens
            spec = mprgen.generative_predict_from_prefix(
                params, cfg, pref, ids.to(dev), mask.to(dev),
                draft_ids=drafts, spec_block=4)
        outs[where] = [x.cpu() for x in (int8, spec, lock, int8_all)]
    same = (outs["card"][0] == outs["cpu"][0]).all(1).float().mean()
    checks.expect(float(same) >= 7 / 8, "small input at fp32, int8: share "
                  f"of greedy id rows identical on card and cpu "
                  f"{float(same):.4f} (>= 7/8)")
    print("  small input at fp32, int8_all (each side's own int8 ViT "
          "prefix; printed only): share of rows identical on card and cpu "
          f"{float((outs['card'][3] == outs['cpu'][3]).all(1).float().mean()):.4f}")
    a, b = outs["card"][1], outs["cpu"][1]
    checks.expect(torch.equal(a, b), "small input at fp32, spec decode: "
                  f"greedy ids {tuple(a.shape)} identical on card and cpu")
    checks.expect(torch.equal(outs["card"][1], outs["card"][2]),
                  "small input at fp32: spec decode ids identical to "
                  "lockstep on the card")

    answers, index = {}, exp.retrieval_index
    small = tests[:12]
    names = [e["image_name"] for e in small]
    ask = ([e["question"] for e in small], [e["task"] for e in small])
    staged = None
    for where, params in (("card", exp.params), ("cpu", cpu_params)):
        dev = params.t5.shared.device
        e = copy.copy(exp)
        e.model_cfg, e.batch_size, e.params = cfg, 4, params
        e.retrieval_index = RetrievalIndex(
            index.embeddings, index.answers, index.question_info, False,
            index.retrieval_k, dev)
        server = MPRServer(e, load_checkpoint=False, length_sort=True)
        if staged is None:
            server.stage_images(np.stack([images[x] for x in names]), names)
            staged = server._staged
        else:  # the card's image rows: the same retrieval queries' half
            pos, emb, pref = staged
            server._staged = (pos, emb.to(dev), pref.to(dev))
        answers[where] = server.answer(None, *ask, image_ids=names)
    checks.expect(answers["card"] == answers["cpu"],
                  f"small input at fp32, length sort (12 requests, chunks "
                  f"of 4): answers identical on card and cpu")


def drive_kernel_check(checks: Checks):
    """K5 and K9 through their own entry point, launches counted."""
    from multimodalpromptretrieval_tpu_torch import kernel_check
    from multimodalpromptretrieval_tpu_torch.ops import _build

    print("kernel_check path (K5, K9 vs the head-layout attention):")
    _build.reset_launch_counts()
    results = kernel_check.run()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    for name, ok, d in results:
        checks.expect(ok, f"kernel_check {name}: maxdiff={d:.4f} (tol 5e-2)")
    for name in PATH_KERNELS["kernel_check"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the kernel_check path: "
                      f"{launches[name]}")
    return launches


def drive_train_path(checks: Checks, seed: int, dev, card: str, params,
                     warmup: int = 2, timed: int = 20):
    """The train path at full width: hints and the vision-token table once,
    then ``warmup + timed`` steps on one fixed batch. Launch counts are set
    to 0 before the path and read after it; the per-step counts come from
    readings between the steps."""
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        north_star_train_setup,
    )

    t0 = time.time()
    exp = north_star_train_setup(seed, dev, params=params, quiet=True)
    torch.cuda.synchronize()
    cfg = exp.model_cfg
    print(f"train path setup: data, weights and a "
          f"{len(exp.retrieval_index)}-entry index in {time.time() - t0:.1f}"
          f" s; compute {cfg.compute_dtype}, dropout {cfg.t5.dropout_rate}, "
          f"T5 / CLIP attention_impl={cfg.t5.attention_impl!r} / "
          f"{cfg.clip.attention_impl!r}, B={exp.batch_size}", flush=True)
    frozen = {n: p.detach().clone() for n, p in exp.params.named_parameters()
              if not exp.trainable[n]}

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    exp.retrieval_index.is_training_phase = True
    exp.precompute_hints("train")
    built = exp.build_vision_token_cache("train", "validate")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = _build.launch_counts()
    table = exp._vision_tokens[0]
    checks.expect(built and bool(torch.isfinite(table).all()),
                  f"vision-token table {tuple(table.shape)} {table.dtype} "
                  f"finite; hints + table in {setup_s:.2f} s, launches "
                  f"K1 {setup_launches['row_attention_packed']}, "
                  f"K2 {setup_launches['fused_layer_norm']}, "
                  f"K4 {setup_launches['l2_topk']}")
    batch = exp.device_batch(exp.make_split_batches(
        "train", shuffle=True, epoch=0)[0])
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    checks.expect(shapes["input_ids"] == (128, 32)
                  and shapes["labels"] == (128, 8)
                  and shapes["vision_tokens"] == (128, 50, 512),
                  f"fixed batch {shapes}")
    step = exp.train_step()
    lr = exp.cfg["hyperparameters"]["learning_rate"]
    losses, counts = [], [setup_launches]
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(exp.params, exp.opt_state, batch, lr,
                           exp.dropout_gen))
        counts.append(_build.launch_counts())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()

    losses = torch.stack(losses).float().cpu().tolist()
    per_step = [{k: b[k] - a[k] for k in b if b[k] != a[k]}
                for a, b in zip(counts, counts[1:])]
    checks.expect(all(math.isfinite(x) for x in losses),
                  f"{len(losses)} losses finite: first {losses[0]:.4f}, "
                  f"last {losses[-1]:.4f}")
    checks.expect(losses[-1] < losses[0],
                  "loss after the last step lower than after the first "
                  "(one batch, repeated)")
    # no recompute: cfg.remat is off, and the backward of K1 / K3 is plain
    # torch on the saved inputs, so a step launches its forward kernels only
    want = {"row_attention_packed": cfg.t5.num_layers,
            "fused_rms_norm": 2 * cfg.t5.num_layers + 1}
    checks.expect(all(c == want for c in per_step),
                  f"launches per step: {per_step[0]} (forward: K1 "
                  f"{want['row_attention_packed']}, K3 "
                  f"{want['fused_rms_norm']}; the decoder runs plain norms "
                  "and attention, as in the JAX package)")
    same = all(torch.equal(p, frozen[n])
               for n, p in exp.params.named_parameters() if n in frozen)
    checks.expect(same, f"{len(frozen)} frozen CLIP parameters bit-identical "
                  "after the steps")
    for name in PATH_KERNELS["train"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the train path: {launches[name]}")
    B = exp.batch_size
    print(f"  train: {B * timed / seconds:.1f} examples/s, "
          f"{1e3 * seconds / timed:.2f} ms per step over {timed} steps "
          f"(B={B}, L=82, T=8, bf16 compute, dropout "
          f"{cfg.t5.dropout_rate}) on {card}", flush=True)
    return launches


def check_small_step(checks: Checks, seed: int, dev) -> None:
    """Three fp32 train steps at dropout 0 from identical seeded
    parameters: on the card (kernels) and on the CPU (plain versions)."""
    from multimodalpromptretrieval_tpu_torch.serving import (
        synthetic_config,
        synthetic_slake,
    )
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        TrainingExperiment,
    )

    splits, images = synthetic_slake(8, 0, image_size=64, seed=seed,
                                     n_validate=2)
    cfg = synthetic_config(batch_size=8, retrieval=True, k=3, image_size=64)
    cfg["seed"] = seed
    # the kernels' head dim is 64
    cfg["t5_overrides"].update(d_model=128, d_kv=64, num_heads=2, d_ff=256,
                               dropout_rate=0.0, attention_impl="row")
    cfg["clip_overrides"].update(embed_dim=128, vision_width=128,
                                 text_width=128, attention_impl="row")
    runs = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        exp = TrainingExperiment(cfg, train=splits["train"],
                                 validate=splits["validate"], images=images,
                                 device=device, quiet=True)
        exp.retrieval_index.is_training_phase = True
        exp.precompute_hints("train")
        exp.build_vision_token_cache("train")
        batch = exp.device_batch(exp.make_split_batches("train")[0])
        step = exp.train_step()
        losses = [float(step(exp.params, exp.opt_state, batch, 1e-3))
                  for _ in range(3)]
        runs[where] = (losses, {n: p.detach().cpu() for n, p in
                                exp.params.named_parameters()})
    (lc, pc), (lh, ph) = runs["card"], runs["cpu"]
    err = max(abs(a - b) for a, b in zip(lc, lh))
    checks.expect(err <= 1e-4, f"small fp32 step, 3 losses card {lc} vs cpu "
                  f"{lh}: max difference {err:.3g} (tol 1e-4)")
    perr = max((pc[n] - ph[n]).abs().max().item() for n in pc)
    checks.expect(perr <= 1e-4, "small fp32 step, parameters after the third "
                  f"step: card vs cpu max_abs_err {perr:.3g} (tol 1e-4)")


# the cli phase's dataset: training and test images (3 QA each), the
# batch, and the image resolution of CLIP ViT-B/32
CLI_DATA = dict(n_train=128, n_test=128, batch_size=128, image_size=224)


def write_cli_dataset(root: str, seed: int, dev, n_train: int, n_test: int,
                      image_size: int, **_):
    """A synthetic SLAKE on disk written with numpy alone: the JSON splits,
    and each split's ``images_{split}_{size}.npz`` cache preprocessed by
    the port's ``clip_preprocess`` on ``dev`` from the drawn uint8 images
    (no PNG, no PIL). Returns the dataset folder."""
    from multimodalpromptretrieval_tpu_torch.data import images as pimages
    from multimodalpromptretrieval_tpu_torch.data import synthetic
    from multimodalpromptretrieval_tpu_torch.ops.image import (
        preprocess_arrays,
    )

    slake = f"{root}/SLAKE"
    raw = {}
    splits = synthetic.generate_synthetic_slake(
        slake, n_train=n_train, n_validate=8, n_test=n_test,
        image_size=image_size, seed=seed, images_out=raw)
    for split, entries in splits.items():
        names = list(dict.fromkeys(e["img_name"] for e in entries))
        arrays = preprocess_arrays([raw[n] for n in names], size=image_size,
                                   batch=128, device=dev)
        np.savez_compressed(pimages.cache_path(slake, split, image_size),
                            **dict(zip(names, arrays)))
    return slake


def cli_config(root: str, seed: int) -> dict:
    """The full-width config of the cli phase: t5-small + CLIP ViT-B/32 at
    224 px, the main serving path's attention knobs (row attention, the
    default indicator decode), bf16 compute, retrieval k=1."""
    from multimodalpromptretrieval_tpu_torch.data import synthetic
    from multimodalpromptretrieval_tpu_torch.serving import SERVE_PATHS

    cfg = synthetic.synthetic_config(
        root, batch_size=CLI_DATA["batch_size"], epochs=1, retrieval=True,
        k=1, image_size=CLI_DATA["image_size"])
    cfg.update(seed=seed, compute_dtype="bfloat16",
               **copy.deepcopy(SERVE_PATHS["main"]))
    cfg["hyperparameters"]["learning_rate"] = 1e-4
    return cfg


def cli_workspace(root: str, seed: int, dev):
    """The cli phase's dataset and config under ``root``, written at the
    first call (the eval and parallel phases reuse them): (config path,
    {"logs": ..., "models": ...})."""
    import os

    cfg_path = os.path.join(root, "cfg.json")
    if not os.path.exists(cfg_path):
        t0 = time.time()
        write_cli_dataset(root, seed, dev, **CLI_DATA)
        with open(cfg_path, "w") as f:
            json.dump(cli_config(root, seed), f)
        print("cli data: synthetic SLAKE on disk ({n_train} + 8 + "
              "{n_test} images, their {image_size}-px caches preprocessed "
              "on the card) in {s:.1f} s".format(s=time.time() - t0,
                                                   **CLI_DATA), flush=True)
    return cfg_path, {n: os.path.join(root, n) for n in ("logs", "models")}


def drive_cli_path(checks: Checks, seed: int, dev, card: str, root: str):
    """The disk-data entry points at full width: a synthetic SLAKE written
    under ``root`` (:func:`cli_workspace`), ``run_from_config`` with train
    (one epoch) and test, then ``cli.serve_stream`` over the test questions
    (3 per image) with a NEW experiment, whose server loads the trained
    checkpoint. Launch counts are set to 0 before the path and read after
    it."""
    import io
    import os

    from multimodalpromptretrieval_tpu_torch import cli
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer
    from multimodalpromptretrieval_tpu_torch.serving import ServingExperiment
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        run_from_config,
    )

    cfg_path, dirs = cli_workspace(root, seed, dev)
    with open(cfg_path) as f:
        cfg = json.load(f)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    exp, res = run_from_config(cfg_path, train=True, test=True,
                               device=dev, quiet=True,
                               log_root=dirs["logs"],
                               model_root=dirs["models"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    losses = [x for _, x in res["train"]["train_losses"]]
    metrics = res["test"]
    n_test_q = sum(metrics.total.values())
    perf = os.path.join(dirs["logs"], exp.model_prefix + "performance.txt")
    checks.expect(len(losses) == 1 and all(math.isfinite(x)
                                           for x in losses),
                  f"cli train: {res['train']['parameter_updates']} "
                  f"steps over {len(exp.splits['train'])} entries, "
                  f"loss {losses}")
    checks.expect(os.path.exists(exp.model_path) and os.path.exists(perf)
                  and n_test_q == len(exp.splits["test"]),
                  f"cli test: {n_test_q} questions scored, overall "
                  f"{metrics.overall:.4f}, {os.path.basename(perf)} "
                  "written")
    print(f"  cli train (1 epoch) + test: {run_s:.2f} s", flush=True)

    # a new experiment (seed weights) and server, as a new process
    # would build them: the server loads the trained checkpoint
    fresh = ServingExperiment(copy.deepcopy(cfg), device=dev,
                              model_root=dirs["models"])
    seed_shared = fresh.params.t5.shared.detach().clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    MPRServer(fresh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    entries = fresh.splits["test"]
    text = "".join(json.dumps({"question": e["question"],
                               "task": e["task"],
                               "image_name": e["image_name"]}) + "\n"
                   for e in entries)
    out = io.StringIO()
    t0 = time.perf_counter()
    n = cli.serve_stream(fresh, io.StringIO(text), out)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    streamed = [json.loads(x).get("answer")
                for x in out.getvalue().splitlines()]
    # the stream's own set-up may load the checkpoint faster than the
    # one timed alone; then the difference is no time at all
    without = (f"{n / (serve_s - setup_s):.1f} QA/s without"
               if serve_s > setup_s else "without it not separable")
    print(f"  cli server set-up (the checkpoint loaded, the compute "
          f"copy made): {1e3 * setup_s:.1f} ms; serve_stream: {n} "
          f"requests in {1e3 * serve_s:.1f} ms, {n / serve_s:.1f} QA/s "
          f"with its own server's set-up, {without} (B="
          f"{cfg['hyperparameters']['batch_size']}, bf16, k=1) on "
          f"{card}", flush=True)

    names = [e["image_name"] for e in entries]
    images = np.stack([fresh.images[x] for x in names])
    ask = ([e["question"] for e in entries], [e["task"] for e in entries])
    direct = MPRServer(fresh, load_checkpoint=False).answer(
        images, *ask, image_ids=names)
    checks.expect(len(streamed) == len(entries) and streamed == direct,
                  f"cli serve_stream: {len(streamed)} answers equal to "
                  "MPRServer.answer on the same requests")
    trained = MPRServer(exp, load_checkpoint=False).answer(
        images, *ask, image_ids=names)
    loaded = (torch.equal(fresh.params.t5.shared, exp.params.t5.shared)
              and not torch.equal(fresh.params.t5.shared, seed_shared))
    checks.expect(loaded and streamed == trained,
                  "cli serve_stream: the new server loaded the trained "
                  "checkpoint (its answers equal a server's with the "
                  "trained params in memory)")
    for name in PATH_KERNELS["cli"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the cli path: {launches[name]}")
    return launches


# the variants phase: each variant's config keys and the kernels its serve
# path launches (text-only: the CLIP towers and K4 for the hints, the T5
# encoder and K7 decode; head: no decode; BAN: no hint, so no top-k)
VARIANTS = (
    ("text-only", {"use_image_info": 0},
     ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
      "l2_topk", "decode_attention_fused")),
    ("head", {"use_prediction_head": 1},
     ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
      "l2_topk")),
    ("BAN", {"use_prediction_head": 1, "use_BAN": 1},
     ("row_attention_packed", "fused_layer_norm", "fused_rms_norm")),
)
# the synthetic ROCO corpus of the head and BAN variants' extended index
ROCO_IMAGES = 200


def drive_variants(checks: Checks, seed: int, dev, card: str):
    """The text-only, prediction-head and BAN variants at full width on the
    main path's load (t5-small + CLIP ViT-B/32, bf16, row attention, decode
    "indicator", B=512, 1,536 questions over 512 images, the 1,230-entry
    corpus, k=1): each served through ``MPRServer``'s per-batch path (the
    images of every request, two submits, the second queued behind the
    first), timed after a warm-up, launch counts set to 0 just before and
    read just after. Each variant draws the seeded random init (text-only:
    the main path's weights before the train phase updates them in place;
    head and BAN: the same CLIP and T5 and their own head). The head and
    BAN configs add the synthetic ROCO index
    (``use_additional_retrieval_data``), built by the text-only
    experiment's CLIP (the same towers from the same seed). Then 2 + 5
    train steps of head and BAN, and 8 rows of each variant at fp32 on the
    card against the CPU."""
    import os
    import tempfile

    from multimodalpromptretrieval_tpu_torch.serving import (
        build_roco_index,
        north_star_setup,
        synthetic_roco,
    )

    launches = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory() as root:
        roco_path = os.path.join(root, "roco", "index.npz")
        for name, keys, kernels in VARIANTS:
            config = dict(keys)
            if name != "text-only":
                config.update(use_additional_retrieval_data=1,
                              additional_retrieval_cache=roco_path)
            t0 = time.time()
            exp, tests, images = north_star_setup(seed, dev, config=config)
            torch.cuda.synchronize()
            print(f"variant {name} setup: data, random weights and a "
                  f"{len(exp.retrieval_index)}-entry index in "
                  f"{time.time() - t0:.1f} s", flush=True)
            if name == "text-only":
                t0 = time.time()
                entries, roco_images = synthetic_roco(
                    ROCO_IMAGES, image_size=224, seed=seed)
                roco = build_roco_index(exp, entries, roco_images, roco_path)
                torch.cuda.synchronize()
                print(f"  ROCO corpus: {ROCO_IMAGES} images, {len(roco)} "
                      f"rows embedded in {time.time() - t0:.1f} s",
                      flush=True)
                n_roco = len(roco)
                del roco
            else:
                check_extended_index(checks, exp, tests, images, n_roco)
            counts = serve_variant(checks, name, exp, tests, images, kernels,
                                   card)
            for k, v in counts.items():
                launches[k] += v
            check_small_variant(checks, name, exp, tests, images)
            if name != "text-only":
                train_variant(checks, name, seed, dev, card, config)
            del exp
            torch.cuda.empty_cache()
    return launches


def check_extended_index(checks: Checks, exp, tests, images,
                         n_roco: int) -> None:
    """``use_additional_retrieval_data``: the index is the 1,230 corpus
    rows and the ROCO rows; K4 over it on the card against its plain
    version, on one chunk's (image (+) question) queries."""
    from multimodalpromptretrieval_tpu_torch.ops import topk

    index = exp.retrieval_index
    n_corpus = len(exp.retrieval_dataset.entries)
    checks.expect(len(index) == n_corpus + n_roco
                  and len(index.answers) == len(index),
                  f"use_additional_retrieval_data: index of {len(index)} = "
                  f"{n_corpus} corpus + {n_roco} ROCO rows")
    entries = tests[:exp.batch_size]
    ids = exp.clip_tokenizer.tokenize([e["question"] for e in entries])
    query = exp._clip_embed(
        np.stack([images[e["image_name"]] for e in entries]), ids).float()
    d, i = topk.l2_topk(query, index.embeddings, exp.k,
                        index_sq=index.index_sq)
    rd, ri = topk.l2_topk_reference(query.contiguous(), index.embeddings,
                                    exp.k, index.index_sq)
    checks.expect(bool(torch.equal(i, ri)),
                  f"l2_topk over the extended index ({tuple(query.shape)} "
                  f"queries, N={len(index)}, k={exp.k}): indices identical "
                  f"to the plain version; {int((i >= n_corpus).sum())} "
                  "nearest rows are ROCO rows")
    # both square the distance as |q|^2 - 2 q.n + |n|^2 in fp32 with the
    # dots summed in other orders: each within D * 2^-24 (|q|^2 + |n|^2) of
    # the exact value, so the squared distances are held to twice that (at
    # a near-zero distance the square root magnifies the difference)
    D = query.shape[1]
    scale = float(torch.sum(query * query, dim=1).max()
                  + index.index_sq.max())
    tol = 2 * D * 2.0 ** -24 * scale
    err = float((d * d - rd * rd).abs().max())
    checks.expect(err <= tol and bool(torch.isfinite(d).all()),
                  f"l2_topk extended index N={len(index)} k={exp.k} squared "
                  f"distances: max_abs_err={err:.3g} (tol {tol:.3g})")


def serve_variant(checks: Checks, name: str, exp, tests, images, kernels,
                  card: str):
    """One variant's serve window: warm-up, then the timed window with
    the launch counts set to 0 just before and read just after."""
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer

    server = MPRServer(exp, load_checkpoint=False)
    B = exp.batch_size
    imgs = [images[e["image_name"]] for e in tests]
    questions = [e["question"] for e in tests]
    tasks = [e["task"] for e in tests]
    parts = (slice(0, 2 * B), slice(2 * B, len(tests)))

    def window():
        handles = [server.submit(imgs[p], questions[p], tasks[p])
                   for p in parts]
        return [a for h in handles for a in h.result()]

    window()  # warm-up
    server.chunks = {"fused": 0, "host": 0}
    server.decode_steps = 0
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    answers = window()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()
    n = len(tests)
    n_chunks = -(-2 * B // B) + -(-(n - 2 * B) // B)
    classify = exp.model_cfg.use_prediction_head
    valid = (set(answers) <= set(exp.label2ans.values()) if classify
             else all(isinstance(a, str) for a in answers))
    shown = {k: launches[k] for k in ("row_attention_packed",
                                      "fused_layer_norm", "fused_rms_norm",
                                      "l2_topk", "decode_attention_fused")}
    checks.expect(len(answers) == n and valid and server.chunks == {
        "fused": 0, "host": n_chunks},
        f"variant {name}: {len(answers)} answers in {n_chunks} chunks "
        f"{server.chunks}, {server.decode_steps} decode steps, "
        f"{n / seconds:.1f} QA/s (images of every request, 2 submits, "
        f"bf16, B={B}, k={exp.k}, {len(exp.retrieval_index)}-entry index) "
        f"on {card}; {len(set(answers))} distinct answers; launches "
        f"{shown}")
    for k in kernels:
        checks.expect(launches[k] > 0,
                      f"{k} launches in the variant {name} path: "
                      f"{launches[k]}")
    for k in set(shown) - set(kernels):
        checks.expect(launches[k] == 0,
                      f"{k} not launched in the variant {name} path: "
                      f"{launches[k]}")
    return launches


def check_small_variant(checks: Checks, name: str, exp, tests,
                        images) -> None:
    """8 rows through the variant's predict at fp32: the kernels on the
    card against the plain versions on the CPU, from the same weights
    (text-only: the pad row zeroed on both sides, so that the greedy ids
    are not all the pad the random tied head re-emits). Class ids, or
    greedy ids, identical."""
    from multimodalpromptretrieval_tpu_torch.models import mprgen

    cfg = dataclasses.replace(exp.model_cfg, compute_dtype="float32")
    entries = tests[:8]
    rows, lens = exp.tokenizer.encode_rows(
        [f"Answer the {e['task']} question: " + e["question"]
         for e in entries])
    batch = {"input_ids": torch.from_numpy(rows),
             "text_mask": (torch.arange(rows.shape[1])[None, :]
                           < torch.from_numpy(lens)[:, None]).to(torch.int32)}
    if cfg.use_image_info or cfg.use_ban:
        batch["images"] = torch.from_numpy(np.stack(
            [images[e["image_name"]] for e in entries]))
    card_params = exp.params
    if name == "text-only":
        card_params = copy.deepcopy(exp.params)
        with torch.no_grad():
            card_params.t5.shared[0] = 0.0
    outs = {}
    for where, params in (("card", card_params),
                          ("cpu", copy.deepcopy(card_params).cpu())):
        dev = params.t5.shared.device
        with torch.inference_mode():
            outs[where] = mprgen.variant_predict(
                params, cfg, {k: v.to(dev) for k, v in batch.items()}).cpu()
    a, b = outs["card"], outs["cpu"]
    what = "class ids" if cfg.use_prediction_head else "greedy ids"
    checks.expect(torch.equal(a, b), f"variant {name} small input at fp32: "
                  f"{what} {tuple(a.shape)} identical on card and cpu "
                  f"(card {a.flatten()[:8].tolist()})")


# the variants' train steps run at this learning rate: at the train cell's
# 1e-4 the seeded random BAN overshoots (its loss on the batch rises over
# the seven steps), while at 1e-5 it falls; the port's BAN steps are the
# JAX package's (tests/test_torch_variants.py)
VARIANT_LR = 1e-5


def train_variant(checks: Checks, name: str, seed: int, dev, card: str,
                  config, warmup: int = 2, timed: int = 5) -> None:
    """2 warm-up and 5 timed steps on one batch of the variant's train
    load (``north_star_train_setup``: fp32 masters, bf16 compute, B=128,
    row attention; ``VARIANT_LR``): finite losses, the batch's loss without
    dropout lower after the steps than before, frozen CLIP
    bit-identical."""
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        north_star_train_setup,
    )

    exp = north_star_train_setup(seed, dev, quiet=True, config=config)
    frozen = {n: p.detach().clone() for n, p in exp.params.named_parameters()
              if not exp.trainable[n]}
    exp.retrieval_index.is_training_phase = True
    exp.precompute_hints("train")
    exp.build_vision_token_cache("train", "validate")
    batch = exp.device_batch(exp.make_split_batches(
        "train", shuffle=True, epoch=0)[0])
    step = exp.train_step()
    lr = VARIANT_LR
    # the batch's loss without dropout, before and after the steps: the
    # dropout sites (0.5 on BAN's image side) make the steps' own losses
    # too noisy to fall within seven steps
    before = float(exp.eval_step()(exp.params, batch))
    losses = []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(exp.params, exp.opt_state, batch, lr,
                           exp.dropout_gen))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = float(exp.eval_step()(exp.params, batch))
    losses = torch.stack(losses).float().cpu().tolist()
    same = all(torch.equal(p, frozen[n])
               for n, p in exp.params.named_parameters() if n in frozen)
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    checks.expect(all(math.isfinite(x) for x in losses + [before, after])
                  and after < before and same,
                  f"variant {name} train: the batch's loss without dropout "
                  f"{before:.4f} -> {after:.4f}; the steps' losses "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
                  "steps, "
                  f"{len(frozen)} frozen CLIP parameters bit-identical; "
                  f"{1e3 * seconds / timed:.2f} ms per step over {timed} "
                  f"(B={exp.batch_size}, bf16 compute, lr {lr}, batch "
                  f"{shapes}) on "
                  f"{card}")
    del exp


# the mapping's training run over the corpus' CLIP features
MAPPING_EPOCHS, MAPPING_BATCH, MAPPING_LR = 20, 64, 1e-3


def openai_rn_state_dict(cfg, seed: int):
    """A seeded ModifiedResNet state dict in OpenAI's layout (``visual.*``,
    shortcut ``downsample.0`` / ``downsample.1``): convs N(0, 1 / fan_in),
    norms' scale U(0.5, 1.5), shift and running mean U(-0.1, 0.1), running
    variance U(0.5, 1.5), the attention pool's table at the config's
    resolution and its projections N(0, 1 / C)."""
    from multimodalpromptretrieval_tpu_torch.models.resnet import (
        blocks,
        has_downsample,
    )

    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = torch.randn(
            (cout, cin, k, k), generator=gen) * (cin * k * k) ** -0.5

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=gen) + 0.5
        sd[f"{name}.bias"] = (torch.rand(c, generator=gen) - 0.5) * 0.2
        sd[f"{name}.running_mean"] = (torch.rand(c, generator=gen) - 0.5) * 0.2
        sd[f"{name}.running_var"] = torch.rand(c, generator=gen) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    w = cfg.width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2),
                                     (w // 2, w)), 1):
        conv(f"visual.conv{i}", cin, cout, 3)
        bn(f"visual.bn{i}", cout)
    for li, bi, cin, cmid, stride in blocks(cfg):
        p = f"visual.layer{li + 1}.{bi}"
        for i, (a, b, k) in enumerate(((cin, cmid, 1), (cmid, cmid, 3),
                                       (cmid, 4 * cmid, 1)), 1):
            conv(f"{p}.conv{i}", a, b, k)
            bn(f"{p}.bn{i}", b)
        if has_downsample(cin, cmid, stride):
            conv(f"{p}.downsample.0", cin, 4 * cmid, 1)
            bn(f"{p}.downsample.1", 4 * cmid)
    c = cfg.final_channels
    ap = "visual.attnpool"
    sd[f"{ap}.positional_embedding"] = torch.randn(
        (cfg.grid ** 2 + 1, c), generator=gen) * c ** -0.5
    for n, out in (("q_proj", c), ("k_proj", c), ("v_proj", c),
                   ("c_proj", cfg.embed_dim)):
        sd[f"{ap}.{n}.weight"] = torch.randn((out, c), generator=gen) * c ** -0.5
        sd[f"{ap}.{n}.bias"] = torch.zeros(out)
    return sd


def save_arrays(path: str, sd, wrap: str = "") -> None:
    """``{name: array}`` saved as a torch file of tensors (under ``wrap``,
    e.g. the reference's ``model_state_dict``, when given)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({wrap: sd} if wrap else sd, path)


def small_greedy_ids(exp, tests, images):
    """The main path's small input (8 requests, prompts without hints)
    through the experiment's compute copy: greedy ids on its device."""
    from multimodalpromptretrieval_tpu_torch.models import mprgen
    from multimodalpromptretrieval_tpu_torch.serve import (
        image_embed_prefix_step,
    )

    cfg, dev = exp.model_cfg, exp.device
    entries = tests[:8]
    imgs = torch.from_numpy(np.stack([images[e["image_name"]]
                                      for e in entries])).to(dev)
    rows, lens = exp.tokenizer.encode_rows(
        [f"Answer the {e['task']} question: " + e["question"]
         for e in entries])
    ids = torch.from_numpy(rows).to(dev)
    mask = (torch.arange(ids.shape[1], device=dev)[None, :]
            < torch.from_numpy(lens).to(dev)[:, None]).to(torch.int32)
    run = mprgen.cast_compute(exp.params, cfg)
    with torch.inference_mode():
        _, pref = image_embed_prefix_step(run, cfg, imgs)
        return mprgen.generative_predict_from_prefix(
            run, cfg, pref, ids, mask).cpu()


def same_answers(checks: Checks, what: str, a, b, tests, images) -> None:
    """Two experiments on the main load: the served window (staging + 2
    submits, the fused path) and the small input's greedy ids identical."""
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer

    outs = []
    for exp in (a, b):
        server = MPRServer(exp, load_checkpoint=False)
        answers = window_of(server, tests, images)()
        outs.append((answers, server.chunks, small_greedy_ids(exp, tests,
                                                              images)))
        del server
    (wa, ca, ia), (wb, cb, ib) = outs
    checks.expect(wa == wb and ca == cb and ca["host"] == 0
                  and torch.equal(ia, ib),
                  f"pretrained {what}: {len(wb)} served answers identical "
                  f"({np.mean([bool(x) for x in wb]):.4f} non-empty, chunks "
                  f"{cb}); small input's greedy ids {tuple(ib.shape)} "
                  f"identical (first row {ib[0, :8].tolist()})")


def same_params(checks: Checks, what: str, got, want) -> None:
    want = dict(want.named_parameters())
    names = [n for n, _ in got.named_parameters()]
    same = names == list(want) and all(
        torch.equal(p, want[n]) for n, p in got.named_parameters())
    checks.expect(same, f"pretrained {what}: all {len(names)} parameters "
                  "bit-identical to the exported ones")


def check_round_trip(checks: Checks, seed: int, dev, root: str):
    """(a) The main path's seeded parameters (pad and out-of-vocabulary T5
    rows zeroed) exported by the port's ``t5_to_hf`` and ``clip_to_openai``
    and by ``mprgen_to_reference_state_dict``, saved as torch files, and
    loaded by new ``ServingExperiment``s through ``t5_checkpoint`` /
    ``clip_checkpoint`` and through ``reference_checkpoint`` on the main
    load. ``t5_checkpoint`` resizes the embedding to the tokenizer's length
    (as the JAX package does), so its yardstick is the same parameters with
    the embedding cut to that length; ``reference_checkpoint`` keeps every
    row. Returns the main experiment (its index feeds the mapping)."""
    import os

    from multimodalpromptretrieval_tpu_torch import bridge
    from multimodalpromptretrieval_tpu_torch.models import convert, export
    from multimodalpromptretrieval_tpu_torch.serving import north_star_setup

    exp, tests, images = north_star_setup(seed, dev)
    cfg, n_tok = exp.model_cfg, len(exp.tokenizer)
    zero_unused_rows(exp.params, n_tok)
    t0 = time.time()
    tree = bridge.tree_numpy(bridge.params_to_jax(exp.params, cfg))
    t5_path = os.path.join(root, "t5-small.bin")
    clip_path = os.path.join(root, "ViT-B-32.pt")
    save_arrays(t5_path, export.t5_to_hf(tree["t5"], cfg.t5))
    save_arrays(clip_path, export.clip_to_openai(tree["clip"], cfg.clip))
    print(f"pretrained: t5-small and ViT-B/32 exported and saved in "
          f"{time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    loaded, _, _ = north_star_setup(seed, dev, config={
        "t5_checkpoint": t5_path, "clip_checkpoint": clip_path})
    torch.cuda.synchronize()
    print(f"pretrained: experiment from t5_checkpoint + clip_checkpoint in "
          f"{time.time() - t0:.1f} s", flush=True)
    os.remove(t5_path)
    os.remove(clip_path)
    cut_cfg = dataclasses.replace(cfg, t5=dataclasses.replace(
        cfg.t5, vocab_size=n_tok))
    cut = copy.copy(exp)
    cut.model_cfg = cut_cfg
    cut.params = bridge.params_from_jax(dict(
        tree, t5=convert.resize_token_embeddings(tree["t5"], n_tok)),
        cut_cfg, dev)
    checks.expect(loaded.model_cfg == cut_cfg and torch.equal(
        loaded.retrieval_index.embeddings, exp.retrieval_index.embeddings),
        f"pretrained t5 + clip checkpoints: T5 embedding resized "
        f"{cfg.t5.vocab_size} -> {n_tok} rows; the "
        f"{len(exp.retrieval_index)}-entry index the "
        "loaded CLIP embeds is bit-identical")
    same_params(checks, "t5 + clip checkpoints", loaded.params, cut.params)
    same_answers(checks, "t5 + clip checkpoints vs the same parameters",
                 cut, loaded, tests, images)
    del loaded, cut

    t0 = time.time()
    ref_path = os.path.join(root, "reference.pt")
    save_arrays(ref_path, export.mprgen_to_reference_state_dict(tree, cfg),
                wrap="model_state_dict")
    del tree
    loaded, _, _ = north_star_setup(seed, dev, config={
        "reference_checkpoint": ref_path})
    torch.cuda.synchronize()
    os.remove(ref_path)
    print(f"pretrained: reference checkpoint written and loaded in "
          f"{time.time() - t0:.1f} s", flush=True)
    same_params(checks, "reference checkpoint", loaded.params, exp.params)
    same_answers(checks, "reference checkpoint vs the same parameters",
                 exp, loaded, tests, images)
    del loaded
    return exp


def drive_rn(checks: Checks, seed: int, dev, card: str, root: str):
    """(b) RN50x4 + t5-small at full width: a seeded OpenAI-layout RN50x4
    (its attention-pool table for 288 px) saved with PubMedCLIP's
    ``visual_encoder.`` prefix under ``state_dict`` and loaded through
    ``vision_checkpoint`` into ``vision_encoder: RN50x4`` at the ViT's 224
    px (a 7 x 7 grid of 2,560 channels through ``rn_proj``); 1,536
    questions served at B=512 on the per-batch path (the hints from the
    ViT), 8 rows on the card against the CPU at fp32, then 2 + 5 train
    steps with the RN grid in the vision-token table."""
    import os

    from multimodalpromptretrieval_tpu_torch.models.resnet import (
        ResNetConfig,
    )
    from multimodalpromptretrieval_tpu_torch.serving import north_star_setup

    t0 = time.time()
    sd = openai_rn_state_dict(ResNetConfig.rn50x4(), seed)
    path = os.path.join(root, "pubmedclip_rn50x4.pth")
    torch.save({"state_dict": {f"visual_encoder.{k}": v
                               for k, v in sd.items()}}, path)
    config = {"vision_encoder": "RN50x4", "vision_checkpoint": path}
    exp, tests, images = north_star_setup(seed, dev, config=config)
    torch.cuda.synchronize()
    cfg = exp.model_cfg
    rn = exp.params.clip_rn
    n = sum(p.numel() for p in rn.parameters())
    checks.expect(
        cfg.resnet.final_channels == 2560 and cfg.num_image_tokens == 49
        and tuple(rn.attnpool.pos.shape) == (82, 2560)
        and torch.equal(rn.layer3[9].conv2.cpu(),
                        sd["visual.layer3.9.conv2.weight"])
        and torch.equal(rn.layer4[0].downsample.bn.var.cpu(),
                        sd["visual.layer4.0.downsample.1.running_var"]),
        f"pretrained RN50x4: {n} parameters loaded from the vision "
        f"checkpoint in {time.time() - t0:.1f} s (written and read); 49 "
        "tokens x 2,560 channels at 224 px; the pool's table 82 x 2,560 "
        "(288 px)")
    del sd
    zero_unused_rows(exp.params, len(exp.tokenizer))
    launches = serve_variant(checks, "RN50x4", exp, tests, images,
                             PATH_KERNELS["pretrained"], card)
    check_small_variant(checks, "RN50x4", exp, tests, images)
    check_small_rn(checks, exp, images, tests)
    del exp, rn
    torch.cuda.empty_cache()
    train_variant(checks, "RN50x4", seed, dev, card, config)
    os.remove(path)
    torch.cuda.empty_cache()
    return launches


def check_small_rn(checks: Checks, exp, images, tests) -> None:
    """The RN tower at fp32 on 8 images, cuDNN on the card (TF32 off)
    against the CPU, from the same weights: the layer4 grid (B, 49, 2,560)
    and its ``rn_proj`` prefix (B, 49, 512), each within 1e-4 of its
    largest magnitude (the greedy ids of random weights barely vary, so
    they alone would not show a wrong convolution)."""
    from multimodalpromptretrieval_tpu_torch.models import mprgen

    cfg = dataclasses.replace(exp.model_cfg, compute_dtype="float32")
    imgs = torch.from_numpy(np.stack([images[e["image_name"]]
                                      for e in tests[:8]]))
    outs = {}
    for where, params in (("card", exp.params),
                          ("cpu", copy.deepcopy(exp.params).cpu())):
        dev = params.t5.shared.device
        with torch.inference_mode():
            grid = mprgen.vision_trunk(params, cfg, imgs.to(dev))
            pref = mprgen.prefix_from_vision_tokens(params, cfg, grid)
        outs[where] = (grid.cpu(), pref.cpu())
    for name, a, b in zip(("RN grid", "rn_proj prefix"), outs["card"],
                          outs["cpu"]):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        checks.expect(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale,
                      f"RN50x4 small input, {name} {tuple(a.shape)}: card "
                      f"vs cpu max_abs_err {err:.3g} (tol 1e-4 x "
                      f"{scale:.3g})")


def drive_mapping(checks: Checks, seed: int, dev, card: str, root: str,
                  exp) -> None:
    """(c) The mapping MLP trained on the card over the corpus' CLIP
    features (each index row's image and question embeddings, from the main
    experiment ``exp``), written as a mapping checkpoint, and served on the
    main load through ``mapping_checkpoint`` (the fused path: the mapping
    maps the staged ViT tokens); 8 requests on the card against the CPU at
    fp32."""
    import os

    from multimodalpromptretrieval_tpu_torch.models.mprgen import Mapping
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer
    from multimodalpromptretrieval_tpu_torch.serving import north_star_setup
    from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt
    from multimodalpromptretrieval_tpu_torch.train import mapping

    E = exp.model_cfg.clip.embed_dim
    emb = exp.retrieval_index.embeddings.float().cpu().numpy()
    img, txt = emb[:, :E], emb[:, E:]
    init = Mapping(E, torch.Generator().manual_seed(seed)).to(dev)
    before = mapping.retrieval_accuracy(init, img, txt, k=5)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = mapping.train_mapping(
        img, txt, epochs=MAPPING_EPOCHS, batch_size=MAPPING_BATCH,
        lr=MAPPING_LR, seed=seed, device=dev, init=init, losses=losses)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = mapping.retrieval_accuracy(params, img, txt, k=5)
    per = len(losses) // MAPPING_EPOCHS
    first, last = np.mean(losses[:per]), np.mean(losses[-per:])
    checks.expect(
        params.logit_scale.device.type == "cuda"
        and all(math.isfinite(x) for x in losses) and last < first,
        f"pretrained mapping: {len(losses)} steps on {card} over "
        f"{len(img)} paired ({E}-d image, {E}-d question) CLIP features, "
        f"{1e3 * seconds / len(losses):.2f} ms a step; epoch loss "
        f"{first:.4f} -> {last:.4f}; top-5 retrieval accuracy {before:.4f} "
        f"-> {after:.4f}")
    path = os.path.join(root, "mapping.npz")
    ckpt.save_mapping(path, params)
    mexp, tests, images = north_star_setup(seed, dev, config={
        "mapping_checkpoint": path})
    zero_unused_rows(mexp.params, len(mexp.tokenizer))
    got = dict(mexp.params.mapping.named_parameters())
    same = all(torch.equal(p, got[n]) for n, p in params.named_parameters())
    server = MPRServer(mexp, load_checkpoint=False)
    answers = window_of(server, tests, images)()
    checks.expect(same and len(answers) == len(tests)
                  and server.chunks["host"] == 0,
                  f"pretrained mapping checkpoint: loaded bit-identical; "
                  f"{len(answers)} answers on the fused path {server.chunks}")
    del server
    check_small_input(checks, "mapping", mexp, tests, images)
    os.remove(path)
    del mexp


def drive_pretrained(checks: Checks, seed: int, dev, card: str):
    """The pretrained phase: (a) the converter round trip, (c) the mapping,
    (b) RN50x4 + t5-small; its launches are the RN path's window's."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        exp = check_round_trip(checks, seed, dev, root)
        drive_mapping(checks, seed, dev, card, root, exp)
        del exp
        torch.cuda.empty_cache()
        return drive_rn(checks, seed, dev, card, root)


# the eval phase: test entries run through attention_maps, and the two
# compared with the CPU at fp32
EVAL_EXAMPLES, EVAL_CPU_EXAMPLES = 32, 2


def drive_eval(checks: Checks, seed: int, dev, card: str, root: str):
    """The ``--eval`` path at full width on the cli phase's data, seeded
    weights (they never emit EOS, so each decode runs its 20 steps; the
    cli phase's one-epoch checkpoint answers EOS at the first): the test
    split's hints, then ``attention_maps`` of 32 test entries (the ViT, the
    T5 encoder and greedy decode on the fp32 masters, then the
    teacher-forced forward with every map); shapes, row sums, answers, the
    card against the CPU at fp32 on 2 entries; the figures where
    matplotlib and PIL import."""
    import os

    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.train import visualize
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        TrainingExperiment,
    )

    cfg_path, dirs = cli_workspace(root, seed, dev)
    with open(cfg_path) as f:
        cfg = json.load(f)
    exp = TrainingExperiment(cfg, device=dev, train_mode=False, quiet=True,
                             log_root=dirs["logs"])
    mcfg = exp.model_cfg
    entries = exp.splits["test"][:EVAL_EXAMPLES]

    _build.reset_launch_counts()
    exp.precompute_hints("test")
    torch.cuda.synchronize()
    maps, seconds = [], []
    for e in entries:
        t0 = time.perf_counter()
        maps.append(visualize.attention_maps(exp, e))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    ms = sorted(1e3 * x for x in seconds[1:])
    print(f"  eval: {len(entries)} examples (seeded weights, fp32 masters), "
          f"first {1e3 * seconds[0]:.2f} ms, then "
          f"median {ms[len(ms) // 2]:.2f} ms (min {ms[0]:.2f}, max "
          f"{ms[-1]:.2f}) per example, synced; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} on {card}",
          flush=True)

    t5, P = mcfg.t5, mcfg.num_image_tokens
    shapes_ok = sums_ok = answers_ok = True
    for e, m in zip(entries, maps):
        L, T = P + len(m["input_ids"]), m["output_ids"].shape[1]
        shapes_ok &= (
            m["encoder_attentions"].shape
            == (t5.num_layers, 1, t5.num_heads, L, L)
            and m["decoder_attentions"].shape
            == (t5.num_decoder_layers, 1, t5.num_heads, T, T)
            and m["cross_attentions"].shape
            == (t5.num_decoder_layers, 1, t5.num_heads, T, L)
            and m["logits"].shape == (1, T, t5.vocab_size))
        sums_ok &= all(float(np.abs(m[k].sum(-1) - 1.0).max()) <= 1e-3
                       for k in ("encoder_attentions", "decoder_attentions",
                                 "cross_attentions"))
        answers_ok &= m["predicted_answer"] == exp.tokenizer.decode(
            m["output_ids"][0], skip_special_tokens=True)
    checks.expect(shapes_ok, f"eval: the maps of {len(entries)} examples "
                  f"have their shapes (encoder (6, 1, 8, L, L), L = {P} + "
                  "the prompt; decoder (6, 1, 8, 21, 21); cross (6, 1, 8, "
                  "21, L); logits (1, 21, 32128))")
    checks.expect(sums_ok, "eval: every probability row of the three maps "
                  "sums to 1 within 1e-3")
    checks.expect(answers_ok, "eval: predicted_answer is the decode of "
                  "output_ids")
    answers = [m["predicted_answer"] for m in maps]
    print(f"  eval answers: {len(set(answers))} distinct of {len(answers)},"
          f" e.g. {answers[:3]}", flush=True)

    cpu = copy.copy(exp)
    cpu.params = copy.deepcopy(exp.params).cpu()
    cpu.device = torch.device("cpu")
    for e, m in zip(entries[:EVAL_CPU_EXAMPLES], maps):
        want = visualize.attention_maps(cpu, e)
        same = np.array_equal(m["output_ids"], want["output_ids"])
        errs = {k: float(np.abs(m[k] - want[k]).max())
                / max(float(np.abs(want[k]).max()), 1e-30)
                for k in ("encoder_attentions", "decoder_attentions",
                          "cross_attentions", "logits")}
        checks.expect(same and max(errs.values()) <= 1e-5,
                      f"eval card vs cpu at fp32, question "
                      f"{e['question_id']}: output_ids identical {same}, "
                      "max_abs_err over the largest value "
                      + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                      + " (tol 1e-5)")
    # the figures: host-only work (the maps above are the device work),
    # drawn over the image file where matplotlib and PIL are installed
    missing = [m for m in ("matplotlib", "PIL")
               if importlib.util.find_spec(m) is None]
    image = os.path.join(entries[0]["dataroot"], "imgs",
                         entries[0]["image_name"])
    if missing or not os.path.exists(image):
        print("  eval figures not written: "
              + (f"{' and '.join(missing)} not installed" if missing else
                 "the dataset, written with numpy alone, has no image "
                 "files"), flush=True)
    else:
        with tempfile.TemporaryDirectory() as figs:
            n = visualize.visualize_correct_ids(
                exp, qid=entries[0]["question_id"], figures_root=figs)
            checks.expect(n == t5.num_decoder_layers * t5.num_heads,
                          f"eval: {n} figures written")
    for name in PATH_KERNELS["eval"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the eval path: {launches[name]}")
    return launches


# the parallel phase's steps compared in (a)
DP_STEPS = 3


def dp_worker_module():
    """``tests/torch_multihost_worker.py``: the data-parallel check that the
    parallel phase runs in this process and in each of its two ranks."""
    import os

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_multihost_worker

    return torch_multihost_worker


def leaf_err(got: dict, want: dict, prefix: str, want_prefix: str):
    """The largest over the leaves under ``prefix`` of max |got - want|
    over the leaf's largest |want|, and that leaf's name."""
    errs = {}
    for k, v in want.items():
        if k.startswith(want_prefix):
            n = k[len(want_prefix):]
            g = torch.from_numpy(got[prefix + n]).double()
            w = torch.from_numpy(v).double()
            errs[n] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                       1e-30)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def drive_parallel(checks: Checks, seed: int, dev, card: str, root: str):
    """Data parallelism over a torch.distributed group: (a) a world-size-1
    NCCL group runs the data-parallel train step on the train phase's load,
    bit for bit the plain step's over 3 steps; (b) two processes on the one
    card over gloo (``tests/torch_multihost_worker.py`` on its "train"
    load) against the same work in this process: 3 fp32 steps at dropout 0
    (the losses, the summed step-1 gradients against this process's of the
    same two row blocks, the parameters), 2 + 10 timed bf16 steps at
    dropout 0.1, ``test()`` of the cli checkpoint, ``sharded_l2_topk``
    against one K4. The phase's launches are (a)'s and the two ranks'."""
    import os
    import socket

    import numpy as np

    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh
    from multimodalpromptretrieval_tpu_torch.parallel import multihost
    from multimodalpromptretrieval_tpu_torch.train import step as steps

    worker = dp_worker_module()

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def run_steps(exp, batch, step):
        lr = exp.cfg["hyperparameters"]["learning_rate"]
        return torch.stack([step(exp.params, exp.opt_state, batch, lr,
                                 exp.dropout_gen) for _ in range(DP_STEPS)])

    # (a) world size 1, NCCL: the data-parallel step is the plain step
    _build.reset_launch_counts()
    multihost.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        exp = worker.train_experiment(seed, dev, fp32=False)
        batch = worker.first_batch(exp)
        params0 = {n: p.detach().clone()
                   for n, p in exp.params.named_parameters()}
        opt0 = {k: ({n: t.clone() for n, t in v.items()}
                    if isinstance(v, dict) else v)
                for k, v in exp.opt_state.items()}
        gen0 = exp.dropout_gen.get_state()
        plain = run_steps(exp, batch, steps.make_train_step(
            exp.model_cfg, exp.trainable, steps.ComputeCopy()))
        after_plain = {n: p.detach().clone()
                       for n, p in exp.params.named_parameters()}
        with torch.no_grad():
            for n, p in exp.params.named_parameters():
                p.copy_(params0[n])
        exp.opt_state = opt0
        exp.dropout_gen.set_state(gen0)
        before = _build.launch_counts()
        dp = run_steps(exp, batch, steps.make_train_step(
            exp.model_cfg, exp.trainable, steps.ComputeCopy(),
            mesh=pmesh.Mesh(1)))
        after = _build.launch_counts()
        per_step = {k: (after[k] - before[k]) // DP_STEPS for k in after
                    if after[k] != before[k]}
        same = torch.equal(plain, dp) and all(
            torch.equal(p, after_plain[n])
            for n, p in exp.params.named_parameters())
        torch.save(worker.train_topk_inputs(exp, seed),
                   os.path.join(root, "topk_inputs.pt"))
    finally:
        multihost.shutdown()
    launches = _build.launch_counts()
    checks.expect(same, f"parallel (a): {backend} group of 1, the "
                  f"data-parallel step bit for bit the plain step over "
                  f"{DP_STEPS} steps (bf16, dropout 0.1): losses "
                  f"{plain.float().tolist()}, every parameter equal")
    want = {"row_attention_packed": 6, "fused_rms_norm": 13}
    checks.expect(per_step == want, f"parallel (a): launches per step "
                  f"{per_step} (K1 6, K3 13)")
    del exp, batch, params0, opt0, after_plain
    torch.cuda.empty_cache()

    # (b) the worker's run in this process, then in two processes
    dirs = cli_checkpoint(root, seed, dev)
    single = worker.run("train", os.path.join(root, "single"),
                        dirs["models"], inputs=root, seed=seed, dev=dev,
                        blocks=2)
    torch.cuda.empty_cache()
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in (
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, "--load", "train", "--rank",
         str(r), "--world", "2", "--port", str(port), "--root", root,
         "--seed", str(seed)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            print(f"--- rank {r} rc={p.returncode} ---\n{out[-6000:]}",
                  flush=True)
    checks.expect(all(p.returncode == 0 for p in procs),
                  f"parallel (b): two ranks ran to the end in "
                  f"{time.time() - t0:.1f} s")
    if any(p.returncode for p in procs):
        return launches
    ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
             for r in range(2)]
    for r in ranks:
        for k in launches:
            launches[k] += int(r[f"total/{k}"])
    check_dp_ranks(checks, single, ranks, root, card, want,
                   worker.TRAIN_TOPK_ROWS)
    for name in PATH_KERNELS["parallel"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the parallel path: "
                      f"{launches[name]}")
    return launches


def check_dp_ranks(checks: Checks, single: dict, ranks: list, root: str,
                   card: str, want: dict, rows: int) -> None:
    """The parallel phase's (b): the two ranks' results of the data-parallel
    worker against its run in one process (``single``)."""
    import os

    import numpy as np

    r0, r1 = ranks
    losses, want_losses = r0["steps0.0/losses"], single["steps0.0/losses"]
    err = float(np.abs(losses - want_losses).max()) / float(
        np.abs(want_losses).max())
    checks.expect(err <= 1e-5 and np.array_equal(losses,
                                                 r1["steps0.0/losses"]),
                  f"parallel (b): gloo group of 2 on one card (64 rows a "
                  f"rank), {DP_STEPS} fp32 steps at dropout 0: losses "
                  f"{losses.tolist()} vs one process "
                  f"{want_losses.tolist()}, max difference over the "
                  f"largest {err:.3g} (tol 1e-5)")
    # the summed gradients of step 1, before AdamW, against one process's of
    # the same two 64-row blocks (GEMMs of the same shapes); against its
    # 128-row batch a ReLU gate at 0 may flip between the two GEMM shapes
    # (printed, not held)
    names = [k for k in single if k.startswith("blocks0.0/")]
    gerr, gleaf = leaf_err(r0, single, "grad0.0/", "blocks0.0/")
    whole, wleaf = leaf_err(r0, single, "grad0.0/", "grad0.0/")
    checks.expect(sorted(k for k in r0 if k.startswith("grad0.0/"))
                  == sorted("grad" + k[len("blocks"):] for k in names)
                  and gerr <= 1e-5 and all(
                      np.array_equal(r0[k], r1[k]) for k in r0
                      if k.startswith("grad0.0/")),
                  f"parallel (b): the summed step-1 gradients of the "
                  f"{len(names)} trainable leaves on both ranks against one "
                  f"process's of the same two row blocks: each leaf within "
                  f"{gerr:.3g} of its largest value ({gleaf}; tol 1e-5); "
                  f"against one process's whole batch {whole:.3g} ({wleaf})")
    trainable = {k[len("blocks0.0/"):] for k in names}
    pnames = [k[len("steps0.0/"):] for k in single
              if k.startswith("steps0.0/") and k != "steps0.0/losses"]
    largest = max(float(np.abs(single["steps0.0/" + n]).max())
                  for n in trainable)
    diffs = {n: np.abs(r0["steps0.0/" + n] - single["steps0.0/" + n])
             for n in pnames}
    perr = max(float(diffs[n].max()) for n in trainable)
    past = sum(int((diffs[n] > 1e-5 * largest).sum()) for n in trainable)
    total = sum(diffs[n].size for n in trainable)
    checks.expect(past <= total * 1e-5
                  and all(float(diffs[n].max()) == 0.0 for n in pnames
                          if n not in trainable)
                  and all(np.array_equal(r0["steps0.0/" + n],
                                         r1["steps0.0/" + n])
                          for n in pnames),
                  f"parallel (b): the {len(trainable)} trainable parameters "
                  f"({total:,} elements) after {DP_STEPS} steps: {past} "
                  f"elements past 1e-5 of the largest value {largest:.3g} "
                  f"(at most {int(total * 1e-5)}; max_abs_err {perr:.3g}); "
                  f"the {len(pnames) - len(trainable)} frozen ones equal; "
                  f"the ranks' replicas equal")
    per_rank = [{k[len("launches/"):]: int(v) for k, v in r.items()
                 if k.startswith("launches/")} for r in ranks]
    checks.expect(all(p == want for p in per_rank),
                  f"parallel (b): launches per step a rank {per_rank} "
                  f"(K1 6, K3 13)")
    B = 128
    single_ms = float(single["ms"])
    print(f"  parallel train step (B={B}, L=82, T=8, bf16, dropout 0.1): "
          f"one process {single_ms:.2f} ms ({1e3 * B / single_ms:.1f} "
          f"examples/s); two ranks on one card over gloo "
          + ", ".join(f"rank {i} {float(r['ms']):.2f} ms" for i, r in
                      enumerate(ranks))
          + f" ({1e3 * B / max(float(r['ms']) for r in ranks):.1f} "
          f"examples/s); the all_reduce of {total:,} fp32 gradients "
          f"{float(r0['all_reduce_ms']):.2f} ms alone, on {card}",
          flush=True)
    perf = [f for f in os.listdir(os.path.join(root, "single"))
            if f.endswith("performance.txt")]
    written = [os.path.exists(os.path.join(root, f"rank{r}", *perf[:1]))
               for r in range(2)]
    same_perf = len(perf) == 1 and written == [True, False]
    if same_perf:
        with open(os.path.join(root, "single", perf[0])) as a, open(
                os.path.join(root, "rank0", perf[0])) as b:
            same_perf = a.read() == b.read()
    overall = float(r0["test/overall"])
    checks.expect(same_perf and overall == float(single["test/overall"])
                  == float(r1["test/overall"]),
                  f"parallel (b): data-parallel test() of the cli "
                  f"checkpoint at fp32 in {float(r0['test/s']):.2f} s: "
                  f"{perf} written by rank 0 only ({written}), equal to one "
                  f"process's (overall {overall:.4f} vs "
                  f"{float(single['test/overall']):.4f})")
    cases = sorted({k.rsplit("/", 1)[0] for k in single
                    if k.startswith("topk") and k != "topk/launches"})
    bad = [c for c in cases if not all(
        np.array_equal(r[f"{c}/{x}"], single[f"{c}/{x}"])
        for r in ranks for x in "di")]
    k4 = [int(r["topk/launches"]) for r in ranks]
    checks.expect(not bad and len(cases) == 12 and k4 == [12, 12],
                  f"parallel (b): sharded_l2_topk over 2 ranks (K4 on each "
                  f"block, q (512, 1024) fp32, N = 1,230 and {rows:,}, "
                  f"k = 1 / 15 / 64, skip_first off and on): indices and "
                  f"distances identical to one K4 over the whole index in "
                  f"{len(cases) - len(bad)} of {len(cases)} cases {bad}; K4 "
                  f"launches in each rank's loop alone {k4} (12 a rank)")


# the model_parallel phase's bounds against one process (the parallel
# phase's, as a share of the elements: GEMMs of other shapes round
# otherwise, and a ReLU gate at 0 may flip)
MP_LOSS_TOL, MP_ELEMENT_TOL, MP_SHARE = 1e-5, 1e-5, 1e-4


def mp_single(worker, seed: int, dev) -> dict:
    """One process's side of the model_parallel phase on the card: for
    each T5 attention_impl of ``worker.CARD_PARALLEL``, the seeded
    weights' greedy ids where a tensor-parallel configuration decodes
    (``worker.decode_ids``), the step-1 gradients of the batch's M row
    blocks for each pipelined configuration's microbatch count M
    (``worker.block_grads``: the microbatches' GEMM shapes) and the ReLU
    gates their forwards set apart from the whole batch's
    (``worker.relu_flips``), the 3 fp32 compared steps
    (``worker.compared_steps``) and ms a timed bf16 step."""
    out = {}
    for impl in sorted({c[2] for c in worker.CARD_PARALLEL.values()}):
        exp = worker.train_experiment(seed, dev, True, impl=impl)
        batch = worker.first_batch(exp)
        decode = None
        if any(i == impl and worker.tp_decodes(par)
               for par, _, i, _, _ in worker.CARD_PARALLEL.values()):
            decode = worker.decode_ids(exp, batch)
        blocks = {(M or par.get("pipe", 1)): None
                  for par, _, i, counts, _ in worker.CARD_PARALLEL.values()
                  if i == impl and par.get("pipe", 1) > 1 for M in counts}
        flips = {M: worker.relu_flips(exp, batch, M) for M in blocks}
        for M in blocks:
            blocks[M] = worker.block_grads(exp, batch, M)
        out[impl] = worker.compared_steps(exp, batch, 0)
        out[impl].update(blocks=blocks, flips=flips, decode=decode)
        out[impl]["cfg"] = exp.model_cfg
        exp = worker.train_experiment(seed, dev, False, params=exp.params,
                                      impl=impl)
        out[impl]["ms"] = worker.timed_ms(exp, worker.first_batch(exp))
        del exp
        torch.cuda.empty_cache()
    return out


def past_share(pairs, scale=None):
    """(elements past ``MP_ELEMENT_TOL`` of the largest value, elements,
    the worst leaf's max difference over its largest, that leaf) of
    (name, got, want) numpy triples; ``scale`` one largest value for all,
    else each leaf's own."""
    past = total = 0
    worst = (0.0, "")
    for n, g, w in pairs:
        big = scale if scale is not None else float(np.abs(w).max())
        d = np.abs(g.astype(np.float64) - w)
        past += int((d > MP_ELEMENT_TOL * big).sum())
        total += d.size
        worst = max(worst, (float(d.max()) / max(big, 1e-30), n))
    return past, total, worst


def drive_model_parallel(checks: Checks, seed: int, dev, card: str,
                         root: str):
    """Tensor and pipeline parallelism on the one card: each configuration
    of ``worker.CARD_PARALLEL`` as gloo ranks against one process
    (module docstring, item 12). The phase's launches are this process's
    and the ranks'."""
    import os

    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh

    worker = dp_worker_module()
    cli_checkpoint(root, seed, dev)
    _build.reset_launch_counts()
    t0 = time.time()
    single = mp_single(worker, seed, dev)
    single_test = worker.card_test(root, dev)  # at fp32 and bf16
    launches = _build.launch_counts()
    print(f"  model_parallel: one process's references in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, (par, world, impl, counts, tests) in \
            worker.CARD_PARALLEL.items():
        t0 = time.time()
        fail = worker.finish(worker.spawn("train", root, world, par=name,
                                          seed=seed), 300)
        for f in fail:
            print(f, flush=True)
        checks.expect(not fail, f"model_parallel {name} {par}: {world} "
                      f"gloo ranks on one card ran to the end in "
                      f"{time.time() - t0:.1f} s")
        if fail:
            continue
        ranks = [dict(np.load(os.path.join(root, f"{name}_rank{r}.npz")))
                 for r in range(world)]
        for r in ranks:
            for k in launches:
                launches[k] += int(r.get(f"total/{k}", 0))
        check_mp_ranks(checks, name, par, ranks, single[impl], single_test,
                       counts, tests, card, pmesh)
    for kernel in PATH_KERNELS["model_parallel"]:
        checks.expect(launches[kernel] > 0, f"{kernel} launches in the "
                      f"model_parallel path: {launches[kernel]}")
    return launches


def check_mp_ranks(checks: Checks, name: str, par: dict, ranks: list,
                   single: dict, single_test: dict, counts, tests,
                   card: str, pmesh) -> None:
    """One configuration's ranks against one process (module docstring,
    item 12)."""
    n_pipe, n_model = par.get("pipe", 1), par.get("model", 1)
    cfg = single["cfg"]
    want_losses = single["losses"]
    what = f"model_parallel {name} {par}"

    per = {"encoder": cfg.t5.num_layers // n_pipe,
           "decoder": cfg.t5.num_decoder_layers // n_pipe}

    def global_name(local, stage):
        """A stage's block leaf under its one-process name."""
        m = re.fullmatch(r"t5\.(encoder|decoder)\.block\.(\d+)\.(.+)",
                         local)
        if m is None or n_pipe == 1:
            return local
        return (f"t5.{m[1]}.block.{stage * per[m[1]] + int(m[2])}."
                f"{m[3]}")

    def grad_pairs(tag, want):
        want = {n: torch.from_numpy(v) for n, v in want.items()}
        pairs, leaves = [], 0
        for rank, r in enumerate(ranks):
            mesh = pmesh.Mesh(1, n_pipe, n_model, rank=rank)
            cut = pmesh.shard_tensors(want, cfg.t5, mesh)
            pre = f"{tag}/grad/"
            pairs += [(global_name(k[len(pre):], mesh.stage), r[k],
                       cut[k[len(pre):]].numpy())
                      for k in r if k.startswith(pre)]
            leaves += len(cut)
        return pairs, leaves

    for M in counts:
        tag = f"m{M}"
        label = f"{what}" + (f", {M or n_pipe} microbatches"
                             if n_pipe > 1 else "")
        losses = [r[f"{tag}/losses"] for r in ranks]
        err = float(np.abs(losses[0] - want_losses).max()) / float(
            np.abs(want_losses).max())
        checks.expect(err <= MP_LOSS_TOL and all(
            np.array_equal(x, losses[0]) for x in losses),
            f"{label}: {DP_STEPS} fp32 steps at dropout 0: losses "
            f"{losses[0].tolist()} on every rank vs one process "
            f"{want_losses.tolist()}, max difference over the largest "
            f"{err:.3g} (tol {MP_LOSS_TOL:g})")
        # the pipelined step against one process's gradients of the same
        # M row blocks (the microbatches' GEMMs); against its whole batch,
        # where every GEMM has other row counts, printed
        blocks = single["blocks"].get(M or n_pipe) if n_pipe > 1 else None
        pairs, leaves = grad_pairs(tag, blocks or single["grad"])
        past, total, worst = past_share(pairs)
        against = (f"one process's of the same {M or n_pipe} row blocks"
                   if blocks else "one process's")
        line = (f"{label}: each rank's step-1 gradients ({total:,} elements "
                f"over the ranks) against {against} cut to its pieces: "
                f"{past} past {MP_ELEMENT_TOL:g} of the leaf's largest value "
                f"(at most {int(MP_SHARE * total)}); worst leaf {worst[1]} "
                f"{worst[0]:.3g}")
        if blocks:
            whole = past_share(grad_pairs(tag, single["grad"])[0])
            flips = single["flips"][M or n_pipe]
            leaf = whole[2][1]
            line += (f"; against its whole batch {whole[0]} past, worst "
                     f"{leaf} {whole[2][0]:.3g}; ReLU gates that the "
                     f"whole-batch and {M or n_pipe}-block fp32 forwards "
                     f"set apart: {sum(f for f, _ in flips.values())} of "
                     f"{sum(n for _, n in flips.values()):,} over every "
                     "ff.wi")
            if leaf in flips:
                line += f", {flips[leaf][0]} of {flips[leaf][1]:,} in {leaf}"
        checks.expect(past <= MP_SHARE * total and len(pairs) == leaves,
                      line)
        pre = f"{tag}/params/"
        names = [k[len(pre):] for k in ranks[0] if k.startswith(pre)]
        trainable = [n for n in names if n in single["grad"]]
        largest = max(float(np.abs(single["params"][n]).max())
                      for n in trainable)
        past, total, worst = past_share(
            [(n, ranks[0][pre + n], single["params"][n]) for n in trainable],
            largest)
        checks.expect(past <= MP_SHARE * total
                      and bool(ranks[0][f"{tag}/frozen_same"]),
                      f"{label}: the {len(trainable)} trainable parameters "
                      f"after {DP_STEPS} steps, gathered ({total:,} "
                      f"elements): {past} past {MP_ELEMENT_TOL:g} of the "
                      f"largest value {largest:.3g} (at most "
                      f"{int(MP_SHARE * total)}; worst {worst[1]} "
                      f"{worst[0]:.3g}); the frozen towers unchanged")
        per_rank = [{k[len(f"{tag}/launches/"):]: int(v)
                     for k, v in r.items()
                     if k.startswith(f"{tag}/launches/")} for r in ranks]
        want = ({"row_attention_packed": 6, "fused_rms_norm": 13}
                if n_pipe == 1 else
                {"flash_attention": 9 * (M or n_pipe)})
        checks.expect(all(p == want for p in per_rank),
                      f"{label}: launches a step a rank {per_rank} "
                      f"(want {want}; one process "
                      f"{single['launches']})")
    B = 128
    ms = [float(r["ms"]) for r in ranks]
    coll = {k: max(float(r[k]) for r in ranks if k in r)
            for k in ("model_all_reduce_ms", "hop_ms", "pipe_all_reduce_ms")
            if k in ranks[0]}
    print(f"  {what} train step (B={B}, L=82, T=8, bf16, dropout 0.1): "
          + ", ".join(f"rank {i} {x:.2f} ms" for i, x in enumerate(ms))
          + f" ({1e3 * B / max(ms):.1f} examples/s); one process "
          f"{single['ms']:.2f} ms ({1e3 * B / single['ms']:.1f} "
          f"examples/s); collectives alone "
          + ", ".join(f"{k} {v:.2f}" for k, v in coll.items())
          + f"; on {card}", flush=True)
    if "decode/ids" in ranks[0]:
        check_tp_decode(checks, what, cfg, ranks, single["decode"])
    if not tests:
        return
    for dtype in ("float32", "bfloat16"):
        got = [json.loads(str(r[f"test_{dtype}/answers"])) for r in ranks]
        want = json.loads(str(single_test[f"test_{dtype}/answers"]))
        differ = sum(a != b for a, b in zip(got[0], want))
        k7 = [int(r.get(f"test_{dtype}/launches/decode_attention_fused", 0))
              for r in ranks]
        line = (f"{what}: test() of the cli checkpoint at {dtype} "
                f"({float(ranks[0][f'test_{dtype}/s']):.2f} s): "
                f"{differ} of {len(want)} answers differ from one "
                f"process's, the ranks' answers "
                f"{'equal' if all(g == got[0] for g in got) else 'differ'};"
                f" K7 launches a rank {k7}")
        if dtype == "float32":
            checks.expect(differ == 0 and len(got[0]) == len(want)
                          and all(g == got[0] for g in got)
                          and all(k > 0 for k in k7), line)
        else:
            print(f"  {line}", flush=True)


def check_tp_decode(checks: Checks, what: str, cfg, ranks: list,
                    want: np.ndarray) -> None:
    """The ranks' tensor-parallel greedy ids of the first train batch
    (seeded weights, fp32, 20 steps, ``early_stop`` off) against one
    process's: equal on every rank, some rows past the first step, K7
    launched on each rank."""
    got = [r["decode/ids"] for r in ranks]
    eos = cfg.t5.eos_token_id
    steps = want[:, 1:]
    ended = np.cumsum(steps == eos, axis=1) - (steps == eos)
    compared = int((ended == 0).sum())  # each row's tokens to its EOS
    past = int((steps[:, 0] != eos).sum())
    differ = int((got[0] != want).sum())
    same = all(np.array_equal(g, got[0]) for g in got)
    k7 = [int(r["decode/launches"]) for r in ranks]
    checks.expect(
        differ == 0 and got[0].shape == want.shape and same and past > 0
        and all(k > 0 for k in k7),
        f"{what}: greedy decode of the first train batch (seeded weights, "
        f"fp32, 20 steps, early_stop off): {differ} of {want.size} ids "
        f"differ from one process's ({compared:,} tokens up to each row's "
        f"EOS; {past} of {want.shape[0]} rows past the first step), the "
        f"ranks' ids {'equal' if same else 'differ'}; K7 launches a rank "
        f"{k7}")


def cli_checkpoint(root: str, seed: int, dev) -> dict:
    """The cli phase's dataset and trained checkpoint under ``root``, made
    when a phase that reads them runs without the cli phase; returns
    {"logs": ..., "models": ...}."""
    import os

    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        run_from_config,
    )

    cfg_path, dirs = cli_workspace(root, seed, dev)
    if not (os.path.isdir(dirs["models"]) and any(
            f.endswith(".npz") for f in os.listdir(dirs["models"]))):
        run_from_config(cfg_path, train=True, device=dev, quiet=True,
                        log_root=dirs["logs"], model_root=dirs["models"])
    return dirs


def run_ranks(checks: Checks, what: str, worker, root: str, par: str,
              seed: int):
    """Two gloo ranks of ``--load train --par PAR`` on the one card: their
    results, or None (the failure printed and counted)."""
    import os

    t0 = time.time()
    fail = worker.finish(worker.spawn("train", root, 2, par=par, seed=seed),
                         400)
    for f in fail:
        print(f, flush=True)
    checks.expect(not fail, f"{what}: 2 gloo ranks on one card ran to the "
                  f"end in {time.time() - t0:.1f} s")
    if fail:
        return None
    return [dict(np.load(os.path.join(root, f"{par}_rank{r}.npz")))
            for r in range(2)]


def drive_seq_parallel(checks: Checks, seed: int, dev, card: str,
                       root: str):
    """Sequence parallelism on the one card (module docstring, item 13):
    the ranks first, then one process's references, among them its
    gradients with the ranks' ReLU gates. The phase's launches are this
    process's and the ranks'."""
    from multimodalpromptretrieval_tpu_torch.ops import _build

    worker = dp_worker_module()
    t_phase = time.time()
    cli_checkpoint(root, seed, dev)
    ranks = run_ranks(checks, f"seq_parallel {worker.CARD_SEQ}", worker,
                      root, "sp", seed)
    _build.reset_launch_counts()
    t0 = time.time()
    exp = worker.train_experiment(seed, dev, True)
    encode = worker.encode_reference(exp, dev)
    batch = worker.first_batch(exp)
    gates = worker.relu_gates(exp, batch)
    single = {}
    if ranks is not None:
        forced = {n: torch.from_numpy(g).to(dev)
                  for n, g in sp_gates(ranks, gates).items()}
        with worker.forced_gates(exp, forced) as seen:
            single["forced"] = worker.block_grads(exp, batch, 1)
        single["flips"] = seen
        single["gates"] = sum(g.numel() for g in forced.values())
        del forced
    single.update(worker.compared_steps(exp, batch, 0))
    exp = worker.train_experiment(seed, dev, False, params=exp.params)
    single["ms"] = worker.timed_ms(exp, worker.first_batch(exp))
    del exp, batch
    torch.cuda.empty_cache()
    single.update(worker.card_test(root, dev, dtypes=("float32",)))
    launches = _build.launch_counts()
    print(f"  seq_parallel: one process's references in "
          f"{time.time() - t0:.1f} s", flush=True)
    if ranks is not None:
        for r in ranks:
            for k in launches:
                launches[k] += int(r.get(f"total/{k}", 0))
        check_sp_ranks(checks, single, encode, ranks, card)
    for kernel in PATH_KERNELS["seq_parallel"]:
        checks.expect(launches[kernel] > 0, f"{kernel} launches in the "
                      f"seq_parallel path: {launches[kernel]}")
    print(f"  seq_parallel phase: {time.time() - t_phase:.1f} s",
          flush=True)
    return launches


def sp_gates(ranks: list, single: dict) -> dict:
    """The ReLU gates of every T5 ``ff.wi`` in the ranks' SP forward over
    the whole batch, by weight name, as bools: the encoder's from each seq
    rank's chunk in order (cut to the length of ``single``, one process's
    packed gates), the decoder's rank 0's."""
    out = {}
    for n, packed in single.items():
        if ".encoder." in n:
            got = np.concatenate([np.unpackbits(r["gates/" + n], axis=-1)
                                  for r in ranks], axis=1)
            out[n] = got[:, :packed.shape[1]].astype(bool)
        else:
            out[n] = np.unpackbits(ranks[0]["gates/" + n],
                                   axis=-1).astype(bool)
    return out


def check_sp_ranks(checks: Checks, single: dict, encode: np.ndarray,
                   ranks: list, card: str) -> None:
    """The seq_parallel ranks against one process (module docstring, item
    13)."""
    what = "seq_parallel {'seq': 2}"
    got = ranks[0]["encode"]
    err = float(np.abs(got - encode).max())
    excess = float((np.abs(got - encode) - 2e-5 * np.abs(encode)).max())
    checks.expect(got.shape == encode.shape and excess <= 2e-5,
                  f"{what}: sp_t5_encode of t5-small, B = 2, L = 4,096, "
                  f"fp32 (the position bias per ring tile) in "
                  f"{float(ranks[0]['encode_s']):.2f} s against one "
                  f"process's t5_encode under \"xla\": max_abs_err "
                  f"{err:.3g}, max over the elements of the error past "
                  f"2e-5 of the value {excess:.3g} (tol 2e-5)")
    losses = [r["losses"] for r in ranks]
    want = single["losses"]
    lerr = float(np.abs(losses[0] - want).max()) / float(np.abs(want).max())
    checks.expect(lerr <= MP_LOSS_TOL and all(
        np.array_equal(x, losses[0]) for x in losses),
        f"{what}: {DP_STEPS} fp32 steps at dropout 0: losses "
        f"{losses[0].tolist()} on both ranks vs one process "
        f"{want.tolist()}, max difference over the largest {lerr:.3g} "
        f"(tol {MP_LOSS_TOL:g})")
    # the gradients against one process's with the SP forward's ReLU
    # gates (the gates that the two fp32 forwards set apart turn a whole
    # row of a leaf's gradient), each leaf at its own largest value; against
    # one process's own gates, printed beside
    pairs = [(k[5:], r[k], single["grad"][k[5:]]) for r in ranks
             for k in r if k.startswith("grad/")]
    forced = [(n, g, single["forced"][n]) for n, g, _ in pairs
              if n in single["forced"]]
    past, total, worst = past_share(forced)
    own = past_share(pairs)
    flips = {n: v for n, v in single["flips"].items() if v[0]}
    apart = sum(v[0] for v in flips.values())
    left = sum(v[1] for v in single["flips"].values())
    checks.expect(past <= MP_SHARE * total and len(forced) == len(pairs)
                  and len(pairs) == 2 * len(single["grad"]),
                  f"{what}: each rank's step-1 gradients (summed over "
                  f"\"seq\"; {total:,} elements over the ranks) against one "
                  f"process's with the SP forward's ReLU gates ({apart} of "
                  f"{single['gates']:,} set apart over every ff.wi, "
                  f"{left} left apart: {flips}): {past} past "
                  f"{MP_ELEMENT_TOL:g} of the leaf's largest value (at most "
                  f"{int(MP_SHARE * total)}); worst leaf {worst[1]} "
                  f"{worst[0]:.3g}; against one process's own gates "
                  f"{own[0]} past, worst {own[2][1]} {own[2][0]:.3g}")
    names = [k[7:] for k in ranks[0] if k.startswith("params/")]
    largest = max(float(np.abs(single["params"][n]).max()) for n in names)
    past, total, worst = past_share(
        [(n, ranks[0]["params/" + n], single["params"][n]) for n in names],
        largest)
    checks.expect(past <= MP_SHARE * total and all(
        bool(r["frozen_same"]) for r in ranks),
        f"{what}: the {len(names)} trainable parameters after {DP_STEPS} "
        f"steps ({total:,} elements): {past} past {MP_ELEMENT_TOL:g} of "
        f"the largest value {largest:.3g} (at most "
        f"{int(MP_SHARE * total)}; worst {worst[1]} {worst[0]:.3g}); the "
        f"frozen towers unchanged on both ranks")
    per_rank = [{k[len("launches/"):]: int(v) for k, v in r.items()
                 if k.startswith("launches/")} for r in ranks]
    checks.expect(per_rank == [{}, {}],
                  f"{what}: kernel launches a step a rank {per_rank} (none: "
                  f"the ring encoder and its RMSNorm are plain torch, the "
                  f"decoder attention_xla; one process "
                  f"{single['launches']})")
    B = 128
    ms = [float(r["ms"]) for r in ranks]
    print(f"  {what} train step (B={B}, L=82, T=8, bf16, dropout 0.1): "
          + ", ".join(f"rank {i} {x:.2f} ms" for i, x in enumerate(ms))
          + f" ({1e3 * B / max(ms):.1f} examples/s); one process "
          f"{single['ms']:.2f} ms ({1e3 * B / single['ms']:.1f} "
          f"examples/s); alone: a ring hop (one layer's bf16 K, V and key "
          f"mask) {max(float(r['hop_ms']) for r in ranks):.2f} ms, the "
          f"gradient all_reduce "
          f"{max(float(r['grad_all_reduce_ms']) for r in ranks):.2f} ms; on "
          f"{card}", flush=True)
    got = [json.loads(str(r["test_float32/answers"])) for r in ranks]
    want = json.loads(str(single["test_float32/answers"]))
    differ = sum(a != b for a, b in zip(got[0], want))
    k7 = [int(r.get("test_float32/launches/decode_attention_fused", 0))
          for r in ranks]
    checks.expect(differ == 0 and len(got[0]) == len(want)
                  and all(g == got[0] for g in got) and all(k > 0 for k in k7),
                  f"{what}: test() of the cli checkpoint at fp32 "
                  f"({float(ranks[0]['test_float32/s']):.2f} s): {differ} of "
                  f"{len(want)} answers differ from one process's, the ranks' "
                  f"answers {'equal' if all(g == got[0] for g in got) else 'differ'}; "
                  f"K7 launches a rank {k7}")


def drive_sharded_serve(checks: Checks, seed: int, dev, card: str,
                        root: str):
    """The data-sharded server on the one card (module docstring, item
    14). The phase's launches are the timed windows' (this process's and
    the ranks')."""
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.serving import north_star_setup

    worker = dp_worker_module()
    t_phase = time.time()
    exp, tests, images = north_star_setup(seed, dev, path="main")
    single = worker.serve_run(exp, tests, images, dev, 4)
    del exp
    torch.cuda.empty_cache()
    launches = {k: int(single.get(f"launches/{k}", 0))
                for k in _build.launch_counts()}
    print(f"  sharded_serve: one process in {time.time() - t_phase:.1f} s",
          flush=True)
    what = "sharded_serve {'data': 2}"
    ranks = run_ranks(checks, what, worker, root, "serve", seed)
    if ranks is not None:
        for r in ranks:
            for k in launches:
                launches[k] += int(r.get(f"launches/{k}", 0))
        check_serve_ranks(checks, single, ranks, card, len(tests))
    for kernel in PATH_KERNELS["sharded_serve"]:
        checks.expect(launches[kernel] > 0, f"{kernel} launches in the "
                      f"sharded_serve path: {launches[kernel]}")
    print(f"  sharded_serve phase: {time.time() - t_phase:.1f} s",
          flush=True)
    return launches


def check_serve_ranks(checks: Checks, single: dict, ranks: list, card: str,
                      n: int) -> None:
    """The sharded_serve ranks against one process (module docstring, item
    14)."""
    what = "sharded_serve {'data': 2}"
    answers = [json.loads(str(r["answers"])) for r in ranks]
    want = json.loads(str(single["answers"]))
    chunks = [json.loads(str(r["chunks"])) for r in ranks]
    checks.expect(all(len(a) == n and a == answers[0] for a in answers)
                  and all(c == {"fused": 3, "host": 0} for c in chunks),
                  f"{what}: every rank returns all {n} answers, equal on the "
                  f"ranks; chunks a rank {chunks} (3 fused)")
    rows = [sorted(set(r["rows"].tolist())) for r in ranks]
    tables = [sorted(set(r["table_rows"].tolist())) for r in ranks]
    small = [sorted(set(r["small_rows"].tolist())) for r in ranks]
    checks.expect(all(x == [256] for x in rows + tables)
                  and all(x == [4] for x in small)
                  and sorted(set(single["rows"].tolist())) == [512],
                  f"{what}: rows each rank ran a chunk {rows} and a staged "
                  f"table block {tables} (256 of 512), of the small input "
                  f"{small} (4 of 8); one process "
                  f"{sorted(set(single['rows'].tolist()))}")
    differ = sum(a != b for a, b in zip(answers[0], want))
    per_rank = [{k: int(r.get(f"launches/{k}", 0))
                 for k in PATH_KERNELS["sharded_serve"]} for r in ranks]
    checks.expect(all(all(v > 0 for v in p.values()) for p in per_rank),
                  f"{what}: K1-K4 and K7 launched on each rank in the timed "
                  f"window: {per_rank}; one process "
                  f"{ {k: int(single.get(f'launches/{k}', 0)) for k in PATH_KERNELS['sharded_serve']} }")
    seconds = max(float(r["window_s"]) for r in ranks)
    print(f"  {what} (bf16, B=512, 256 rows a rank, 512 staged images, "
          f"{n} questions in 2 submits, k=1): two ranks "
          f"{n / seconds:.1f} QA/s ("
          + ", ".join(f"rank {i} {float(r['window_s']):.3f} s"
                      for i, r in enumerate(ranks))
          + f"), one process {n / float(single['window_s']):.1f} QA/s "
          f"({float(single['window_s']):.3f} s); {differ} of {n} bf16 "
          f"answers differ from one process's; alone: the staging gather "
          f"(a rank's 256 rows of both tables, bits) "
          f"{max(float(r['stage_gather_ms']) for r in ranks):.2f} ms, a "
          f"chunk's token gather "
          f"{max(float(r['token_gather_ms']) for r in ranks):.2f} ms; on "
          f"{card}", flush=True)
    ids = [r["small_ids"] for r in ranks]
    same = all(np.array_equal(x, single["small_ids"]) for x in ids)
    steps = single["small_ids"][:, 1:]
    past = int((steps[:, 0] != 1).sum())
    checks.expect(same and ids[0].shape == (8, 21) and past > 0,
                  f"{what}: 8 requests at fp32 (B=8, 4 rows a rank): greedy "
                  f"ids {ids[0].shape} identical on both ranks to one "
                  f"process's at B=4 (the same row blocks): {same}; "
                  f"{past} of 8 rows past the first step")


# the t5_large phase's servers (the JAX bench.py t5_large stage's fp, int8
# and spec4 cells), and the timed windows of each on the seeded weights,
# whose chunks decode their 20 steps (the one-epoch checkpoint answers EOS
# at the first step: its servers run one window each, as a proof that it
# loads and serves)
T5_LARGE_MODES = (("fp", {}), ("int8", dict(quantize="int8")),
                  ("spec_decode=4", dict(spec_decode=4)))
T5_LARGE_WINDOWS = 3


def drive_t5_large(checks: Checks, seed: int, dev, card: str, root: str):
    """t5-large + CLIP ViT-B/32 at full width (the JAX ``bench.py``
    ``t5_large`` stage): one epoch of the trainer, then the servers of its
    checkpoint (:func:`train_t5_large`, :func:`serve_t5_large`). Launch
    counts are set to 0 before the path and read after it; then the card
    against the CPU at fp32 (:func:`check_small_t5_large`,
    :func:`check_small_t5_large_step`)."""
    import gc
    import os

    from multimodalpromptretrieval_tpu_torch.ops import _build

    models = os.path.join(root, "t5_large_models")
    _build.reset_launch_counts()
    trained = train_t5_large(checks, seed, dev, card, models, root)
    gc.collect()
    torch.cuda.empty_cache()
    exp, tests, images = serve_t5_large(checks, seed, dev, card, models,
                                        trained)
    launches = _build.launch_counts()
    for name in PATH_KERNELS["t5_large"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the t5_large path: "
                      f"{launches[name]}")
    check_small_t5_large(checks, exp, tests, images)
    del exp
    gc.collect()
    torch.cuda.empty_cache()
    check_small_t5_large_step(checks, seed, dev)
    return launches


def train_t5_large(checks: Checks, seed: int, dev, card: str, models: str,
                   root: str) -> dict:
    """``TrainingExperiment.train()`` of ``north_star_t5_large_train_setup``
    (B = 64, remat, bf16 AdamW moments, the "xla" T5, dropout 0.1): one
    epoch of the 1,230 entries, then the parameters-only checkpoint under
    ``models``. Each step's device time comes from CUDA events recorded
    between the steps (the loop itself is not synced); the first two steps
    are printed apart. Returns CPU copies of two trained leaves."""
    import os

    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        north_star_t5_large_train_setup,
    )

    t0 = time.time()
    exp = north_star_t5_large_train_setup(
        seed, dev, model_root=models, quiet=True,
        log_root=os.path.join(root, "t5_large_logs"))
    torch.cuda.synchronize()
    cfg, t5 = exp.model_cfg, exp.model_cfg.t5
    named = dict(exp.params.named_parameters())
    n_all = sum(p.numel() for p in named.values())
    n_trained = sum(p.numel() for n, p in named.items() if exp.trainable[n])
    moments = {m.dtype for m in exp.opt_state["mu"].values()}
    checks.expect(
        (t5.d_model, t5.d_ff, t5.num_layers, t5.num_decoder_layers,
         t5.num_heads, t5.d_kv, t5.vocab_size) == (1024, 4096, 24, 24, 16,
                                                   64, 32128)
        and (cfg.clip.embed_dim, cfg.clip.image_resolution) == (512, 224)
        and cfg.needs_projection and t5.remat and t5.attention_impl == "xla"
        and exp.batch_size == 64 and moments == {torch.bfloat16},
        f"t5_large trainer in {time.time() - t0:.1f} s: t5-large (d_model "
        f"{t5.d_model}, d_ff {t5.d_ff}, {t5.num_layers} + "
        f"{t5.num_decoder_layers} layers, {t5.num_heads} heads, vocab "
        f"{t5.vocab_size}) + ViT-B/32 ({cfg.clip.image_resolution} px, "
        f"embed {cfg.clip.embed_dim} -> projection {cfg.needs_projection}), "
        f"{n_all:,} parameters ({n_trained:,} trained), remat {t5.remat}, "
        f"T5 {t5.attention_impl!r}, moments {sorted(map(str, moments))}, "
        f"compute {cfg.compute_dtype}, dropout {t5.dropout_rate}, B="
        f"{exp.batch_size}, a {len(exp.retrieval_index)}-entry index")

    step = exp.train_step()
    events, losses, counts = [], [], []

    def timed(*args):
        if not events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        before = _build.launch_counts()
        losses.append(step(*args))
        counts.append({k: v - before[k] for k, v in
                       _build.launch_counts().items() if v != before[k]})
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return losses[-1]

    exp._train_step = timed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = exp.train()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = torch.stack(losses).float().cpu().tolist()
    n, B = len(losses), exp.batch_size
    checks.expect(n == res["parameter_updates"] == -(-1230 // B)
                  and all(math.isfinite(x) for x in losses),
                  f"t5_large train: {n} steps of B={B}, losses finite: "
                  f"first {losses[0]:.4f}, last {losses[-1]:.4f}, "
                  f"validation {res['best_valid_loss']:.4f}")
    checks.expect(all(not c for c in counts),
                  f"t5_large train: the steps launch no kernel ({counts[0]}:"
                  " the \"xla\" T5, as the JAX trainer's, on the ViT's "
                  "token table)")
    rest = ms[2:]
    mean = sum(rest) / len(rest)
    print(f"  t5_large train: steps 1, 2: {ms[0]:.2f}, {ms[1]:.2f} ms; "
          f"steps 3-{n}: {mean:.2f} ms a step (min {min(rest):.2f}, max "
          f"{max(rest):.2f}), {B * 1e3 / mean:.1f} examples/s; the epoch "
          f"{epoch_s:.1f} s with hints, table, validation and checkpoint; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB on {card}",
          flush=True)

    path = exp.model_path
    size = os.path.getsize(path)
    with np.load(path) as z:
        keys = z.files
    opt = [k for k in keys if k.startswith("opt/") or k == "__elided_opt__"]
    n_params = sum(k.startswith("params/") for k in keys)
    # fp32 parameters alone: the bf16 moments would add 4 bytes for each
    # trained element
    checks.expect(os.path.exists(path + ".json") and not opt
                  and 4 * n_all <= size < 4 * n_all + 2 ** 20,
                  f"t5_large checkpoint {os.path.basename(path)}: "
                  f"{size:,} bytes ({4 * n_all:,} of fp32 parameters), "
                  f"{n_params} parameter arrays, {len(opt)} optimizer "
                  "arrays")
    trained = {n: named[n].detach().cpu().clone() for n in (
        "proj.weight", f"t5.encoder.block.{t5.num_layers - 1}.ff.wo.weight")}
    del exp, step, named
    return trained


def serve_t5_large(checks: Checks, seed: int, dev, card: str, models: str,
                   trained: dict):
    """``north_star_t5_large_setup`` (seeded random weights) with
    ``model_root=models``. The first server loads the trained checkpoint
    (``load_checkpoint=True``; the trained leaves bit-identical), the others
    serve the loaded parameters: each of :data:`T5_LARGE_MODES` over a
    warm-up and one timed window (the checkpoint answers EOS at the first
    step). Then the same modes over a warm-up and :data:`T5_LARGE_WINDOWS`
    timed windows each on the seeded weights with the unused embedding rows
    zeroed (:func:`zero_unused_rows`): random weights never emit EOS, so
    every chunk decodes its 20 steps and the answers carry text; these are
    the phase's serving rates. Returns (the experiment on those seeded
    weights, test entries, images)."""
    from multimodalpromptretrieval_tpu_torch.serving import (
        north_star_t5_large_setup,
    )

    t0 = time.time()
    exp, tests, images = north_star_t5_large_setup(seed, dev,
                                                   model_root=models)
    torch.cuda.synchronize()
    mcfg = exp.model_cfg
    print(f"t5_large serve setup: data, random weights and a "
          f"{len(exp.retrieval_index)}-entry index in {time.time() - t0:.1f}"
          f" s; {mcfg.compute_dtype}, T5 / CLIP attention_impl="
          f"{mcfg.t5.attention_impl!r} / {mcfg.clip.attention_impl!r}, "
          f"decode {mcfg.t5.decode_attention_impl!r}, B={exp.batch_size}",
          flush=True)
    seeded = copy.deepcopy(exp.params)
    zero_unused_rows(seeded, len(exp.tokenizer))
    for weights, windows in (("checkpoint", 1),
                             ("seeded", T5_LARGE_WINDOWS)):
        if weights == "seeded":
            exp.params = seeded
        want = None
        for name, options in T5_LARGE_MODES:
            load = weights == "checkpoint" and want is None
            answers = serve_t5_large_mode(
                checks, exp, tests, images, f"{weights} {name}", options,
                windows, card, trained if load else None)
            want = answers if want is None else want
            differ = sum(a != b for a, b in zip(answers, want))
            print(f"  t5_large {weights} {name}: {differ} of {len(tests)} "
                  f"answers differ from fp's; "
                  f"{np.mean([bool(a) for a in answers]):.4f} non-empty, "
                  f"first {answers[0]!r}", flush=True)
    return exp, tests, images


def serve_t5_large_mode(checks: Checks, exp, tests, images, name: str,
                        options: dict, windows: int, card: str,
                        trained=None):
    """One server of the t5_large phase (``trained``: it loads the
    checkpoint, whose ``trained`` leaves it checks): a warm-up window, then
    ``windows`` timed ones, each with its chunks, decode steps and launches
    checked; prints QA/s. Returns the last window's answers."""
    from multimodalpromptretrieval_tpu_torch import serve
    from multimodalpromptretrieval_tpu_torch.ops import _build

    n, B = len(tests), exp.batch_size
    n_chunks = -(-2 * B // B) + -(-(n - 2 * B) // B)
    layers = exp.model_cfg.t5.num_decoder_layers
    t0 = time.perf_counter()
    server = serve.MPRServer(exp, load_checkpoint=trained is not None,
                             **options)
    if trained is not None:
        got = dict(exp.params.named_parameters())
        same = all(torch.equal(got[k].cpu(), v) for k, v in trained.items())
        checks.expect(same, f"t5_large server: {exp.model_path} loaded in "
                      f"{time.perf_counter() - t0:.1f} s, the trained "
                      f"{', '.join(trained)} bit-identical")
    window = window_of(server, tests, images)
    widths, text = set(), set()
    step = serve.fused_serve_step

    def seen(params, cfg, batch, *args, **kw):
        widths.add(batch["prefix"].shape[1] + batch["q_ids"].shape[1])
        text.add(batch["clip_text_ids"].shape[1])
        return step(params, cfg, batch, *args, **kw)

    serve.fused_serve_step = seen
    try:
        first = window()  # warm-up
    finally:
        serve.fused_serve_step = step
    rates, runs = [], []
    for _ in range(windows):
        server.chunks = {"fused": 0, "host": 0}
        server.decode_steps = 0
        before = _build.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = window()
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
        runs.append((dict(server.chunks), server.decode_steps, {
            k: v - before[k] for k, v in _build.launch_counts().items()
            if v != before[k]}))
    checks.expect(len(answers) == n and widths == {T5_LARGE_L_ENC}
                  and text == {T5_LARGE_L_TEXT}
                  and all(c == {"fused": n_chunks, "host": 0}
                          for c, _, _ in runs),
                  f"t5_large {name}: {len(answers)} answers, encoder length "
                  f"{sorted(widths)}, text tower length {sorted(text)}, "
                  f"chunks a window "
                  f"{[c for c, _, _ in runs]}; the windows' answers the "
                  f"warm-up's: {answers == first}")
    for _, steps, counts in runs:
        # the verification pass's attention is the plain block attention,
        # as in the JAX package: no K7 under spec decode
        k7 = 0 if options.get("spec_decode") else 2 * layers * steps
        checks.expect(all(counts.get(k, 0) > 0
                          for k in PATH_KERNELS["t5_large"][:4])
                      and counts.get("decode_attention_fused", 0) == k7,
                      f"t5_large {name}: {steps} decode steps a window over "
                      f"{n_chunks} chunks, launches {counts} (K7 {k7} = 2 x "
                      f"{layers} layers x steps, or 0 under spec decode)")
    print(f"  t5_large {name}: QA/s median {np.median(rates):.1f}, min "
          f"{min(rates):.1f}, max {max(rates):.1f} over {windows} "
          f"window(s) (staging + 2 submits, bf16, B={B}, k=1) on {card}",
          flush=True)
    return answers


def check_small_t5_large(checks: Checks, exp, tests, images) -> None:
    """The card (kernels) against the CPU (plain versions) at fp32, full
    width and depth, on the seeded weights of :func:`serve_t5_large` (20
    decode steps), 4 requests (prompts without hints, the fp32 ViT prefix
    of each side): the lockstep
    greedy ids, the int8 T5 blocks' ids from the card's prefix on both
    sides, and the spec decode's (S = 4) with the lockstep ids as drafts,
    diverging after 4 tokens on every other row: identical on card and CPU,
    and the spec decode's ids the lockstep ones."""
    from multimodalpromptretrieval_tpu_torch.models import mprgen
    from multimodalpromptretrieval_tpu_torch.ops import quant
    from multimodalpromptretrieval_tpu_torch.serve import (
        image_embed_prefix_step,
        steps_run,
    )

    cfg = dataclasses.replace(exp.model_cfg, compute_dtype="float32")
    entries = tests[:4]
    imgs = torch.from_numpy(np.stack([images[e["image_name"]]
                                      for e in entries]))
    rows, lens = exp.tokenizer.encode_rows(
        [f"Answer the {e['task']} question: " + e["question"]
         for e in entries])
    ids = torch.from_numpy(rows)
    mask = (torch.arange(ids.shape[1])[None, :]
            < torch.from_numpy(lens)[:, None]).to(torch.int32)
    t0 = time.time()
    cpu_params = copy.deepcopy(exp.params).cpu()
    with torch.inference_mode():
        _, card_pref = image_embed_prefix_step(exp.params, cfg,
                                               imgs.to(exp.device))
    outs = {}
    for where, params in (("card", exp.params), ("cpu", cpu_params)):
        dev = params.t5.shared.device
        q8 = quant.quantize_params(params, t5=True)
        with torch.inference_mode():
            _, pref = image_embed_prefix_step(params, cfg, imgs.to(dev))
            lock = mprgen.generative_predict_from_prefix(
                params, cfg, pref, ids.to(dev), mask.to(dev))
            int8 = mprgen.generative_predict_from_prefix(
                q8, cfg, card_pref.to(dev), ids.to(dev), mask.to(dev))
            drafts = lock[:, 1:].clone()
            drafts[::2, 4:] = 5
            spec = mprgen.generative_predict_from_prefix(
                params, cfg, pref, ids.to(dev), mask.to(dev),
                draft_ids=drafts, spec_block=4)
        outs[where] = [x.cpu() for x in (lock, int8, spec)]
        del q8
    for i, mode in enumerate(("fp", "int8", "spec_decode=4")):
        a, b = outs["card"][i], outs["cpu"][i]
        checks.expect(torch.equal(a, b),
                      f"t5_large small input at fp32, {mode}: greedy ids "
                      f"{tuple(a.shape)} identical on card and cpu "
                      f"({steps_run(a.numpy(), cfg.t5.eos_token_id)} steps)")
    checks.expect(torch.equal(outs["card"][2], outs["card"][0]),
                  "t5_large small input at fp32: spec decode ids identical "
                  f"to lockstep on the card ({time.time() - t0:.1f} s with "
                  "the CPU's)")


def check_small_t5_large_step(checks: Checks, seed: int, dev) -> None:
    """Three fp32 train steps at t5-large's width with 2 + 2 layers under
    the trainer overrides (remat, bf16 AdamW moments, the "xla" T5) and the
    full ViT-B/32, dropout 0, lr 1e-3, from identical seeded parameters on
    the card (kernels in the set-up) and on the CPU (plain versions), over
    the three batches of 8 open-corpus images' epoch 0. The CPU's T5 takes
    the card's ReLU gates, forward by forward (``worker.forced_gates``; the
    gates the two set apart are counted). Held: the losses within 1e-4 of
    the largest (and of 1); the step-1 gradients within 1e-4 of each leaf's
    largest value; the parameters after within 1e-4 of the largest (and of
    1), every element but those whose gradient is noise at some step: the
    two sides' values differ by more than a hundredth of the larger. The
    gradients are held against their leaf's largest value, but AdamW
    divides each element's moment by its own RMS: its update lr * m /
    (sqrt(v) + 1e-8) is as uncertain as that element's gradient is
    relative to itself, and an element whose gradient is rounding noise
    near 0 moves by up to lr on one side and not the other (two summation
    orders on one CPU, 1 and 6 threads, leave 20 of 92 M elements past the
    bound after 3 steps, each with step-1 gradients of 1e-10 to 1e-8 that
    differ by 50 % or more; on the card, with the set-aside rule at a
    tenth, the worst held element reached 7.8e-5, its gradients 10 % apart
    near 3e-8 and changing sign between steps).
    The count of elements so set aside is printed, and the worst held one
    with its gradients."""
    from multimodalpromptretrieval_tpu_torch.serving import (
        synthetic_config,
        synthetic_slake,
    )
    from multimodalpromptretrieval_tpu_torch.train import step as steps
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        T5_LARGE_TRAINER,
        TrainingExperiment,
    )

    worker = dp_worker_module()
    splits, images = synthetic_slake(8, 0, image_size=224, seed=seed,
                                     n_validate=2, answer_style="open")
    cfg = synthetic_config(batch_size=8, retrieval=True, k=1, image_size=224)
    cfg.update(seed=seed, T5_version="t5-large",
               clip_overrides={"attention_impl": "row"},
               **copy.deepcopy(T5_LARGE_TRAINER))
    cfg["t5_overrides"].update(num_layers=2, num_decoder_layers=2,
                               dropout_rate=0.0)
    gates, runs = {}, {}
    backward = steps.backward
    t0 = time.time()
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        exp = TrainingExperiment(cfg, train=splits["train"],
                                 validate=splits["validate"], images=images,
                                 device=device, quiet=True)
        exp.retrieval_index.is_training_phase = True
        exp.precompute_hints("train")
        exp.build_vision_token_cache("train")
        batches = exp.make_split_batches("train", shuffle=True, epoch=0)
        step = exp.train_step()
        grads = []

        def kept(loss, run):  # each step's gradients, kept on the CPU
            out = backward(loss, run)
            grads.append({n: g.detach().cpu() for n, g in out.items()
                          if g is not None})
            return out

        steps.backward = kept
        try:
            with worker.forced_gates(exp, gates,
                                     record=where == "card") as seen:
                losses = [float(step(exp.params, exp.opt_state,
                                     exp.device_batch(b), 1e-3))
                          for b in batches[:3]]
        finally:
            steps.backward = backward
        moments = {m.dtype for m in exp.opt_state["mu"].values()}
        runs[where] = (losses, {n: p.detach().cpu() for n, p in
                                exp.params.named_parameters()}, moments,
                       grads)
        del exp
    (lc, pc, mc, gc_), (lh, ph, mh, gh) = runs["card"], runs["cpu"]
    flips = [sum(v[i] for v in seen.values()) for i in (0, 1)]
    checks.expect(len(lc) == len(gc_) == len(gh) == 3
                  and mc == mh == {torch.bfloat16}
                  and not any(gates.values()),
                  f"t5_large small step: 3 batches of 8, B x L "
                  f"{tuple(batches[0].arrays['input_ids'].shape)}, moments "
                  f"{sorted(map(str, mc))}; the CPU took the card's ReLU "
                  f"gates: {flips[0]} set apart, {flips[1]} left at an exact"
                  f" 0 ({time.time() - t0:.1f} s)")
    tol = 1e-4 * min(1.0, max(abs(x) for x in lh))
    err = max(abs(a - b) for a, b in zip(lc, lh))
    checks.expect(err <= tol, f"t5_large small step, 3 losses card {lc} vs "
                  f"cpu {lh}: max difference {err:.3g} (tol {tol:.3g})")
    rel = {n: (gc_[0][n] - gh[0][n]).abs().max().item()
           / max(gh[0][n].abs().max().item(), 1e-30) for n in gh[0]}
    worst = max(rel, key=rel.get)
    checks.expect(set(gc_[0]) == set(gh[0]) and rel[worst] <= 1e-4,
                  f"t5_large small step, step-1 gradients of {len(gh[0])} "
                  f"leaves: card vs cpu within {rel[worst]:.3g} of the "
                  f"leaf's largest at most, in {worst} (tol 1e-4)")
    largest = max(p.abs().max().item() for p in ph.values())
    tol = 1e-4 * min(1.0, largest)
    noise = past = held_past = 0
    worst, perr = None, 0.0
    for n in pc:
        diff = (pc[n] - ph[n]).abs()
        noisy = torch.zeros(diff.shape, dtype=torch.bool)
        for a, b in zip(gc_, gh):
            if n in a:
                noisy |= (a[n] - b[n]).abs() > 0.01 * torch.maximum(
                    a[n].abs(), b[n].abs())
        over = diff > tol
        noise += int(noisy.sum())
        past += int(over.sum())
        held_past += int((over & ~noisy).sum())
        held = diff.masked_fill(noisy, 0.0)
        if held.max().item() >= perr:
            worst, perr = n, held.max().item()
            at = np.unravel_index(int(held.argmax()), held.shape)
    steps_at = [(f"{a[worst][at].item():.3g}", f"{b[worst][at].item():.3g}")
                for a, b in zip(gc_, gh) if worst in a]
    total = sum(p.numel() for p in pc.values())
    checks.expect(held_past == 0,
                  "t5_large small step, parameters after the third step: "
                  f"{noise:,} of {total:,} elements set aside, their "
                  "gradient rounding noise at some step (card and cpu "
                  f"apart by more than a hundredth; {past} elements past "
                  "the "
                  f"bound in all); the other elements within {perr:.3g} "
                  f"(tol {tol:.3g}: 1e-4 of the largest {largest:.3g}, and "
                  f"of 1), {held_past} past it; the worst in {worst} "
                  f"{tuple(map(int, at))}, its (card, cpu) gradients "
                  f"{steps_at}")


# ---------------------------------------------------------------------------
# The LM generator: K10, K11 and its serving path
# ---------------------------------------------------------------------------

# K10 / K11 against their plain versions over the same inputs in fp32: the
# largest error of an output row relative to its norm. fp32: full fp32
# products summed in another order; bf16: K10 rounds the SiLU product to
# bf16 before the down product, K11 the probabilities before the second
# product (2^-9 relative each), both sum in fp32
LM_KERNEL_TOL = {"moe_experts": {torch.float32: 1e-5, torch.bfloat16: 1e-2},
                 "mla_decode_attention": {torch.float32: 2e-5,
                                          torch.bfloat16: 1.5e-2}}
# the LM cell's shapes: hidden, expert width, experts, per token; latent,
# rope, heads
LM_D, LM_I, LM_E, LM_K = 2048, 1408, 64, 6
LM_C, LM_R, LM_H = 512, 64, 16


def _row_err(got, want) -> float:
    return float(((got.float() - want.float()).norm(dim=-1)
                  / want.float().norm(dim=-1).clamp(min=1e-30)).max())


def _lm_case(checks: Checks, kernel: str, case: str, dtype, got, want,
             fn=None, plain=None, work=None, library=None,
             headline: bool = False) -> None:
    """Hold one case to its tolerance; with ``fn``, time it beside the
    plain version, its bound (``work``: (bytes, operations)) and the
    library call; ``headline``: the kernel's reported numbers."""
    err = _row_err(got, want)
    tol = LM_KERNEL_TOL[kernel][dtype]
    res = checks.results[kernel]
    res["max_rel_err"] = max(res.get("max_rel_err", 0.0), err)
    res["max_abs_err"] = max(res["max_abs_err"], float(
        (got.float() - want.float()).abs().max()))
    line = (f"{kernel} {case}: max row error {err:.3g} of the row's norm "
            f"(tol {tol:.3g})")
    if fn is not None:
        ms, plain_ms = time_ms(fn), time_ms(plain)
        got_ms = dict(ms=ms, plain_ms=plain_ms, library_ms=None)
        got_ms["bound_ms"], got_ms["bound_by"] = bound(
            work[0], work[1], PEAK_FLOPS[dtype])
        line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{got_ms['bound_ms']:.4f} ms by {got_ms['bound_by']}")
        if library is not None:
            try:
                lib_out = library()
                got_ms["library_ms"] = time_ms(library)
                line += (f", library call {got_ms['library_ms']:.4f} ms "
                         f"(row error {_row_err(lib_out, want):.3g})")
            except (RuntimeError, TypeError, ValueError) as e:
                line += f", library call failed: {type(e).__name__}: {e}"
        if headline:
            res.update(got_ms)
        else:
            res.setdefault("cases", {})[case] = got_ms
    checks.expect(err <= tol and bool(torch.isfinite(got).all()), line)


def grouped_mm_experts(h, idx, w, gate_up, down):
    """The routed experts through ``torch._grouped_mm`` (the library's
    grouped GEMM, bf16): rows sorted by expert, both products, the rows
    weighted and summed back a token. A yardstick, on no path."""
    N, k = idx.shape
    order = torch.argsort(idx.reshape(-1), stable=True)
    counts = torch.bincount(idx.reshape(-1), minlength=gate_up.shape[0])
    offs = torch.cumsum(counts, 0).to(torch.int32)
    x = h[order // k]
    gu = torch._grouped_mm(x, gate_up.transpose(1, 2), offs=offs)
    g, u = gu.chunk(2, dim=-1)
    y = torch._grouped_mm(torch.nn.functional.silu(g) * u,
                          down.transpose(1, 2), offs=offs)
    out = torch.empty((N * k, h.shape[1]), dtype=torch.float32,
                      device=h.device)
    out[order] = y.float() * w.reshape(-1)[order, None]
    return out.view(N, k, -1).sum(dim=1)


def check_lm_kernels(checks: Checks, randn) -> None:
    """K10 and K11 at the LM cell's shapes (module docstring, item 2)."""
    from multimodalpromptretrieval_tpu_torch.ops import mla, moe

    print("K10 / K11 at the kimi-vl-a3b.serve-pass cell's shapes vs their "
          "plain versions", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    w32 = dict(gate_up=randn(LM_E, 2 * LM_I, LM_D) * 0.02,
               down=randn(LM_E, LM_D, LM_I) * 0.02)
    for tokens, case in ((512, "decode B=512"), (58368, "prefill 512x114")):
        h32 = randn(tokens, LM_D)
        idx = torch.topk(torch.rand(tokens, LM_E, generator=gen, device=dev),
                         LM_K, dim=-1).indices
        wt = torch.rand(tokens, LM_K, generator=gen, device=dev)
        rows = tokens * LM_K
        touched = int(torch.unique(idx).numel())
        for dt in (torch.float32, torch.bfloat16):
            h = h32.to(dt)
            gu, dn = w32["gate_up"].to(dt), w32["down"].to(dt)
            got = moe.moe_experts(h, idx, wt, gu, dn)
            want = moe.moe_experts_reference(h.float(), idx, wt, gu.float(),
                                             dn.float())
            timed = dt == torch.bfloat16
            work = ((touched * 3 * LM_D * LM_I + 2 * rows * LM_D) * 2,
                    6.0 * rows * LM_D * LM_I)
            library = (lambda h=h, idx=idx, wt=wt, gu=gu, dn=dn:
                       grouped_mm_experts(h, idx, wt, gu, dn)) if (
                timed and hasattr(torch, "_grouped_mm")) else None
            _lm_case(checks, "moe_experts", f"{case} {dt}, {rows:,} rows",
                     dt, got, want,
                     fn=(lambda h=h, idx=idx, wt=wt, gu=gu, dn=dn:
                         moe.moe_experts(h, idx, wt, gu, dn))
                     if timed else None,
                     plain=(lambda h=h, idx=idx, wt=wt, gu=gu, dn=dn:
                            moe.moe_experts_reference(h, idx, wt, gu, dn)),
                     work=work, library=library,
                     headline=timed and tokens == 512)
            del got, want
        del h32
    del w32
    torch.cuda.empty_cache()

    B, T = 512, 134
    scale = 192 ** -0.5
    q32 = randn(B, LM_H, LM_C)
    qp32 = randn(B, LM_H, LM_R)
    c32 = randn(B, T, LM_C + LM_R)
    ok = (torch.rand(B, T, generator=gen, device=dev) > 0.1).to(torch.int8)
    ok[:, 0] = 1
    for length in (114, 124, 134):
        keys = int(ok[:, :length].long().sum())
        work = ((keys * (LM_C + LM_R) + B * LM_H * (2 * LM_C + LM_R)) * 2,
                2.0 * LM_H * keys * (LM_C + LM_R) + 2.0 * LM_H * keys * LM_C)
        for dt in (torch.float32, torch.bfloat16):
            q, qp, c = q32.to(dt), qp32.to(dt), c32.to(dt)
            got = mla.mla_decode_attention(q, qp, c, ok, length, scale)
            want = mla.mla_decode_attention_reference(
                q.float(), qp.float(), c.float(), ok, length, scale)
            timed = dt == torch.bfloat16

            def library(q=q, qp=qp, c=c, length=length):
                # 16 query heads over one shared key / value head
                return torch.nn.functional.scaled_dot_product_attention(
                    torch.cat([q, qp], -1)[:, :, None],
                    c[:, None, :length], c[:, None, :length, :LM_C],
                    attn_mask=ok[:, None, None, :length].bool(), scale=scale,
                    enable_gqa=True)[:, :, 0]

            _lm_case(checks, "mla_decode_attention",
                     f"B={B}, T={length}, {LM_H} heads, {LM_C} + {LM_R}, "
                     f"{dt}", dt, got, want,
                     fn=(lambda q=q, qp=qp, c=c, length=length:
                         mla.mla_decode_attention(q, qp, c, ok, length,
                                                  scale)) if timed else None,
                     plain=(lambda q=q, qp=qp, c=c, length=length:
                            mla.mla_decode_attention_reference(
                                q, qp, c, ok, length, scale)),
                     work=work, library=library if timed else None,
                     headline=timed and length == 124)


def lm_setup(seed: int, dev, layers: int):
    """The LM phase's serving experiment (module docstring, item 16)."""
    from multimodalpromptretrieval_tpu_torch import serving

    t0 = time.time()
    splits, images = serving.synthetic_slake(
        410, 512, image_size=224, seed=seed, n_validate=8,
        answer_style="open")
    cfg = serving.synthetic_config(batch_size=512, epochs=1, retrieval=True,
                                   k=1, image_size=224)
    cfg.pop("t5_overrides", None)
    cfg.update(seed=seed, compute_dtype="bfloat16", max_source_length=64,
               generator="lm", lm_overrides={"num_hidden_layers": layers},
               clip_overrides={"attention_impl": "row"})
    exp = serving.ServingExperiment(
        cfg, train=splits["train"], validate=splits["validate"],
        test=splits["test"], images=images, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in exp.params.lm.parameters())
    print(f"lm path setup: data, {n / 1e9:.2f} B LM parameters in "
          f"{exp.params.lm.embed.dtype} and a {len(exp.retrieval_index)}-"
          f"entry index in {time.time() - t0:.1f} s", flush=True)
    return exp, splits["test"], images


def drive_lm(checks: Checks, seed: int, dev, card: str):
    """The LM phase (module docstring, item 16); returns its launches."""
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer

    layers = 4
    exp, tests, images = lm_setup(seed, dev, layers)
    cfg = exp.model_cfg.lm
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    server = MPRServer(exp, load_checkpoint=False)
    serve_window = window_of(server, tests, images)
    serve_window()  # warm-up: every shape of the window
    server.chunks = {"fused": 0, "host": 0}
    server.decode_steps = 0
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    answers = serve_window()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()
    n = len(tests)
    n_chunks = -(-n // exp.batch_size)
    print(f"lm path: {n} questions in 2 submits, {seconds:.3f} s, "
          f"{n / seconds:.1f} QA/s on {card} ({layers} layers)", flush=True)
    checks.expect(len(answers) == n and all(isinstance(a, str)
                                            for a in answers),
                  f"lm answers: {len(answers)} of {n}")
    checks.expect(server.chunks == {"fused": n_chunks, "host": 0},
                  f"lm fused path engaged: {server.chunks}")
    for name in PATH_KERNELS["lm"]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the lm path: {launches[name]}")
    # each step: K11 once a layer, K10 once a MoE layer; each prefill K10
    # once a MoE layer
    steps = launches["mla_decode_attention"] / layers
    checks.expect(steps == int(steps) and launches["moe_experts"]
                  == n_moe * (n_chunks + int(steps)),
                  f"lm launches: K10 {launches['moe_experts']} = {n_moe} MoE "
                  f"layers x ({n_chunks} prefills + {steps:g} steps), K11 "
                  f"{launches['mla_decode_attention']} = {layers} layers x "
                  f"{steps:g} steps; {server.decode_steps} tokens counted "
                  "by the server")
    print("lm path launches: " + json.dumps(
        {k: v for k, v in launches.items() if v}), flush=True)
    del server, exp
    torch.cuda.empty_cache()
    check_small_lm(checks, seed, dev)
    return launches


def check_small_lm(checks: Checks, seed: int, dev) -> None:
    """The LM alone at 2 layers (dense, MoE) and the published widths,
    fp32: the card's kernels against the CPU's plain versions."""
    from multimodalpromptretrieval_tpu_torch.models import moe_lm

    cfg = moe_lm.LMConfig.from_dict({"num_hidden_layers": 2})
    lm_cpu = moe_lm.MoELM(cfg, torch.Generator().manual_seed(seed))
    lm_card = copy.deepcopy(lm_cpu).to(dev)
    g = torch.Generator().manual_seed(seed + 1)
    B, P, W, steps = 4, 50, 64, 5
    prefix = torch.randn(B, P, cfg.hidden_size, generator=g)
    lens = [64, 40, 17, 5]
    ids = torch.zeros(B, W, dtype=torch.long)
    mask = torch.zeros(B, W, dtype=torch.long)
    for b, m in enumerate(lens):
        ids[b, :m] = torch.randint(2, 32000, (m,), generator=g)
        mask[b, :m] = 1
    head = moe_lm.lm_head
    out = {}
    for where, lm in (("cpu", lm_cpu), ("card", lm_card)):
        logits = []

        def keep(x, weight):
            y = head(x, weight)
            logits.append(y.float().cpu())
            return y

        moe_lm.lm_head = keep
        try:
            with torch.no_grad():
                d = lm.embed.device
                got = moe_lm.lm_generate(lm, cfg, prefix.to(d), ids.to(d),
                                         mask.to(d), steps)
        finally:
            moe_lm.lm_head = head
        out[where] = (got.cpu(), torch.stack(logits, 1))
    (ic, lc), (ik, lk) = out["cpu"], out["card"]
    err = float((lk - lc).abs().max() / lc.abs().max())
    checks.expect(torch.equal(ic, ik) and err <= 1e-4,
                  f"lm small input, fp32, {B} rows x {steps + 1} tokens, 2 "
                  f"layers: card ids {'==' if torch.equal(ic, ik) else '!='}"
                  f" cpu ids, logits within {err:.3g} of the largest (tol "
                  "1e-4)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset to run while iterating;"
                        " the result lines are printed only for all "
                        "fifteen")
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    from multimodalpromptretrieval_tpu_torch.ops import _build

    t0 = time.time()
    path = _build.library_path()
    _build.library()
    print(f"built {path} with nvcc ({' '.join(_build.NVCC_FLAGS)}) "
          f"in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    from multimodalpromptretrieval_tpu_torch.ops import norm

    x = torch.ones((4, 8), device=dev)
    norm.fused_layer_norm(x, x[0], x[0])
    norm.fused_rms_norm(x, x[0])
    torch.cuda.synchronize()
    print(f"first Triton norm kernels compiled in {time.time() - t0:.1f} s",
          flush=True)

    checks = Checks()
    if "kernels" in phases:
        check_kernels(checks, dev)
    launches, params, main = {}, None, None
    for path in SERVE_PATH_NAMES if "serve" in phases else ():
        exp, tests, images = serving_setup(args.seed, dev, path, params)
        launches[path] = drive_path(checks, path, exp, tests, images)
        check_small_input(checks, path, exp, tests, images)
        params = exp.params  # same seed, same weights: init once
        if path == "main":
            main = (exp, tests, images)
        del exp
    if "features" in phases:
        main = main or serving_setup(args.seed, dev, "main", params)
        params = main[0].params
        features = (features_experiment(main[0]),) + tuple(main[1:])
        launches["features"] = drive_features(checks, *features, card)
        check_small_features(checks, *features)
        del features
    main = None
    if "check" in phases:
        launches["kernel_check"] = drive_kernel_check(checks)
    if "train" in phases:
        launches["train"] = drive_train_path(checks, args.seed, dev, card,
                                             params)
        check_small_step(checks, args.seed, dev)
    # the cli phase's dataset and checkpoint serve the eval and parallel
    # phases too
    with tempfile.TemporaryDirectory() as cli_root:
        if "cli" in phases:
            launches["cli"] = drive_cli_path(checks, args.seed, dev, card,
                                             cli_root)
        if "variants" in phases:
            launches["variants"] = drive_variants(checks, args.seed, dev,
                                                  card)
        if "pretrained" in phases:
            launches["pretrained"] = drive_pretrained(checks, args.seed, dev,
                                                      card)
        if "eval" in phases:
            launches["eval"] = drive_eval(checks, args.seed, dev, card,
                                          cli_root)
        if "parallel" in phases:
            launches["parallel"] = drive_parallel(checks, args.seed, dev,
                                                  card, cli_root)
        if "model_parallel" in phases:
            launches["model_parallel"] = drive_model_parallel(
                checks, args.seed, dev, card, cli_root)
        if "seq_parallel" in phases:
            launches["seq_parallel"] = drive_seq_parallel(
                checks, args.seed, dev, card, cli_root)
        if "sharded_serve" in phases:
            launches["sharded_serve"] = drive_sharded_serve(
                checks, args.seed, dev, card, cli_root)
        if "t5_large" in phases:
            launches["t5_large"] = drive_t5_large(checks, args.seed, dev,
                                                  card, cli_root)
    if "lm" in phases:
        launches["lm"] = drive_lm(checks, args.seed, dev, card)

    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed:",
              file=sys.stderr)
        for f in checks.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    if phases != set(PHASES):
        print(f"chip_smoke: phases {sorted(phases)} passed; a partial run "
              "prints no result lines")
        return 0
    for path in ("features", "train", "cli", "variants", "pretrained",
                 "eval", "parallel", "model_parallel", "seq_parallel",
                 "sharded_serve", "t5_large", "lm"):
        print(f"{path} path launches: " + json.dumps(
            {k: v for k, v in launches[path].items() if v}))
    path_of = {}
    for path, names in PATH_KERNELS.items():
        for name in names:
            path_of.setdefault(name, path)
    kernels = [dict(name=name, **meta, launches=launches[path_of[name]][name],
                    **checks.results[name]) for name, meta in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
