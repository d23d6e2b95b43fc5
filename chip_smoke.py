"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]
                          [--phases kernels,serve,train,bert,llama,trainloop,
                                    observe]
                          [--optimizer-ab]

Needs one CUDA card; without one it exits non-zero and prints no result.
Phases, each fatal on failure:

1. card: the ``nvidia-smi`` name and power limit; TF32 off for matmuls
   and cuDNN, so fp32 means fp32.
2. build: every kernel under ``paddle_tpu_torch/ops/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, in parallel), timed; ptxas's
   registers, spills and warnings for each tensor-core flash kernel, and
   its SASS's HGMMAs, wgmma waits and global loads; for the FMA route's
   fp32 forward, dq and dkv (``fwd_fp32_kernel``, ``dq_fp32_kernel``,
   ``dkv_fp32_kernel``) and its bf16 forward, dq and dkv
   (``fwd_mma_kernel``, ``dq_mma_kernel``, ``dkv_mma_kernel``, mma.sync)
   registers, spills and the SASS's HMMA, FFMA and shared-load
   instructions.
3. kernels: each kernel against its plain PyTorch version on the card
   at the main paths' shapes (RMSNorm forward, and its backward from the
   kernel's statistic, at decode's rows 1-8 and 13, which take its
   small-row route, the prompt buckets and the Llama train cell's
   [16384, 2048], which take its many-row route; LayerNorm at GPT-2's
   and BERT-large's widths; flash-attention forward, dq and dkv on both
   routes, wgmma and FMA, at GPT-2's, Llama-2 7B's and the Llama train
   cell's (B8 S2048 H16 D128) training shapes, the fp32 attention of the
   GPT-2, BERT and Llama oracles (FMA), GQA, padded lengths, rows
   that see no key, a single query, head dims of 32, 50 (fp32, rows off
   16-byte boundaries), 96, 160 and 256 (GQA; and Gemma-7B's attention,
   B1 S4096 H16, timed), 45 in bf16 (rows only 2-byte aligned, with
   dropout), bf16 operands at a 2-byte storage offset, and
   dropout (also at D = 128), whose keep-mask must match exactly in fp32
   and bf16 (on both routes); with an additive bias: BERT-large's key mask, a full bias
   whose dbias the dq kernels emit (also at D = 256 with dropout and GQA,
   the bf16 dq and dkv of the FMA route), a broadcast one with dropout, rows
   that an infinite bias hides; with packed segments, per-segment causal,
   also with unequal q and k lengths; the softmax cross-entropy forward
   and backward at GPT-2's and BERT's training logits, BERT's NSP head
   (V = 2), Llama's vocabulary, odd vocabularies, rows starting at every
   offset from a 16-byte boundary (odd row counts of BERT's vocabulary,
   V = 30523, views at a storage offset, V = 2 and 7), logits x100 and
   labels outside [0, V)), then timed beside its bound, its plain version
   and the PyTorch call computing the same function (RMSNorm also beside
   an empty kernel's launch floor; an fp32 flash kernel beside two
   bounds, its products at 3xTF32's 165 TFLOP/s and at FFMA's 67; for
   the flash backward
   kernels, sdpa's backward alone; at BERT's shape sdpa takes the same
   float attn_mask and dropout rate). Every check holds entry by entry
   (``check_close``: rtol of |plain| + rms(plain)), but for the bf16
   backward at Llama-2 7B's, BERT-large's and Gemma-7B's shapes
   (``check_exact``: no
   further from the fp64 result, bias and dropout included, than 1.25x
   the plain version's own distance); dbias is held
   tighter than a bf16-rounded dbias could pass. Each flash case must
   launch exactly the kernels of ``flash_route``'s choice, a bias call
   their bias instantiations, each counted on its own counter; a bias of
   the "keys" class (``flash_bias_class``: it does not vary along
   queries) takes the wgmma forward's, dq's and dkv's "keys"
   instantiations, whose out, lse, dq, dk and dv must equal the "plane"
   class's on the same bias, materialised along queries, bit for bit
   (BERT's mask, a broadcast bias, key masks at a ragged edge, causal or
   with dropout, and one query). The wgmma forward, dq and dkv are also
   timed bias-free and with the "plane" class at BERT's shape.
4. serve: two cells behind the continuous-batching ``DecodeServer``, each
   with random weights from ``--seed`` at full width and depth, fp32: 8
   mixed-length prompts from client threads, 32 greedy tokens each.
   Llama-2 7B (prompts 17-300, max_context 512; every RMSNorm through its
   kernel) and GPT-2 small (prompts 17-900, max_context 1024; every
   LayerNorm through its kernel). ``warmup()`` first captures every step
   signature as a CUDA graph (count and seconds logged); the counted run
   must capture nothing more. Launch counts are exact per model step (a
   replay counts what its capture recorded), one replayed batch-8 decode
   step under ``torch.profiler`` must show the norm kernel once per norm
   in CUPTI's records, two requests of each are replayed through
   ``decode_step`` with a contiguous cache, teacher-forced along the
   server's tokens, as the oracle of every token, and every step the
   server ran, run again eagerly through the step layer on pools of its
   own, must give the graph's tokens.
5. profile (only with ``--profile``): a second round of each serve cell
   (warmed up first) whose batch-8 decode steps run under
   ``torch.profiler``: device time by kernel class and the device's idle
   share, written to ``--out``; likewise one step of each train cell and
   of both loop cells (9b, 9c).
Train cells (6b, 7b, 8b, 9c) run ``create_train_step`` /
``create_multistep_train_step`` captured: one CUDA graph per signature,
the first call eager on the capture stream. From one snapshot of the
parameters and the model's generators, 3 steps of the smoke's own eager
loop (``zero_grad``, loss, ``backward``, ``apply_gradients``) and 3
captured steps on a fresh optimizer must give the same losses and
parameters bit for bit (BERT's dropout included); then 20 timed
replays (counted: exact launches, one capture in all), and one more
replay under ``torch.profiler`` whose CUPTI records must show each of the
step's kernels the expected number of times. The loss must fall by 0.5
over the first 20 steps from the initialisation. The first call
(eager step + capture) is reported apart from the timed steps (9c: each
twin's, before the turns), and the memory the allocator holds after
them (the graph pool included); the peak allocated memory by stage: what
the earlier cells left, the 3 eager steps' peak, and the first call's
warm-up, its capture and the captured steps.

6. train: ``create_train_step`` trains ``GPTForCausalLM``.
   a. oracle: GPT-2 small's widths with 2 layers, fp32, one step of
      batch 1 x 1024 on the card (kernels) and on the CPU (plain
      versions) from the same weights, through the FMA flash kernels
      (fp32): loss within rtol 1e-4, every
      gradient within 1e-3 of its largest magnitude (the key
      projection's bias, whose gradient is zero in exact arithmetic,
      within 1e-6 of the model's largest gradient magnitude).
      Then recompute under capture: 2 layers at GPT-2 small's widths,
      bf16, dropout 0.1, every layer recomputed ("full", then
      "dots_saveable"): 3 captured steps equal to 3 eager ones from one
      snapshot, bit for bit.
   b. full: bench.py's GPT-2 small config (12 layers, vocab 50304, seq
      1024, batch 8, dropout 0, bf16 parameters, fp32 AdamW moments,
      AdamW(3e-4, weight decay 0.01)), 20 steps on one batch: the loss
      must fall by at least 0.5 and every step must launch exactly 12
      wgmma flash forwards, 12 wgmma dq, 12 wgmma dkv, 25 LayerNorm, one
      CE forward and one CE backward kernel. Reports tokens/s, ms/step, peak memory and MFU
      (bench.py's FLOP count over 989 TFLOP/s). With ``--profile``, two
      more steps go under ``torch.profiler`` (one warm-up, one
      recorded).
7. bert: ``create_train_step`` pretrains ``BertForPretraining`` (MLM +
   NSP) with a padding mask, which every attention layer hands to the
   flash kernels as an additive [B, 1, 1, S] bias.
   a. oracle: BERT-large's widths with 2 layers, fp32, dropout 0, one
      step of batch 2 x 512 (valid lengths 300 and 512) on the card (FMA
      flash kernels with the bias) and on the CPU (plain versions) from
      the same weights: loss within rtol 1e-4, every gradient within 1e-3
      of its largest magnitude (the key projections' biases, zero in
      exact arithmetic, within 1e-6 of the model's largest gradient).
   b. full: ``bert_large()`` (24 layers, 1024 wide, 16 heads, vocab
      30522, 512 positions, dropout 0.1), bf16 parameters, fp32 AdamW
      moments, AdamW(1e-4, weight decay 0.01 off biases and norms), batch
      16 x 512 from ``--seed`` (valid lengths 128-512, token type 1 after
      a split at 1/4-3/4 of the length, 15 % of valid positions masked to
      id 103 and labelled), 20 steps on one batch: the loss must fall by
      at least 0.5 and every step must launch exactly 24 flash
      forwards, 24 dq and 24 dkv (the wgmma "keys" instantiations; none
      bias-free, none "plane", none on the FMA route), 50 LayerNorm, two
      CE forward and two CE backward kernels (MLM and NSP), and no dbias
      is computed. Reports ms/step, tokens/s (all and valid positions), peak
      memory and MFU (6 x matmul params + 12 L S H per token over 989
      TFLOP/s). With ``--profile``, one step goes under
      ``torch.profiler``.
8. llama: ``create_train_step`` trains ``LlamaForCausalLM`` with the
   blockwise LM-head CE (``ops/fused_ce.py``, plain PyTorch) and the
   multi-tensor AdamW step, whose two steps on the card first must equal
   the per-parameter loop's bit for bit (bf16 and fp32 parameters and
   moments).
   a. oracle: the cell's widths (hidden 2048, 16 heads of D = 128,
      intermediate 5504, vocab 32000) with 2 layers, fp32, one step of
      batch 1 x 1024 on the card (FMA flash kernels, RMSNorm kernel) and
      on the CPU (plain versions) from the same weights: loss within
      rtol 1e-4, every gradient within 1e-3 of its largest magnitude;
      2/2/2 FMA flash launches, 5 RMSNorm, no CE kernel. Then the step's
      loss and gradients on the card again with ``use_recompute`` under
      "full" and "dots_saveable": equal to the run without recompute bit
      for bit (a tensor that already differs between two runs without
      recompute is named and held to that difference), with 4 flash
      forwards and 9 RMSNorms (every layer replayed). Then that model in
      bf16 with recompute under both policies: 3 captured steps equal
      to 3 eager ones from one snapshot, bit for bit.
   b. full (cell ``llama-0.7b-bf16-train-b8``): bench_configs.py's
      single-chip Llama config (12 layers, 2048 wide, 16 heads, 5504,
      vocab 32000, sequence 2048, dropout 0, blockwise CE), batch 8, no
      recompute, bf16 parameters and bf16 AdamW moments, AdamW(3e-4,
      weight decay 0.01 off norms), 20 steps on one batch: the loss must
      fall by at least 0.5 and every step must launch exactly 12 wgmma
      flash forwards, dq and dkv (bias-free, D = 128), 25 RMSNorms and
      nothing else. Reports ms/step, tokens/s, peak memory and MFU
      (bench_configs.py's ``_mfu_llama`` count over 989 TFLOP/s); with
      ``--profile`` one step goes under ``torch.profiler``.
9. trainloop: the training loop a Paddle user writes, on GPT-2 small
   (dropout 0), with the LR schedule
   ``LinearWarmup(CosineAnnealingDecay(3e-4, T_max=20), warmup_steps=2,
   start_lr=0, end_lr=3e-4)``.
   a. oracle: 2 layers at GPT-2 small's widths, fp32, batch 1 x 1024:
      three eager steps (``loss.backward(); opt.step(); opt.clear_grad();
      sched.step()``) of AdamW (weight decay 0.01 off biases and norms
      through ``apply_decay_param_fun``, ``ClipGradByGlobalNorm`` at half
      the first step's global norm, so that it engages) on the card (FMA
      flash kernels) and on the CPU from the same weights: each loss
      within rtol 1e-4, every gradient of every step within 1e-3 of its
      max-abs, each parameter's change over the three steps within 1e-3
      of that change's largest magnitude (the key projections' biases,
      whose gradient is zero in exact arithmetic, held by their
      gradients to 1e-6 of the largest; so are the entries whose two
      gradients differ by more than 1e-3 of |gradient| + Adam's eps,
      whose update that difference can move by more than the bound,
      counted); then SGD through
      ``create_multistep_train_step(steps=1, accumulate=2)`` on two
      1 x 512 microbatches against the concatenated 2 x 512 batch, three
      steps each on the card: losses rtol 1e-5, parameters rtol 1e-4 /
      atol 1e-5. Exactly 2 flash forwards, dq and dkv (FMA), 5 LayerNorms
      and one CE forward and backward per pass.
   b. eager O2 (cell ``gpt2s-bf16-O2-eager-b8``): the fp32 model and its
      AdamW through ``amp.decorate(level="O2", dtype="bfloat16")`` (bf16
      parameters, fp32 master weights), ``ClipGradByGlobalNorm(1.0)``,
      20 steps on one batch of 8 x 1024: the loss must fall by at least
      0.5, the rate of each step must equal the schedule's, the global
      norm after clipping must stay within 1.0 (1 + 1e-2), every bf16
      parameter must equal its fp32 master rounded to bf16 bit for bit,
      and every step must launch the train cell's kernels (12/12/12
      wgmma flash, 25 LayerNorm, 1/1 CE). Prints the global norm before
      clipping at each step, ms/step, tokens/s and peak memory. Then
      the clip engaged on bf16 gradients: 2 layers, 3 O2 steps with
      ``ClipGradByGlobalNorm`` at half the first step's global norm; the
      norm after clipping within 1 % of the clip norm at every step, the
      bf16 parameters their rounded masters, the launches of two layers.
   c. run_steps (cell ``gpt2s-bf16-run-steps-k4-m2``), bf16 parameters,
      AdamW(3e-4, weight decay 0.01 off biases and norms):
      ``create_multistep_train_step(steps=4)`` must equal 4
      ``create_train_step`` calls on a twin bit for bit (losses and
      parameters, batch 8 x 1024); 3 captured ``steps=4, accumulate=2``
      dispatches must equal the smoke's own eager loop from one
      snapshot; then 20 optimizer steps as 5
      dispatches of ``steps=4, accumulate=2`` (microbatch 4 x 1024; each
      step the same 8 sequences in a new order), fed by
      ``prefetch_to_device(host numpy batches, stack=4, depth=2)`` with
      the schedule's rate at each dispatch's first step as ``lr(i)``,
      must give a synchronous loop's losses and parameters on a twin bit
      for bit; the loss must fall, and every step must launch 24/24/24
      wgmma flash, 50 LayerNorm and 2/2 CE kernels. Four turns in all
      (run_steps, synchronous, run_steps, synchronous), each compared,
      each timed: ms/step and ``pipeline_stats`` (host-blocked vs
      device-blocked seconds); one capture for each twin, and a profiled
      replayed dispatch.

10. observe: the port's observability on the captured GPT-2 small
   server (cell ``gpt2s-fp32-decode8``: the serve phase's model, prompts
   and seed), after ``warmup()``, whose 38 captures must each count once
   in ``profiler.compile_count()``.
   a. trace: a burst of 8 requests with the flight recorder on. Each
      request's ``trace_id`` must carry ``decode::enqueue``, ``admit``,
      ``prefill``, ``first_token`` and ``finish`` once each, in that
      order by timestamp; the ``decode::step`` spans must number the
      server's ``decode_steps``; ``compile_count()`` must not move;
      ``decode_stats(name)`` must equal ``server.stats()``;
      ``export_stats("text")`` must hold one line per numeric leaf of
      ``export_stats()``, its ``tokens_generated`` the tokens served;
      ``export_trace`` must write the ``paddleTrace`` section; launch
      counts as the serve phase's.
   b. Profiler: ``Profiler(targets=[CPU, GPU])`` over 4 replayed batch-8
      decode steps, each in a ``RecordEvent``: the exported chrome trace
      must hold as many LayerNorm kernel events as ``layer_norm``'s
      launches rose (CUPTI's dropped records retried, as
      ``_hold_profiled`` does), every one starting inside its step's
      scope (25 a scope). A ``RecordEvent`` inside a call captured while
      the Profiler records must leave the graph's kernels those of the
      eager call.
   c. device: ``device.Event(enable_timing=True)`` around a replayed
      step, printed beside the Profiler's device time for a step;
      ``device.memory_stats()`` must equal ``torch.cuda.memory_stats()``
      under the reference's keys.
   d. run_steps with tracing on at the width of
      ``gpt2s-bf16-run-steps-k4-m2``, 3 dispatches after the first call:
      one ``train::dispatch``, ``train::fetch`` and ``train::feed_wait``
      span each, no capture, the run_steps cell's launches.
   e. the cost of tracing: the host microseconds of a span and an event,
      then bursts with the flight recorder off, on, on, off, off, on, on,
      off: decode step p50 and mean, tokens/s and the garbage
      collections of each (printed, no gate).

``--optimizer-ab`` adds GPT-2's and BERT's train cells with the flag
``use_fused_optimizer`` on and off in turns (ms/step, the profiled
``Optimizer.step`` span and idle share).

The line before the last holds the kernel table as JSON; the last line
is ``{"ok": true, "device": {...}}``, or ``{"ok": "partial", ...}`` when
``--phases`` left a phase out.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and fp32
# (non-tensor-core) flop/s; a card set below 700 W runs slower
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12     # dense tensor-core peak
# the fastest product of fp32 operands with fp32 sums: TF32's 495 TFLOP/s
# dense over the three passes of the 3xTF32 split (big.big + big.small +
# small.big), as sdpa's fp32 kernels run. The fp32 flash bound; the FMA
# kernels' own ceiling stays FP32_FLOPS, printed beside it
TF32X3_FLOPS = 495e12 / 3

NEW_TOKENS = 32
TIE_ATOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_graph_ms(fn, reps: int = 100, iters: int = 20) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph (so host launch cost is excluded), replayed ``iters``
    times between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def time_eager_ms(fn, iters: int = 200) -> float:
    """Wall time of one eager ``fn()`` call as a caller issues it
    (host launch cost included), between CUDA events."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rms_bound(rows: int, n: int, dtype: torch.dtype):
    """(bound ms, bound_by, bytes) of an RMSNorm forward with a weight:
    x read once, w read once, y written once, inv written once; ~4 flops
    per element (square, sum, two scales)."""
    es = torch.finfo(dtype).bits // 8
    nbytes = 2 * rows * n * es + n * es + rows * 4
    flops = 4 * rows * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3     # the kernel computes in fp32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


# entry-wise (check_close): y in fp32 differs from the plain version in
# the order of the row's sum of squares; bf16 then rounds y (one ulp is
# at most 2^-7 of |y|). The backward is the same plain arithmetic on both
# sides (autograd through rms_norm_plain against RMSNormFunction's closed
# form from the kernel's inv), in another order
RMS_RTOL = {"y": {torch.float32: 1e-5, torch.bfloat16: 1e-2},
            "inv": 1e-5,
            "bwd": {torch.float32: 1e-4, torch.bfloat16: 1e-2}}


def _rms_backward(norms, x, w, g):
    """(dx, dw) of sum(rms_norm(x, w) * g) through RMSNormFunction (the
    kernel's forward on the card) and through autograd of
    rms_norm_plain."""
    out = []
    for fn in (lambda a, b: norms.RMSNormFunction.apply(a, b, 1e-5),
               lambda a, b: norms.rms_norm_plain(a, b, 1e-5)[0]):
        xa = x.detach().clone().requires_grad_()
        wa = w.detach().clone().requires_grad_()
        (fn(xa, wa).float() * g).sum().backward()
        out.append((xa.grad, wa.grad))
    return out


def _rms_floor_ms(rows: int, pdl: int) -> float:
    """Device time of an empty kernel of ``rows`` 256-thread blocks
    launched through the RMSNorm library's own path (ctypes, the current
    stream, the same build), as its small-row route launches (``pdl``
    1: programmatic dependent launch) or as its many-row route does
    (0): the floor under the kernel's time."""
    from paddle_tpu_torch.ops.kernels import _build
    lib = _build.load("rms_norm")

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rms_norm_floor(rows, pdl, ctypes.c_void_p(stream))
        _build.check(lib, rc, "rms_norm_floor")
    return time_graph_ms(launch)


def phase_kernels(norms, gen):
    """RMSNorm kernel vs rms_norm_plain on the card (y and inv, held by
    check_close; and the backward from the kernel's inv against autograd
    of the plain version), then timings beside the launch's floor.
    Returns (max |y - plain| in fp32, timing rows, the share of its
    tolerance each check used)."""
    dev = torch.device("cuda")
    worst, used = 0.0, {}
    # the main path's rows: decode batch buckets 1-8 and the prompt
    # buckets 32..512 of the served prompts, at N = 4096; the small-row
    # route takes up to 132 rows (132 and 133 are its edge); then a ragged
    # row count and a width that takes the scalar path
    shapes = [(r, 4096) for r in (1, 2, 3, 4, 5, 6, 7, 8, 32, 64, 128, 132,
                                  133, 256, 512)]
    # the Llama train cell's [B*S, H] = [16384, 2048] (bf16 there)
    for rows, n in shapes + [(16384, 2048), (13, 4096), (3, 1000)]:
        for dtype in (torch.float32, torch.bfloat16):
            for with_w in (True, False):
                x = torch.randn(rows, n, device=dev, generator=gen,
                                dtype=torch.float32).to(dtype)
                w = (torch.randn(n, device=dev, generator=gen) + 1.0
                     ).to(dtype) if with_w else None
                y, inv = norms.rms_norm(x, w, 1e-5)
                yp, invp = norms.rms_norm_plain(x, w, 1e-5)
                torch.cuda.synchronize()
                tag = (f"rms_norm [{rows},{n}] {str(dtype)[6:]} "
                       f"w={'yes' if with_w else 'no'}")
                log(f"  {tag}")
                err, used[tag + " y"] = check_close(
                    "y", y, yp, RMS_RTOL["y"][dtype])
                _, used[tag + " inv"] = check_close("inv", inv, invp,
                                                    RMS_RTOL["inv"])
                if dtype == torch.float32:
                    worst = max(worst, err)
                if with_w and rows in (8, 13, 512, 16384):
                    g = torch.randn(rows, n, device=dev, generator=gen)
                    (dx, dw), (dxp, dwp) = _rms_backward(norms, x, w, g)
                    _, used[tag + " dx"] = check_close(
                        "dx", dx, dxp, RMS_RTOL["bwd"][dtype])
                    _, used[tag + " dw"] = check_close(
                        "dw", dw, dwp, RMS_RTOL["bwd"][dtype])
    # decode's batches 1, 8 and 13 (the small-row route), the largest
    # prompt bucket and the Llama train cell's rows (the many-row route),
    # each beside an empty kernel of as many blocks launched both ways
    timings = []
    for rows, n in ((1, 4096), (8, 4096), (13, 4096), (512, 4096),
                    (16384, 2048)):
        floor = {"floor_ms": _rms_floor_ms(rows, 0),
                 "floor_pdl_ms": _rms_floor_ms(rows, 1)}
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, n, device=dev, generator=gen).to(dtype)
            w = (torch.randn(n, device=dev, generator=gen) + 1.0).to(dtype)
            lib_fn = torch.nn.functional.rms_norm
            row = {
                "rows": rows, "n": n, "dtype": str(dtype)[6:],
                "ms": time_graph_ms(lambda: norms.rms_norm(x, w, 1e-5)),
                "plain_ms": time_graph_ms(
                    lambda: norms.rms_norm_plain(x, w, 1e-5)),
                "library_ms": time_graph_ms(
                    lambda: lib_fn(x, (n,), w, 1e-5)),
                "eager_ms": time_eager_ms(
                    lambda: norms.rms_norm(x, w, 1e-5)),
                "eager_plain_ms": time_eager_ms(
                    lambda: norms.rms_norm_plain(x, w, 1e-5)),
                **floor,
            }
            row["bound_ms"], row["bound_by"], row["bytes"] = rms_bound(
                rows, n, dtype)
            timings.append(row)
            log(f"  time rms_norm [{rows},{n}] {row['dtype']}: kernel "
                f"{row['ms'] * 1e3:.3f} us; empty-kernel floor "
                f"{row['floor_ms'] * 1e3:.3f} us launched plain, "
                f"{row['floor_pdl_ms'] * 1e3:.3f} us with programmatic "
                f"dependent launch (eager call "
                f"{row['eager_ms'] * 1e3:.2f} us), plain "
                f"{row['plain_ms'] * 1e3:.2f} us (eager "
                f"{row['eager_plain_ms'] * 1e3:.2f} us), "
                f"F.rms_norm {row['library_ms'] * 1e3:.2f} us; bound "
                f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
                f"({row['bytes']} B)")
    return worst, timings, used


def _tolerance_share(name, got, ref, rtol):
    """check_close's reading: (max |got - ref|, the largest share of its
    tolerance an entry uses, that entry's index, |got - ref| and ref over
    the finite entries, rms(ref)); non-finite entries must agree."""
    got, ref = got.float(), ref.float()
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(
            got[~fin], ref[~fin]):
        raise AssertionError(f"{name}: non-finite entries differ")
    if not fin.any():
        return 0.0, 0.0, 0, ref[fin], ref[fin], 0.0
    g, r = got[fin], ref[fin]
    diff = (g - r).abs()
    err = float(diff.max())
    rms = float(r.square().mean().sqrt())
    if rms > 0:
        share = diff / (rtol * (r.abs() + rms))
        used = float(share.max())
        worst = int(share.argmax())
    else:                               # an all-zero reference: exact
        used, worst = (0.0 if err == 0 else math.inf), int(diff.argmax())
    return err, used, worst, diff, r, rms


def check_close(name, got, ref, rtol, quiet=False):
    """Hold ``got`` to ``ref`` entry by entry: at every finite entry of
    ``ref``, |got - ref| <= rtol * (|ref| + rms(ref)); the non-finite
    entries must agree exactly. The rms term is the absolute part of the
    tolerance, at the reference's typical size, so an entry near zero is
    held to rtol of a typical entry rather than of the largest one.
    Returns (max |got - ref|, the largest share of its own tolerance that
    any entry used)."""
    err, used, worst, diff, r, rms = _tolerance_share(name, got, ref, rtol)
    if not used <= 1.0:
        raise AssertionError(
            f"{name}: |kernel - plain| {float(diff[worst]):.3e} at an entry "
            f"where plain is {float(r[worst]):.4g}, {used:.3g} x its "
            f"tolerance {rtol:g} x (|plain| + rms {rms:.3g}); max "
            f"|kernel - plain| {err:.3e}")
    if not quiet:
        log(f"    {name}: max|kernel-plain| {err:.3e}; worst entry at "
            f"{used:.3f} of its tolerance, {rtol:g} x (|plain| + rms "
            f"{rms:.3g}) ok")
    return err, used


def check_exact(name, got, plain, exact, ratio, quiet=False):
    """Hold ``got`` to ``exact`` (the fp64 result of the same inputs) no
    further than ``ratio`` times the plain version's own distance from it:
    with d(x) the largest |x - exact| / (|exact| + rms(exact)) over the
    entries, d(got) <= ratio * d(plain). Returns (max |got - plain|,
    d(got) / (ratio * d(plain)), the share of the limit used)."""
    exact = exact.float()
    _, d_got, _, _, _, _ = _tolerance_share(name, got, exact, 1.0)
    _, d_plain, _, _, _, _ = _tolerance_share(name, plain, exact, 1.0)
    err = float((got.float() - plain.float()).abs().max())
    used = d_got / (ratio * d_plain) if d_plain > 0 else (
        0.0 if d_got == 0 else math.inf)
    if not used <= 1.0:
        raise AssertionError(
            f"{name}: {d_got:.3e} x (|exact| + rms) from the fp64 result, "
            f"{d_got / d_plain:.3g} x the plain version's {d_plain:.3e} "
            f"(limit {ratio:g} x)")
    if not quiet:
        log(f"    {name}: {d_got:.3e} x (|exact| + rms) from fp64, plain "
            f"{d_plain:.3e}: {d_got / d_plain:.3f} x the plain version's, "
            f"limit {ratio:g} x; max|kernel-plain| {err:.3e} ok")
    return err, used


def exact_bwd(q, k, v, do, lse, delta, causal: bool, scale: float,
              rate: float = 0.0, seed=None, bias=None):
    """(dq, dk, dv) in fp64 of the same bf16 inputs, lse and delta: the
    plain backward's formulas with no rounding on the way, the additive
    ``bias`` (broadcast to [B, H, Sq, Sk]) added to the scaled scores and
    the dropout keep-mask of ``seed`` at ``rate`` applied to dP and to
    the p of dV (no GQA or segments)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    if q.shape[2] != k.shape[2]:
        raise ValueError("exact_bwd: q and k/v heads must match")
    qd, kd, vd, dod = (t.double().transpose(1, 2) for t in (q, k, v, do))
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s = qd @ kd.transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias.double().expand(b, h, sq, sk)
    if causal:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(j > i + (sk - sq), float("-inf"))
    lse_d = lse.double()[..., None]
    p = torch.exp(s - torch.where(torch.isneginf(lse_d), 0.0, lse_d))
    del s
    dp = dod @ vd.transpose(-1, -2)
    p_v = p
    if rate > 0.0:
        keep = fa.dropout_keep_mask(seed, b * h, sq, sk, rate).reshape(
            b, h, sq, sk)
        keep_scale = fa._keep_scale(rate)
        dp = torch.where(keep, dp * keep_scale, 0.0)
        p_v = torch.where(keep, p * keep_scale, 0.0)
        del keep
    ds = p * (dp - delta.double()[..., None])
    del dp
    dq = ds @ kd * scale
    dk = ds.transpose(-1, -2) @ qd * scale
    dv = p_v.transpose(-1, -2) @ dod
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def ln_bound(rows: int, n: int, dtype: torch.dtype):
    """(bound ms, bound_by) of a LayerNorm forward with w and b: x read,
    w and b read, y written, mu and rstd written; ~8 fp32 flops per
    element."""
    es = torch.finfo(dtype).bits // 8
    nbytes = 2 * rows * n * es + 2 * n * es + 2 * rows * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * rows * n / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# entry-wise tolerances of check_close, 2-5x the most the kernel needed
# on the card (PERF.md). Both sides compute y in fp32 and differ in the
# order of the row sums; bf16 then rounds y, and one bf16 ulp is at most
# 2^-7 of |y|
LN_RTOL = {torch.float32: 2e-6, torch.bfloat16: 1e-2}
LN_STAT_RTOL = 5e-7                     # mu and rstd, fp32


def phase_layer_norm(norms, gen):
    """LayerNorm kernel vs layer_norm_plain at GPT-2's rows (8 x 1024
    tokens, and a batch of 8) and width 768 (eps 1e-5), and at
    BERT-large's (16 x 512 tokens, width 1024, eps 1e-12), fp32 and bf16, held entry by entry (LN_RTOL,
    LN_STAT_RTOL); then timed at both training shapes. Returns (the
    timing row at GPT-2's shape, the one at BERT's, the share of its
    tolerance each check used)."""
    dev = torch.device("cuda")
    worst, used = {}, {}
    for rows, n, eps in ((8192, 768, 1e-5), (8, 768, 1e-5),
                         (8192, 1024, 1e-12)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, n, device=dev, generator=gen) * 2
                 + 0.5).to(dtype)
            w = (torch.randn(n, device=dev, generator=gen) + 1).to(dtype)
            b = torch.randn(n, device=dev, generator=gen).to(dtype)
            y, mu, rstd = norms.layer_norm(x, w, b, eps)
            yp, mup, rstdp = norms.layer_norm_plain(x, w, b, eps)
            torch.cuda.synchronize()
            tag = f"layer_norm [{rows},{n}] {str(dtype)[6:]}"
            worst[(rows, n, dtype)], used[tag + " y"] = check_close(
                tag + " y", y, yp, LN_RTOL[dtype])
            _, used[tag + " mu"] = check_close(tag + " mu", mu, mup,
                                               LN_STAT_RTOL, quiet=True)
            _, used[tag + " rstd"] = check_close(tag + " rstd", rstd, rstdp,
                                                 LN_STAT_RTOL, quiet=True)
    rows_out = []
    for n, eps in ((768, 1e-5), (1024, 1e-12)):
        x = torch.randn(8192, n, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(n, device=dev, generator=gen) + 1).to(torch.bfloat16)
        b = torch.randn(n, device=dev, generator=gen).to(torch.bfloat16)
        row = {
            "ms": time_graph_ms(lambda: norms.layer_norm(x, w, b, eps)),
            "plain_ms": time_graph_ms(
                lambda: norms.layer_norm_plain(x, w, b, eps)),
            "library_ms": time_graph_ms(
                lambda: torch.nn.functional.layer_norm(x, (n,), w, b, eps)),
            "eager_ms": time_eager_ms(lambda: norms.layer_norm(x, w, b, eps)),
            "max_abs_err": worst[(8192, n, torch.bfloat16)],
        }
        row["bound_ms"], row["bound_by"] = ln_bound(8192, n, torch.bfloat16)
        log(f"  time layer_norm [8192,{n}] bf16: kernel "
            f"{row['ms'] * 1e3:.2f} us (eager call "
            f"{row['eager_ms'] * 1e3:.2f} us), plain "
            f"{row['plain_ms'] * 1e3:.2f} us, F.layer_norm "
            f"{row['library_ms'] * 1e3:.2f} us; bound "
            f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']}")
        rows_out.append(row)
    return rows_out[0], rows_out[1], used


def _visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the causal diagonal j <= i + sk - sq leaves."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


FLASH_FLOPS_PER_PAIR = {"fwd": 4, "dq": 6, "dkv": 8}   # x head_dim


def flash_bound(kind, b, sq, sk, hq, hk, d, dtype, causal, bias_bytes=0,
                peak=None):
    """(bound ms, bound_by): flops of the products over the visible pairs
    at the dtype's peak (bf16 tensor cores; fp32 products at 3xTF32's
    TF32X3_FLOPS, or ``peak``), or the bytes of each operand read once and
    each result written once (an additive bias's ``bias_bytes`` included:
    read once, at its own broadcast shape)."""
    es = torch.finfo(dtype).bits // 8
    flops = FLASH_FLOPS_PER_PAIR[kind] * d * b * hq * _visible_pairs(
        sq, sk, causal)
    qb, kb, stat = b * sq * hq * d * es, b * sk * hk * d * es, b * hq * sq * 4
    nbytes = {"fwd": 2 * qb + 2 * kb + stat,
              "dq": 3 * qb + 2 * kb + 2 * stat,
              "dkv": 2 * qb + 4 * kb + 2 * stat}[kind] + bias_bytes
    if peak is None:
        peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# (name, B, Sq, Sk, Hq, Hk, D, dtype, causal, dropout rate[, extras]).
# bf16 with a head dim that is a multiple of 8 up to 128 takes the wgmma
# kernels (forward, dq, dkv); fp32 and wider heads the FMA kernels
# (flash_route). extras: "bias" names an additive bias (_flash_bias);
# "seg" gives packed segment lengths of q and of k, and then ``causal``
# is each segment's own diagonal, as flash_attention_ext takes it;
# "bwd": "exact" holds dq, dk and dv with check_exact in place of
# check_close; "offset": q, k, v, dO start that many elements past a
# 16-byte boundary (contiguous all the same), which sends bf16 to the FMA
# route
FLASH_CASES = [
    ("gpt2-train", 8, 1024, 1024, 12, 12, 64, torch.bfloat16, True, 0.0),
    ("llama7b", 1, 2048, 2048, 32, 32, 128, torch.bfloat16, True, 0.0,
     {"bwd": "exact"}),
    ("llama-0.7b-train", 8, 2048, 2048, 16, 16, 128, torch.bfloat16, True,
     0.0, {"bwd": "exact"}),
    ("gqa-32/8", 1, 1024, 1024, 32, 8, 128, torch.bfloat16, True, 0.0),
    ("padded-200/333", 2, 200, 333, 4, 4, 64, torch.float32, True, 0.0),
    ("padded-non-causal", 2, 200, 333, 4, 2, 96, torch.float32, False, 0.0),
    ("dropout-0.1", 2, 512, 512, 4, 4, 64, torch.float32, True, 0.1),
    ("dropout-0.1-bf16", 2, 512, 512, 4, 2, 64, torch.bfloat16, True, 0.1),
    # the wgmma route's edges: ragged tiles, rows that see no key (Sq > Sk
    # under causal), head dims TMA zero-fills to 128 and to 64, dropout at
    # D = 128 with GQA 4/1, a single query; and a bf16 head dim above 128,
    # which stays on the FMA kernels
    ("padded-200/333-bf16", 2, 200, 333, 4, 4, 64, torch.bfloat16, True,
     0.0),
    ("empty-rows-333/200-bf16", 2, 333, 200, 4, 4, 64, torch.bfloat16, True,
     0.0),
    ("non-causal-d96-gqa-bf16", 2, 200, 333, 4, 2, 96, torch.bfloat16, False,
     0.0),
    ("dropout-0.2-d128-gqa-4/1-bf16", 2, 130, 130, 4, 1, 128, torch.bfloat16,
     True, 0.2),
    ("dropout-0.1-d32-non-causal-bf16", 1, 257, 513, 2, 2, 32,
     torch.bfloat16, False, 0.1),
    ("one-query-1/300-bf16", 1, 1, 300, 4, 2, 64, torch.bfloat16, True, 0.0),
    ("d160-bf16", 1, 256, 256, 4, 2, 160, torch.bfloat16, True, 0.0),
    # the FMA route's bf16 forward (fwd_mma_kernel) at its edges: D = 256
    # with GQA; an odd head dim, whose rows start only 2 bytes apart,
    # ragged, with dropout; D = 64 on operands 2 bytes past a 16-byte
    # boundary; and Gemma-7B's attention (16 heads of 256), timed, its
    # backward held by check_exact (the tensor-core dq and dkv over 4096
    # keys; PERF.md)
    ("d256-bf16", 1, 512, 512, 8, 2, 256, torch.bfloat16, True, 0.0),
    ("d45-odd-bf16", 2, 200, 333, 4, 2, 45, torch.bfloat16, True, 0.1),
    ("misaligned-d64-bf16", 2, 200, 333, 4, 2, 64, torch.bfloat16, True,
     0.0, {"offset": 1}),
    ("gemma7b-d256", 1, 4096, 4096, 16, 16, 256, torch.bfloat16, True, 0.0,
     {"bwd": "exact"}),
    # additive bias and segments. BERT-large's attention (its padding mask
    # as a [B, 1, 1, S] key bias at 0 / -1e9; then with the model's
    # dropout 0.1, the kernels its train cell launches; and the fp32
    # oracle's shape on the FMA kernels); a
    # full bias whose dbias the dq kernels emit (and its fp32 twin on the
    # FMA kernels); a [1, Hq, 1, Sk] bias with GQA 4/1, D 128 and dropout,
    # whose dbias takes the broadcast sum; rows an infinite bias hides;
    # packed segments with per-segment causal (and the fp32 twin), also
    # with unequal q and k lengths (the reference's ragged case)
    ("bert-large-keymask", 16, 512, 512, 16, 16, 64, torch.bfloat16, False,
     0.0, {"bias": "keymask", "bwd": "exact"}),
    ("bert-keymask-dropout", 16, 512, 512, 16, 16, 64, torch.bfloat16, False,
     0.1, {"bias": "keymask", "bwd": "exact"}),
    ("bert-oracle-keymask-fp32", 2, 512, 512, 16, 16, 64, torch.float32,
     False, 0.0, {"bias": "keymask"}),
    # the attention of the GPT-2 and Llama fp32 oracles (one 1024-token
    # row, causal, no bias; D 64 and 128), whose forward, dq and dkv take
    # the FMA route's register-blocked fp32 kernels
    ("gpt2-oracle-fp32", 1, 1024, 1024, 12, 12, 64, torch.float32, True,
     0.0),
    ("llama-oracle-fp32", 1, 1024, 1024, 16, 16, 128, torch.float32, True,
     0.0),
    ("full-bias-dbias", 2, 200, 333, 4, 2, 64, torch.bfloat16, True, 0.0,
     {"bias": "full"}),
    ("full-bias-dbias-fp32", 2, 200, 333, 4, 2, 64, torch.float32, True, 0.0,
     {"bias": "full"}),
    ("bcast-bias-d128-dropout", 2, 130, 130, 4, 1, 128, torch.bfloat16, True,
     0.1, {"bias": "bcast"}),
    ("bias-inf-rows", 2, 256, 256, 4, 4, 64, torch.bfloat16, False, 0.0,
     {"bias": "inf-rows"}),
    ("varlen-causal", 1, 1024, 1024, 12, 12, 64, torch.bfloat16, True, 0.0,
     {"seg": ((5, 300, 1, 700, 18), (5, 300, 1, 700, 18))}),
    ("varlen-causal-fp32", 1, 1024, 1024, 12, 12, 64, torch.float32, True,
     0.0, {"seg": ((5, 300, 1, 700, 18), (5, 300, 1, 700, 18))}),
    ("varlen-ragged-qk", 1, 6, 8, 2, 2, 64, torch.bfloat16, True, 0.0,
     {"seg": ((2, 4), (4, 4))}),
    # the "keys" bias class of the wgmma dq and dkv at the ragged key edge
    # (causal; and not, with dropout) and with one query, whose [B, 1, 1,
    # Sk] bias has a query stride but Sq = 1
    ("keymask-333-causal", 2, 333, 333, 4, 2, 64, torch.bfloat16, True, 0.0,
     {"bias": "keymask"}),
    ("keymask-333-dropout", 2, 333, 333, 4, 2, 64, torch.bfloat16, False,
     0.1, {"bias": "keymask"}),
    ("keymask-one-query", 2, 1, 300, 4, 2, 64, torch.bfloat16, True, 0.0,
     {"bias": "keymask-contiguous"}),
    # fp32 with a head dim that is not a multiple of 4: no row starts on a
    # 16-byte boundary, so the FMA route's fp32 forward, dq and dkv copy
    # their tiles by 4-byte cp.async (ragged keys, causal, GQA)
    ("d50-ragged-fp32", 2, 200, 333, 4, 2, 50, torch.float32, True, 0.0),
    # the Mask instantiations of the FMA route's bf16 dq and dkv at D = 256
    # (dq's two warps a row block, each over half of D): a full bias with
    # dbias, ragged, GQA, dropout; last, so that the earlier cases keep
    # their draws
    ("d256-full-bias-dbias-bf16", 1, 200, 333, 4, 2, 256, torch.bfloat16,
     True, 0.1, {"bias": "full"}),
]
INF_ROWS = (0, 7, 100)                  # the rows "inf-rows" hides
# entry-wise (check_close), 2-5x the most the kernels needed on the card
# (PERF.md). dq and dkv differ from their plain versions only in the order
# of fp32 sums, which can move a bf16 output by an ulp (at most 2^-7 of
# |y|); the forward also rounds p to bf16 against another running max
# than the plain version does
FLASH_RTOL = {"fwd": {torch.float32: 5e-6, torch.bfloat16: 2.5e-2},
              "bwd": {torch.float32: 5e-6, torch.bfloat16: 1.6e-2}}
LSE_RTOL = 3e-7                         # lse is fp32 at every dtype
# dbias is ds in fp32 on both sides (before any bf16 rounding), summed in
# another order: held far tighter than the bf16 dq, between the readings
# and the same dbias rounded to bf16, which must fail it (PERF.md)
DBIAS_RTOL = {torch.float32: 5e-6, torch.bfloat16: 1e-4}
# check_exact's limit for the bf16 backward at Llama-2 7B's shape, at
# BERT-large's (its key mask, with and without dropout, in the fp64
# backward too) and at Gemma-7B's (D = 256, 4096 keys: the FMA route's
# tensor-core dq and dkv), where the entry-wise distance to the plain
# version passed on some draws only, at entries where the plain version
# is the further from fp64: the kernel no further from fp64 than this
# many times the plain version's own distance. Both routes read
# 1.000-1.002 at Llama's shape over seeds 0-3 (PERF.md); 0.25 of room
# above 1 leaves a missing key tile failing it
BWD_EXACT_RATIO = 1.25


def _flash_inputs(gen, b, sq, sk, hq, hk, d, dtype, offset=0):
    """q, k, v, dO; each a contiguous view ``offset`` elements into its
    storage."""
    dev = torch.device("cuda")

    def mk(s, h):
        if not offset:
            return torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
        x = torch.randn(b * s * h * d + offset, device=dev, generator=gen)
        return x.to(dtype)[offset:].view(b, s, h, d)
    return mk(sq, hq), mk(sk, hk), mk(sk, hk), mk(sq, hq)


def _flash_bias(gen, kind, b, sq, sk, hq):
    """An fp32 additive bias: "keymask", BERT's padding mask (valid
    lengths uniform over 128-Sk, 0 / -1e9 on the keys), a [B, 1, 1, Sk]
    view with stride 0 on the query dim ("keymask-contiguous": the same,
    contiguous); "full" and "inf-rows", [B, Hq, Sq, Sk] at 0.5 N(0, 1),
    the latter with the rows INF_ROWS at -inf; "bcast", [1, Hq, 1, Sk] at
    0.5 N(0, 1)."""
    dev = torch.device("cuda")
    if kind.startswith("keymask"):
        lens = torch.randint(128, sk + 1, (b,), device=dev, generator=gen)
        keys = torch.arange(sk, device=dev)[None, :]
        mask = torch.where(keys < lens[:, None], 0.0, -1e9)[:, None, None]
        return mask.contiguous() if kind == "keymask-contiguous" else mask
    shape = (1, hq, 1, sk) if kind == "bcast" else (b, hq, sq, sk)
    bias = 0.5 * torch.randn(shape, device=dev, generator=gen)
    if kind == "inf-rows":
        bias[:, :, list(INF_ROWS)] = float("-inf")
    return bias


def _flash_segments(fa, lens_q, lens_k):
    """Segments of one packed batch row with the given lengths."""
    ids = [torch.repeat_interleave(
        torch.arange(len(n), device="cuda"),
        torch.tensor(n, device="cuda"))[None] for n in (lens_q, lens_k)]
    return [fa.encode_segments(i) for i in ids]


def _sfx(route: str) -> str:
    """Suffix of a flash kernel's name on ``route`` (flash_fwd_wgmma)."""
    return "_wgmma" if route == "wgmma" else ""


def _flash_case(fa, gen, case):
    """One FLASH_CASES entry: the public wrappers must launch exactly the
    kernels of ``flash_route``'s choice, and each result is held against
    its plain version; on a wgmma case the FMA forward, dq and dkv are
    held too, on the same inputs. Returns (max |kernel - plain| by kernel,
    the share of its tolerance each check used)."""
    name, b, sq, sk, hq, hk, d, dtype, causal, rate = case[:10]
    extras = case[10] if len(case) > 10 else {}
    q, k, v, do = _flash_inputs(gen, b, sq, sk, hq, hk, d, dtype,
                                extras.get("offset", 0))
    seed = torch.tensor([987654321], dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(d)
    route = fa.flash_route(dtype, d, [t.data_ptr() for t in (q, k, v, do)])
    bias, seg = None, None
    if "bias" in extras:
        bias = _flash_bias(gen, extras["bias"], b, sq, sk, hq)
    if "seg" in extras:
        # per-segment diagonals in the words, the global one off
        seg = fa.Segments(*_flash_segments(fa, *extras["seg"]), causal)
        causal = False
    dbias = extras.get("bias") in ("full", "inf-rows")
    log(f"  flash {name}: B{b} Sq{sq} Sk{sk} H{hq}/{hk} D{d} "
        f"{str(dtype)[6:]} causal={causal} dropout={rate}"
        + (f" bias {extras['bias']} {list(bias.shape)}" if bias is not None
           else "")
        + (f" segments {extras['seg']} causal={seg.causal}" if seg else "")
        + (f" at storage offset {extras['offset']}" if "offset" in extras
           else "")
        + f"; route {route}")
    outp, lsep = fa.flash_fwd_plain(q, k, v, causal, scale, rate, seed,
                                    bias, seg)
    delta = (do.float() * outp.float()).sum(-1).transpose(1, 2).contiguous()
    args = (causal, scale, rate, seed, bias, seg)
    dqp = fa.flash_dq_plain(q, k, v, do, lsep, delta, *args, dbias)
    dqp, dbp = dqp if dbias else (dqp, None)
    dkp, dvp = fa.flash_dkv_plain(q, k, v, do, lsep, delta, *args)
    tol = FLASH_RTOL["bwd"][dtype]
    exact = (exact_bwd(q, k, v, do, lsep, delta, causal, scale, rate, seed,
                       bias) if extras.get("bwd") == "exact" else None)
    e, u = {}, {}

    def hold_bwd(name, got, ref, i):
        if exact is None:
            return check_close(name, got, ref, tol)
        return check_exact(name, got, ref, exact[i], BWD_EXACT_RATIO)

    def hold(sfx, out, lse, dq, dk, dv, db):
        e["fwd" + sfx], u["out" + sfx] = check_close(
            "out" + sfx, out, outp, FLASH_RTOL["fwd"][dtype])
        _, u["lse" + sfx] = check_close("lse" + sfx, lse, lsep, LSE_RTOL)
        e["dq" + sfx], u["dq" + sfx] = hold_bwd("dq" + sfx, dq, dqp, 0)
        dk_err, u["dk" + sfx] = hold_bwd("dk" + sfx, dk, dkp, 1)
        dv_err, u["dv" + sfx] = hold_bwd("dv" + sfx, dv, dvp, 2)
        e["dkv" + sfx] = max(dk_err, dv_err)
        if dbias:
            _, u["dbias" + sfx] = check_close("dbias" + sfx, db, dbp,
                                              DBIAS_RTOL[dtype])
            # the control: the same dbias rounded to bf16 must fail it
            ctl = _tolerance_share("dbias", db.to(torch.bfloat16), dbp,
                                   DBIAS_RTOL[dtype])[1]
            u["dbias_bf16_control" + sfx] = ctl
            log(f"    dbias{sfx} rounded to bf16 (control): worst entry at "
                f"{ctl:.3g} x the tolerance")
            if not ctl > 1.0:
                raise AssertionError(f"{name}: the dbias check passes a "
                                     f"bf16-rounded dbias")
        if extras.get("bias") == "inf-rows":
            rows = list(INF_ROWS)
            if not (torch.all(out[:, rows] == 0)
                    and torch.all(torch.isneginf(lse[:, :, rows]))):
                raise AssertionError(f"{name}: hidden rows give out != 0 "
                                     f"or lse != -inf")
            if not all(torch.isfinite(t).all() for t in (dq, dk, dv, db)):
                raise AssertionError(f"{name}: a gradient is not finite")

    # the wgmma kernels take a "keys" bias (one that does not vary along
    # queries) by their own instantiations
    keys = False
    if route == "wgmma" and bias is not None:
        b4 = fa._bias4(bias, b, hq, sq, sk)
        keys = fa.flash_bias_class(b4.shape, b4.stride(), seg is not None,
                                   dbias) == "keys"
    before = _counts()
    out, lse = fa.flash_fwd(q, k, v, causal, scale, rate, seed, bias, seg)
    dq = fa.flash_dq(q, k, v, do, lsep, delta, *args, dbias=dbias)
    dq, db = dq if dbias else (dq, None)
    dk, dv = fa.flash_dkv(q, k, v, do, lsep, delta, *args)
    moved = {n: c - before[n] for n, c in _counts().items()
             if c != before[n]}
    # the FMA route's bf16 forward, dq and dkv are the mma.sync kernels
    # (fwd_mma_kernel, dq_mma_kernel, dkv_mma_kernel)
    sfx = (_sfx(route) + ("_mma" if route == "fma" and dtype == torch.bfloat16
                          else "")
           + ("_keybias" if keys else "_bias" if bias is not None else ""))
    expect = {f"flash_{kind}{sfx}": 1 for kind in ("fwd", "dq", "dkv")}
    if moved != expect:
        raise AssertionError(f"{name}: launches {moved}, expected {expect}")
    hold(_sfx(route), out, lse, dq, dk, dv, db)
    if keys:
        # the "plane" class on the same bias, its query dim materialised:
        # the same additions in the same order, so the same bits
        shape = list(fa._bias_shape4(bias))
        shape[2] = sq
        plane = bias.reshape(fa._bias_shape4(bias)).expand(shape).contiguous()
        pargs = (causal, scale, rate, seed, plane, seg)
        before = _counts()
        # named: with one query (Sq = 1) every bias is of the keys class
        got = (*fa._fwd_launch(q, k, v, *pargs, bias_class="plane"),
               fa._dq_launch(q, k, v, do, lsep, delta, *pargs,
                             bias_class="plane"),
               *fa._dkv_launch(q, k, v, do, lsep, delta, *pargs,
                               bias_class="plane"))
        moved = {n: c - before[n] for n, c in _counts().items()
                 if c != before[n]}
        if moved != {f"flash_{kind}_wgmma_bias": 1
                     for kind in ("fwd", "dq", "dkv")}:
            raise AssertionError(f"{name}: the plane bias {shape} launched "
                                 f"{moved}")
        for gname, want, g in zip(("out", "lse", "dq", "dk", "dv"),
                                  (out, lse, dq, dk, dv), got):
            if not torch.equal(g, want):
                raise AssertionError(
                    f"{name}: {gname} of the keys class differs from the "
                    f"plane class's at {int((g != want).sum())} entries")
        log(f"    out, lse, dq, dk, dv of the keys class equal the plane "
            f"class's (bias {shape}) bit for bit")
    if route == "wgmma":
        out, lse = fa._fwd_launch(q, k, v, *args, route="fma")
        dq = fa._dq_launch(q, k, v, do, lsep, delta, *args, dbias,
                           route="fma")
        dq, db = dq if dbias else (dq, None)
        dk, dv = fa._dkv_launch(q, k, v, do, lsep, delta, *args,
                                route="fma")
        hold("", out, lse, dq, dk, dv, db)
    if extras.get("bias") == "bcast":
        # the broadcast dbias (plain PyTorch on the card, as the
        # reference's XLA code) against the full ds summed onto the bias's
        # shape: fp32 on both sides, summed in another order
        got = fa.flash_dbias_broadcast(q, k, v, do, lsep, delta, bias,
                                       *args[:4], seg)
        _, ds = fa.flash_dq_plain(q, k, v, do, lsep, delta, *args, True)
        _, u["dbias_bcast"] = check_close(
            "dbias (broadcast)", got, ds.sum((0, 2), keepdim=True), 1e-5)
    return e, u


def _flash_timings(fa, gen, case, kinds, bias_as=None):
    """Device times of the named flash kernels (kind + route suffix) at the
    case's shape beside their plain versions, their bound and sdpa:
    forward, and backward alone (the forward-plus-backward graph less the
    forward graph), which computes dq, dk and dv together. A case with a
    bias (not causal) gives sdpa the same float bias as its attn_mask, and
    one with dropout its rate: every call runs at the case's rate.
    ``bias_as``: "none" drops the case's bias (the bias-free kernels at its
    shape), "plane" materialises it as [B, 1, Sq, Sk] (the "plane" bias
    class)."""
    name, b, sq, sk, hq, hk, d, dtype, causal, rate = case[:10]
    extras = case[10] if len(case) > 10 else {}
    q, k, v, do = _flash_inputs(gen, b, sq, sk, hq, hk, d, dtype)
    scale = 1.0 / math.sqrt(d)
    seed = torch.tensor([987654321], dtype=torch.int32, device="cuda")
    bias = (_flash_bias(gen, extras["bias"], b, sq, sk, hq)
            if "bias" in extras and bias_as != "none" else None)
    if bias_as == "plane":
        bias = bias.expand(b, 1, sq, sk).contiguous()
    drop = (rate, seed, bias)
    _, lse = fa.flash_fwd_plain(q, k, v, causal, scale, bias=bias)
    out, _ = fa.flash_fwd(q, k, v, causal, scale, *drop)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    # PyTorch's attention on [B, H, S, D]; at Sq = Sk its top-left causal
    # mask is the reference's diagonal
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = None if bias is None else bias.to(dtype)

    def sdpa(qq, kk, vv, is_causal):
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, dropout_p=rate, is_causal=is_causal)

    def lib_fwd_bwd():
        o = sdpa(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    # device time per call: 10 calls captured in a CUDA graph, replayed
    # between CUDA events (the ctypes launch cost and the per-call tensor
    # map encoding stay out, as PyTorch's own launch cost does for the
    # library call)
    lib_fwd = time_graph_ms(lambda: sdpa(qt, kt, vt, is_causal=causal),
                            reps=10, iters=5)
    lib_fwd_bwd_ms = time_graph_ms(lib_fwd_bwd, reps=10, iters=5)
    lib = {"fwd": lib_fwd, "bwd": lib_fwd_bwd_ms - lib_fwd}
    kern = {
        "fwd": lambda: fa._fwd_launch(q, k, v, causal, scale, *drop,
                                      route="fma"),
        "fwd_wgmma": lambda: fa.flash_fwd(q, k, v, causal, scale, *drop),
        "dq": lambda: fa._dq_launch(q, k, v, do, lse, delta, causal, scale,
                                    *drop, route="fma"),
        "dq_wgmma": lambda: fa.flash_dq(q, k, v, do, lse, delta, causal,
                                        scale, *drop),
        "dkv": lambda: fa._dkv_launch(q, k, v, do, lse, delta, causal, scale,
                                      *drop, route="fma"),
        "dkv_wgmma": lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal,
                                          scale, *drop),
    }
    plain = {
        "fwd": lambda: fa.flash_fwd_plain(q, k, v, causal, scale, *drop),
        "dq": lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, causal,
                                        scale, *drop),
        "dkv": lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, causal,
                                          scale, *drop),
    }
    plain_ms = {}
    rows = {"sdpa_fwd_ms": lib["fwd"], "sdpa_bwd_ms": lib["bwd"],
            "sdpa_fwd_bwd_ms": lib_fwd_bwd_ms}
    for kind in kinds:
        base = kind.split("_")[0]
        if base not in plain_ms:
            plain_ms[base] = time_graph_ms(plain[base], reps=10, iters=2)
        row = {"ms": time_graph_ms(kern[kind], reps=10, iters=5),
               "plain_ms": plain_ms[base],
               "library_ms": lib["fwd" if base == "fwd" else "bwd"],
               "eager_ms": time_eager_ms(kern[kind], iters=10)}
        bias_bytes = 0 if bias is None else bias.numel() * 4
        row["bound_ms"], row["bound_by"] = flash_bound(
            base, b, sq, sk, hq, hk, d, dtype, causal, bias_bytes)
        also = ""
        if dtype == torch.float32:
            # the FMA kernels' own ceiling: fp32 FFMA
            row["bound_ffma_ms"] = flash_bound(
                base, b, sq, sk, hq, hk, d, dtype, causal, bias_bytes,
                peak=FP32_FLOPS)[0]
            also = (f" at 3xTF32's {TF32X3_FLOPS / 1e12:.0f} TFLOP/s, "
                    f"{row['bound_ffma_ms']:.4f} ms at FFMA's "
                    f"{FP32_FLOPS / 1e12:.0f}")
        rows[kind] = row
        log(f"  time flash_{kind} {name} {str(dtype)[6:]}: kernel "
            f"{row['ms']:.4f} ms (eager call {row['eager_ms']:.4f} ms), "
            f"plain {row['plain_ms']:.3f} ms, sdpa"
            f"{' with the attn_mask' if bias is not None else ''}"
            f"{f' and dropout_p {rate}' if rate else ''} "
            f"{'fwd' if base == 'fwd' else 'bwd alone'} "
            f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']}{also}")
    return rows


FLASH_KINDS = ("fwd", "fwd_wgmma", "dq", "dq_wgmma", "dkv", "dkv_wgmma")
WGMMA_KINDS = ("fwd_wgmma", "dq_wgmma", "dkv_wgmma")
FMA_KINDS = ("fwd", "dq", "dkv")
# the timed shapes: GPT-2's and Llama-2 7B's training attention on both
# routes; the Llama train cell's (B8 S2048 H16 D128) on the wgmma route;
# BERT-large's at its dropout 0.1 (the "keys" instantiations its
# train cell launches) and without dropout on the wgmma kernels, each
# beside the bias-free kernels at the same shape and dropout (sdpa then
# without the mask), and the "plane" bias class on the same mask
# materialised as [B, 1, Sq, Sk]; the FMA kernels at the three fp32
# oracles' shapes (BERT's with its key bias: the bias instantiations).
# The FMA route's bf16 forward, dq and dkv (fwd_mma_kernel, dq_mma_kernel,
# dkv_mma_kernel) at GPT-2's, Llama-2 7B's and BERT's shapes ("fwd", "dq"
# and "dkv" on a bf16 case) and at Gemma-7B's attention.
# (key, case, kinds[, bias_as])
FLASH_TIMED = (("gpt2", "gpt2-train", FLASH_KINDS),
               ("llama7b", "llama7b", FLASH_KINDS),
               ("llama07b_train", "llama-0.7b-train", WGMMA_KINDS),
               ("bert", "bert-keymask-dropout", WGMMA_KINDS + FMA_KINDS),
               ("gemma7b_d256", "gemma7b-d256", FMA_KINDS),
               ("bert_no_dropout", "bert-large-keymask", WGMMA_KINDS),
               ("bert_nobias", "bert-keymask-dropout", WGMMA_KINDS, "none"),
               ("bert_nobias_no_dropout", "bert-large-keymask", WGMMA_KINDS,
                "none"),
               ("bert_plane", "bert-keymask-dropout", WGMMA_KINDS, "plane"),
               ("bert_plane_no_dropout", "bert-large-keymask", WGMMA_KINDS,
                "plane"),
               ("bert_oracle_fp32", "bert-oracle-keymask-fp32", FMA_KINDS),
               ("gpt2_oracle_fp32", "gpt2-oracle-fp32", FMA_KINDS),
               ("llama_oracle_fp32", "llama-oracle-fp32", FMA_KINDS))


def phase_flash(fa, gen):
    """Flash kernels vs their plain versions on every case of FLASH_CASES
    (each on the route ``flash_route`` picks, and on a wgmma case the FMA
    kernels as well), the dropout keep-mask read back exactly in
    fp32 (FMA) and bf16 (wgmma and FMA), then the kernels timed at FLASH_TIMED's
    shapes. Returns (timing rows by FLASH_TIMED's key, each with its
    case's max |kernel - plain|; max |kernel - plain| by case and kernel,
    the share of its tolerance each check used)."""
    errs, used = {}, {}
    for case in FLASH_CASES:
        errs[case[0]], used[case[0]] = _flash_case(fa, gen, case)
        torch.cuda.empty_cache()

    # the keep-mask, read back exactly: with v = identity (Sk = D) each
    # output row is p_v / l, zero exactly where the mask drops a key
    b, s, h, d, rate = 2, 64, 3, 64, 0.1
    for dtype in (torch.float32, torch.bfloat16):
        q = (torch.randn(b, s, h, d, device="cuda", generator=gen) * 0.3
             ).to(dtype)
        k = (torch.randn(b, s, h, d, device="cuda", generator=gen) * 0.3
             ).to(dtype)
        v = torch.eye(s, device="cuda")[None, :, None, :].expand(
            b, s, h, d).contiguous().to(dtype)
        seed = torch.tensor([-424242], dtype=torch.int32, device="cuda")
        keep = fa.dropout_keep_mask(seed, b * h, s, s, rate)
        # bf16 on both routes: the wgmma forward and fwd_mma_kernel
        for route in dict.fromkeys((fa.flash_route(dtype, d), "fma")):
            out, _ = fa._fwd_launch(q, k, v, False, 1.0 / math.sqrt(d), rate,
                                    seed, route=route)
            got = (out != 0).permute(0, 2, 1, 3).reshape(b * h, s, s)
            if not torch.equal(got, keep):
                raise AssertionError(
                    f"dropout keep-mask ({str(dtype)[6:]}, {route} route) "
                    f"differs at {int((got != keep).sum())} of "
                    f"{keep.numel()}")
            log(f"  flash dropout keep-mask {str(dtype)[6:]} ({route} "
                f"kernel): identical at all {keep.numel()} positions "
                f"({1 - keep.float().mean().item():.4f} dropped, rate "
                f"{rate})")

    timed = {}
    for key, name, kinds, *bias_as in FLASH_TIMED:
        case = next(c for c in FLASH_CASES if c[0] == name)
        timed[key] = _flash_timings(fa, gen, case, kinds, *bias_as)
        if not bias_as:
            for kind in kinds:
                timed[key][kind]["max_abs_err"] = errs[name][kind]
        torch.cuda.empty_cache()
    return timed, errs, used


def ce_bound(kind: str, rows: int, v: int, dtype: torch.dtype):
    """(bound ms, bound_by) of a softmax-CE forward or backward: logits
    read once (and dx written once, backward), the int64 labels and the
    fp32 per-row values once each; about four fp32 operations per element
    (max, subtract, exp, add; subtract, exp, subtract, multiply)."""
    es = torch.finfo(dtype).bits // 8
    per_row = 8 + 2 * 4         # the int64 label; loss and lse, or lse and g
    nbytes = (1 if kind == "fwd" else 2) * rows * v * es + rows * per_row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * rows * v / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# (name, R, V, dtype, logit scale, storage offset): GPT-2's training
# logits (8 x 1024 tokens, vocab 50304, bf16), the same vocabulary in
# fp32, Llama's vocabulary, odd vocabularies (257: rows that do not start
# 16-byte aligned; 200 fp32: rows that do), logits x100, where a missing
# max subtraction overflows exp; then the forward's row-start classes:
# BERT's vocabulary at an odd row count (rows start 0, 4, 8 and 12 bytes
# past a 16-byte boundary), V = 30523 (rows only 2-byte aligned), fp32 at
# V % 4 = 3, contiguous views at storage offset 1 of a bf16 buffer and 3
# of an fp32 one (no row starts aligned), and rows shorter than a vector
# (V = 7, also at an offset; V = 2 in fp32 at an offset); then BERT-large's
# MLM logits (16 x 512 tokens, vocab 30522) and NSP logits (16 rows of 2),
# last, so that the earlier cases keep their inputs
CE_CASES = [
    ("gpt2-train", 8192, 50304, torch.bfloat16, 1.0, 0),
    ("gpt2-vocab-fp32", 1024, 50304, torch.float32, 1.0, 0),
    ("llama-vocab", 2048, 32000, torch.float32, 1.0, 0),
    ("odd-200", 13, 200, torch.float32, 1.0, 0),
    ("odd-257", 13, 257, torch.float32, 1.0, 0),
    ("odd-257-bf16", 13, 257, torch.bfloat16, 1.0, 0),
    ("scaled-x100", 512, 50304, torch.float32, 100.0, 0),
    ("v30522-odd-rows", 1023, 30522, torch.bfloat16, 1.0, 0),
    ("v30523-bf16", 255, 30523, torch.bfloat16, 1.0, 0),
    ("v32003-fp32", 255, 32003, torch.float32, 1.0, 0),
    ("v30522-bf16-offset-1", 255, 30522, torch.bfloat16, 1.0, 1),
    ("v32003-fp32-offset-3", 255, 32003, torch.float32, 1.0, 3),
    ("v7-bf16", 13, 7, torch.bfloat16, 1.0, 0),
    ("v7-bf16-offset-1", 13, 7, torch.bfloat16, 1.0, 1),
    ("v2-fp32-offset-3", 16, 2, torch.float32, 1.0, 3),
    ("bert-mlm", 8192, 30522, torch.bfloat16, 1.0, 0),
    ("bert-nsp", 16, 2, torch.bfloat16, 1.0, 0),
]
# entry-wise (check_close). loss and lse are fp32 at every dtype: the
# kernel and the plain version differ in the order of the row's sum (on
# the card the worst entry needed 9e-8, PERF.md; this is 5x that). dx is
# the same fp32 formula on the same lse (it matched exactly on the card);
# bf16 then rounds, and one bf16 ulp is at most 2^-7 of |dx|
CE_RTOL = {"fwd": 5e-7, "bwd": {torch.float32: 2e-6, torch.bfloat16: 1e-2}}


def _ce_inputs(gen, rows, v, dtype, scale, offset=0):
    """Logits (a contiguous [rows, v] view at ``offset`` elements into a
    flat buffer), labels with -1, V and V+5 among them (loss 0, gradient
    0), and a random cotangent."""
    dev = torch.device("cuda")
    flat = (torch.randn(rows * v + offset, device=dev, generator=gen)
            * scale).to(dtype)
    x = flat[offset:].view(rows, v)
    lab = torch.randint(0, v, (rows,), device=dev, generator=gen)
    for i, bad in enumerate((-1, v, v + 5)):
        lab[i * rows // 3] = bad
    g = torch.randn(rows, device=dev, generator=gen)
    return x, lab, g


def phase_ce(ce, gen):
    """CE forward and backward kernels vs their plain versions on every
    case of CE_CASES (the backward from the plain lse, so that it is held
    alone), then timed at GPT-2's training shape beside
    ``F.cross_entropy(reduction="none")`` forward, and forward plus
    backward, and at BERT's two (MLM and NSP). Returns (timing rows at
    GPT-2's shape, timing rows at BERT's by case, max |kernel - plain| by
    case, the share of its tolerance each check used)."""
    errs, used = {}, {}
    for name, rows, v, dtype, scale, offset in CE_CASES:
        x, lab, g = _ce_inputs(gen, rows, v, dtype, scale, offset)
        log(f"  softmax_xent {name}: [{rows},{v}] {str(dtype)[6:]} "
            f"scale {scale:g}, storage offset {offset} (x at "
            f"{x.data_ptr() % 16} mod 16 B)")
        loss, lse = ce.softmax_xent_fwd(x, lab)
        lossp, lsep = ce.softmax_xent_fwd_plain(x, lab)
        dx = ce.softmax_xent_bwd(x, lab, lsep, g)
        dxp = ce.softmax_xent_bwd_plain(x, lab, lsep, g)
        torch.cuda.synchronize()
        valid = (lab >= 0) & (lab < v)
        if not (torch.all(loss[~valid] == 0) and torch.all(dx[~valid] == 0)):
            raise AssertionError(f"{name}: an invalid label gave a nonzero "
                                 "loss or gradient")
        u, e = {}, {}
        e_loss, u["loss"] = check_close("loss", loss, lossp, CE_RTOL["fwd"])
        e_lse, u["lse"] = check_close("lse", lse, lsep, CE_RTOL["fwd"])
        e["fwd"] = max(e_loss, e_lse)
        e["bwd"], u["dx"] = check_close("dx", dx, dxp, CE_RTOL["bwd"][dtype])
        errs[name], used[name] = e, u
        del x, lab, g, loss, lse, lossp, lsep, dx, dxp
        torch.cuda.empty_cache()

    rows_out = _ce_timings(ce, gen, CE_CASES[0], errs, fwd_bwd=True)
    bert = {case[0]: _ce_timings(ce, gen, case, errs)
            for case in CE_CASES if case[0].startswith("bert-")}
    return rows_out, bert, errs, used


def _ce_timings(ce, gen, case, errs, fwd_bwd=False):
    """The CE kernels' device times at the case's shape beside their
    plain versions, their bound and F.cross_entropy; with ``fwd_bwd``
    also forward plus backward three ways (fwd_bwd_ms)."""
    name, rows, v, dtype, scale, offset = case
    x, lab, g = _ce_inputs(gen, rows, v, dtype, scale, offset)
    _, lse = ce.softmax_xent_fwd_plain(x, lab)
    # the library call takes invalid labels only as ignore_index
    lib_lab = torch.where((lab >= 0) & (lab < v), lab,
                          torch.full_like(lab, -100))
    xl = x.detach().clone().requires_grad_()
    xent = torch.nn.functional.cross_entropy

    def lib_fwd_bwd():
        out = xent(xl, lib_lab, reduction="none")
        torch.autograd.grad(out, xl, g.to(out.dtype))

    calls = {
        "fwd": (lambda: ce.softmax_xent_fwd(x, lab),
                lambda: ce.softmax_xent_fwd_plain(x, lab),
                lambda: xent(x, lib_lab, reduction="none")),
        "bwd": (lambda: ce.softmax_xent_bwd(x, lab, lse, g),
                lambda: ce.softmax_xent_bwd_plain(x, lab, lse, g),
                lib_fwd_bwd),
    }
    # forward plus backward, the three ways the reference can choose on
    # its card: both kernels (the port's path, through autograd as a
    # train step runs it), the forward kernel with the plain backward
    # from its lse ("pallas_xbwd"), and autograd through the plain
    # forward (its default, "xla")
    xv = x.detach().clone().requires_grad_()

    def fwd_kernel_plain_bwd():
        _, lse_k = ce.softmax_xent_fwd(x, lab)
        ce.softmax_xent_bwd_plain(x, lab, lse_k, g)

    three_ways = {
        "kernels": lambda: torch.autograd.grad(ce.softmax_xent(xv, lab), xv,
                                               g),
        "fwd_kernel_plain_bwd": fwd_kernel_plain_bwd,
        "plain_autograd": lambda: torch.autograd.grad(
            ce.softmax_xent_fwd_plain(xv, lab)[0], xv, g),
    }
    rows_out = {}
    if fwd_bwd:
        ms = {k: time_graph_ms(fn, reps=10, iters=3)
              for k, fn in three_ways.items()}
        log(f"  time softmax_xent forward + backward [{rows},{v}] bf16: "
            + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items()))
        rows_out["fwd_bwd_ms"] = ms
    for kind, (kern, plain, lib) in calls.items():
        row = {"ms": time_graph_ms(kern, reps=10, iters=5),
               "plain_ms": time_graph_ms(plain, reps=10, iters=2),
               "library_ms": time_graph_ms(lib, reps=10, iters=5),
               "eager_ms": time_eager_ms(kern, iters=20),
               "max_abs_err": errs[name][kind]}
        row["bound_ms"], row["bound_by"] = ce_bound(kind, rows, v, dtype)
        rows_out[kind] = row
        log(f"  time softmax_xent_{kind} {name} [{rows},{v}] bf16: kernel "
            f"{row['ms']:.4f} ms (eager call {row['eager_ms']:.4f} ms), "
            f"plain {row['plain_ms']:.4f} ms, F.cross_entropy "
            f"{'fwd' if kind == 'fwd' else 'fwd+bwd'} "
            f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
            f"by {row['bound_by']}")
    return rows_out


# the serving cells: (model family, config, norm kernel counted,
# prompt lengths, max_context). Both run at full width and depth in fp32
# with random weights; GPT-2's position table has 1024 rows, so its
# context is at most 1024 and its longest prompt (900) takes the 1024
# prefill bucket.
SERVE_CELLS = {
    "llama7b-fp32-decode8": ("llama", "llama_7b", "rms_norm",
                             (17, 40, 64, 100, 128, 200, 256, 300), 512),
    "gpt2s-fp32-decode8": ("gpt", "gpt2_small", "layer_norm",
                           (17, 64, 128, 200, 333, 512, 700, 900), 1024),
}


def _serve_model(cell, seed, device="cuda"):
    from paddle_tpu_torch import models
    from paddle_tpu_torch.core.random import make_generator
    family, cfg_name = SERVE_CELLS[cell][:2]
    cfg = getattr(models, cfg_name)()
    cls = (models.LlamaForCausalLM if family == "llama"
           else models.GPTForCausalLM)
    model = cls(cfg, device=device, generator=make_generator(seed, device))
    model.eval()
    return cfg, model


def phase_serve(cell, seed, card, device="cuda"):
    """Serve the cell's prompts through DecodeServer after ``warmup()``
    has captured every step signature; check that the counted run
    captures nothing, the exact launch counts (2 x layers + 1 norms per
    model step, prefill or decode, and no other kernel), a profiled
    replay's kernels, the teacher-forced contiguous-cache oracle, and
    that every step's tokens equal the same steps run eagerly. Returns
    (model, prompts, results, launches of the run)."""
    from paddle_tpu_torch.serving.decode import DecodeServer
    _, _, norm, prompt_lens, max_context = SERVE_CELLS[cell]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = _serve_model(cell, seed, device)
    torch.cuda.synchronize()
    norms_per_call = 2 * cfg.num_layers + 1
    nparams = sum(p.numel() for p in model.parameters())
    log(f"  {cell}: {cfg}, {nparams} params fp32, drawn on {device} "
        f"in {time.perf_counter() - t0:.2f} s")
    # warm the libraries (cuBLAS handles, allocator) outside the counted
    # run, with a one-off contiguous-cache step
    c = model.init_decode_cache(1, 16)
    model.decode_step(np.arange(8, dtype=np.int32)[None],
                      np.zeros(1, np.int32), c)
    torch.cuda.synchronize()
    del c

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in prompt_lens]
    srv = DecodeServer(model, max_slots=8, page_len=16,
                       max_context=max_context, device=device)
    recorded = []               # (host arrays, sampled tokens) per step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_warm = srv.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        log(f"  warmup: {n_warm} step signatures captured in {warm_s:.2f} s "
            f"({srv.bucket_config()})")
        real_run = srv._exec.run

        def run(host_arrays, pools):
            out = real_run(host_arrays, pools)
            recorded.append(([a.copy() for a in host_arrays], out[0]))
            return out
        srv._exec.run = run
        streams = [None] * len(prompts)

        def client(i):
            streams[i] = srv.submit(prompts[i], max_new_tokens=NEW_TOKENS)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        _reset_counts()                             # counted run starts
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        outs = [s.result(timeout=600) for s in streams]
        t_total = time.perf_counter() - t_start
        launches = _counts()                        # counted run ends
        st = srv.stats()
        n_exec = srv.num_executables()
        captures = srv._sf.compile_count
        arrays = next(a for a, _ in recorded if a[0].shape == (8, 1))
        profiled = _hold_profiled(
            f"{cell} batch-8 decode step",
            lambda: real_run(arrays, srv._pools),
            {norm: norms_per_call})
    finally:
        srv.shutdown()
        srv._exec.__dict__.pop("run", None)     # no cycle through the spy
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    if not (st["compile_count"] == n_exec == captures == n_warm):
        raise AssertionError(
            f"warmup captured {n_warm}; after the run compile_count "
            f"{st['compile_count']}, executables {n_exec}, captures "
            f"{captures}: the counted run captured")
    # the same steps eagerly: the step layer itself on pools of its own
    layer = srv._sf._layer
    pools = [torch.zeros_like(t) for t in srv._pools]
    del srv, real_run, run          # the server's pools and graphs
    torch.cuda.empty_cache()
    diff = []
    with torch.inference_mode():
        for i, (host, toks) in enumerate(recorded):
            out = layer(*[torch.from_numpy(a).to(device) for a in host],
                        *pools)
            if not torch.equal(out[0], toks):
                diff.append(i)
    del pools
    if diff:
        raise AssertionError(f"steps {diff[:8]} of {len(recorded)}: the "
                             f"replayed graph's tokens differ from the "
                             f"eager step's")
    log(f"  eager: the {len(recorded)} steps run eagerly give the replayed "
        f"graphs' tokens, every one")
    for i, o in enumerate(outs):
        if len(o) != NEW_TOKENS:
            raise AssertionError(f"request {i} gave {len(o)} tokens, "
                                 f"expected {NEW_TOKENS}")
    steps = st["prefills"] + st["decode_steps"]
    expect = dict.fromkeys(launches, 0)
    expect[norm] = norms_per_call * steps
    log(f"  served {len(outs)} requests: {st['prefills']} prefills + "
        f"{st['decode_steps']} decode steps, {norm} launches "
        f"{launches[norm]} (expected {norms_per_call} x {steps} = "
        f"{expect[norm]})")
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}: not "
                             f"every norm went through the kernel, or "
                             f"another kernel ran")
    if st["completed"] != len(prompts) or st["failed"]:
        raise AssertionError(f"server stats: {st}")

    # oracle: contiguous-cache decode_step, teacher-forced along the
    # server's own tokens; a token must be the argmax or a tie within
    # TIE_ATOL of the max logit
    worst_gap = 0.0
    for i in (0, len(prompts) - 1):
        p, toks = prompts[i], [int(t) for t in outs[i]]
        cache = model.init_decode_cache(1, len(p) + NEW_TOKENS)
        lg, cache = model.decode_step(p[None], np.zeros(1, np.int32), cache)
        rows = [lg[0, -1]]
        for j, t in enumerate(toks[:-1]):
            lg, cache = model.decode_step(
                np.asarray([[t]], np.int32),
                np.asarray([len(p) + j], np.int32), cache)
            rows.append(lg[0, 0])
        for j, (row, t) in enumerate(zip(rows, toks)):
            if not torch.isfinite(row).all():
                raise AssertionError(f"oracle logits not finite at {j}")
            gap = float(row.max() - row[t])
            worst_gap = max(worst_gap, gap)
            if gap > TIE_ATOL:
                raise AssertionError(
                    f"request {i} token {j}: server {t}, oracle argmax "
                    f"{int(row.argmax())}, gap {gap:.3e}")
        log(f"  oracle agrees on request {i} (prompt {len(p)}): "
            f"{len(toks)} tokens")
    total_tokens = sum(len(o) for o in outs)
    res = {
        "tokens_per_s": total_tokens / t_total,
        "wall_s": t_total,
        "ttft_ms_p50": st["ttft_ms"]["p50"],
        "ttft_ms_p99": st["ttft_ms"]["p99"],
        "decode_step_ms_p50": st["decode_step_ms"]["p50"],
        "decode_step_ms_max": st["decode_step_ms"]["max"],
        "prefill_ms_p50": st["prefill_ms"]["p50"],
        "prefill_ms_max": st["prefill_ms"]["max"],
        "batch_size_mean": st["batch_size"]["mean"],
        "prefills": st["prefills"], "decode_steps": st["decode_steps"],
        "launches": launches,
        "num_executables": n_exec,
        "warmup_captures": n_warm, "warmup_s": warm_s,
        "steps_equal_eager": len(recorded),
        "profiled": profiled,
        "peak_mem_bytes": peak,
        "peak_reserved_bytes": reserved,
        "oracle_worst_gap": worst_gap,
        "card": card,
    }
    log(f"  decode: {res['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{res['ttft_ms_p50']:.1f} ms, decode step p50 "
        f"{res['decode_step_ms_p50']:.2f} ms, prefill p50 "
        f"{res['prefill_ms_p50']:.1f} ms, peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    return model, prompts, res, launches


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "rms_norm_fwd_kernel" in n or "rms_norm_small_kernel" in n:
        return "rms_norm kernel"
    if "layer_norm_fwd_kernel" in n:
        return "layer_norm kernel"
    if any(k in n for k in ("gemm", "gemv", "splitk")):
        return "matmul (cuBLAS/CUTLASS)"
    if "softmax" in n:
        return "softmax"
    if any(k in n for k in ("gather", "index", "scatter")):
        return "gather/index (KV pages, embedding)"
    if "reduce" in n:
        return "reductions"
    return "elementwise/copy"


def phase_profile(cell, model, prompts, out_dir, device="cuda"):
    """A second round of the cell (not counted): once all 8 prompts are
    prefilled, ``torch.profiler`` records the batch-8 decode steps.
    Reports device time by kernel and by class, and the device's busy
    share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving.decode import DecodeServer
    srv = DecodeServer(model, max_slots=8, page_len=16,
                       max_context=SERVE_CELLS[cell][4], device=device)
    srv.warmup()                        # no capture inside the window
    # warmup=1: the profiler starts (and its set-up cost lands) while
    # the prefills run; prof.step() opens the recorded window once every
    # prompt has its first token, so it holds batch-8 decode steps only
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            streams = [srv.submit(p, max_new_tokens=24) for p in prompts]
            for s in streams:
                s.next_token(0, timeout=600)    # every prefill is done
            prof.step()
            steps0 = srv.stats()["decode_steps"]
            t0 = time.perf_counter()
            for s in streams:
                s.result(timeout=600)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        steps = srv.stats()["decode_steps"] - steps0
    finally:
        srv.shutdown()
    totals = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue                    # host-side op records
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if dt:
            totals[e.key] = totals.get(e.key, 0.0) + dt
    busy = sum(totals.values())
    classes = {}
    for k, v in totals.items():
        c = _kernel_class(k)
        classes[c] = classes.get(c, 0.0) + v
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:12]
    out = {"decode_steps": steps, "wall_us": wall_us, "busy_us": busy,
           "idle_share": 1.0 - busy / wall_us if wall_us else None,
           "classes_us_per_step": {c: v / max(steps, 1)
                                   for c, v in sorted(
                                       classes.items(), key=lambda kv: -kv[1])},
           "top_kernels_us": top}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"decode_profile-{cell}.txt"),
              "w") as f:
        f.write(json.dumps(out, indent=1) + "\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=30) + "\n")
    log(f"  profile: {steps} batch-8 decode steps in {wall_us / 1e3:.1f} ms"
        f" wall, device busy {busy / 1e3:.1f} ms (idle share "
        f"{out['idle_share']:.3f})")
    for c, v in out["classes_us_per_step"].items():
        log(f"    {v:10.1f} us/step  {c}")
    return out


OBSERVE_CELL = "gpt2s-fp32-decode8"
OBSERVE_STEPS = 4              # replayed decode steps under the Profiler
OBSERVE_DISPATCHES = 3         # run_steps dispatches with tracing on
# a request's life in the flight recorder, in this order
REQUEST_EVENTS = ("decode::enqueue", "decode::admit", "decode::prefill",
                  "decode::first_token", "decode::finish")


# the flight recorder off and on in turns (phase observe, e)
TRACING_TURNS = (False, True, True, False, False, True, True, False)


def _span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one ``trace_span(...)`` + ``end()`` and one
    ``trace_event`` as the decode loop calls them, tracing on and off
    (on: into a ring of the calling thread, reset after)."""
    from paddle_tpu_torch import profiler
    out = {}
    for on in (False, True):
        if on:
            profiler.enable_tracing()
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                profiler.trace_span("decode::step", cat="decode",
                                    batch=8).end()
            t1 = time.perf_counter()
            for _ in range(n):
                profiler.trace_event("decode::finish", cat="decode",
                                     trace_id="x", reason="length",
                                     tokens=32)
            t2 = time.perf_counter()
        finally:
            profiler.disable_tracing()
        key = "on" if on else "off"
        out[f"span_{key}"] = (t1 - t0) / n * 1e6
        out[f"event_{key}"] = (t2 - t1) / n * 1e6
    return out


def _burst(srv, prompts):
    """The prompts submitted from a client thread each, as the serve
    phase does; returns (token arrays, wall seconds)."""
    streams = [None] * len(prompts)

    def client(i):
        streams[i] = srv.submit(prompts[i], max_new_tokens=NEW_TOKENS)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    outs = [s.result(timeout=600) for s in streams]
    return outs, time.perf_counter() - t0


def _numeric_leaves(value) -> int:
    """The ``name value`` lines ``export_stats("text")`` gives ``value``:
    one per number or bool, one per list (its count)."""
    if isinstance(value, dict):
        return sum(_numeric_leaves(v) for v in value.values())
    return int(isinstance(value, (list, tuple, bool, int, float)))


def _hold_request_traces(events, n: int) -> dict:
    """Each of ``n`` trace ids carries REQUEST_EVENTS once each, their
    timestamps in that order; returns the mean gaps in ms."""
    by = {}
    for e in events:
        rid = e.get("args", {}).get("trace_id")
        if rid is not None and e["name"] in REQUEST_EVENTS:
            by.setdefault(rid, []).append(e)
    if len(by) != n:
        raise AssertionError(f"{len(by)} trace ids carry request events, "
                             f"expected {n}")
    gaps = {}
    for rid, evs in by.items():
        names = sorted(e["name"] for e in evs)
        if names != sorted(REQUEST_EVENTS):
            raise AssertionError(f"request {rid}: events {names}, expected "
                                 f"each of {REQUEST_EVENTS} once")
        ts = {e["name"]: e["ts"] for e in evs}
        seq = [ts[k] for k in REQUEST_EVENTS]
        if seq != sorted(seq):
            raise AssertionError(f"request {rid}: timestamps {seq} go "
                                 f"backwards along {REQUEST_EVENTS}")
        for a, b in zip(REQUEST_EVENTS, REQUEST_EVENTS[1:]):
            gaps.setdefault(f"{a}->{b}", []).append((ts[b] - ts[a]) / 1e3)
    return {k: float(np.mean(v)) for k, v in gaps.items()}


def _profiled_decode_steps(replay, norm: str, per_step: int,
                           out_dir) -> dict:
    """``Profiler(targets=[CPU, GPU])`` over OBSERVE_STEPS calls of
    ``replay`` (one batch-8 decode step), each inside a ``RecordEvent``
    and synchronised there. The exported chrome trace must hold as many
    ``norm`` kernel events as its counter rose (a shorter record is
    profiled again, as ``_hold_profiled`` does), each starting inside a
    step's scope, ``per_step`` a scope. Returns the device time of each
    step: first kernel start to last kernel end, and the kernels' sum."""
    from paddle_tpu_torch import profiler
    targets = [profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU]
    cls = _counter_class(norm)
    path = os.path.join(out_dir, "observe_decode_profile.json")
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        before = _counts()[norm]
        with profiler.Profiler(targets=targets) as p:
            for i in range(OBSERVE_STEPS):
                with profiler.RecordEvent(f"observe::step{i}"):
                    replay()
                    torch.cuda.synchronize()
        launched = _counts()[norm] - before
        p.export(path)
        with open(path) as f:
            doc = json.load(f)
        kernels = [e for e in doc["traceEvents"] if e["cat"] == "kernel"]
        norms = [e for e in kernels
                 if _train_kernel_class(e["name"]) == cls]
        log(f"  profiler (call {attempt}): {len(norms)} {cls} events in "
            f"the exported trace, {launched} launches counted; "
            f"{len(kernels)} device events, {len(doc['traceEvents'])} in all")
        if len(norms) == launched:
            break
        if len(norms) > launched:
            raise AssertionError(f"{len(norms)} {cls} events, {launched} "
                                 f"launches")
    else:
        raise AssertionError(f"the exported trace holds {len(norms)} {cls} "
                             f"events, {launched} launches were counted")
    scopes = sorted((e for e in doc["traceEvents"] if e["cat"] == "user"
                     and e["name"].startswith("observe::step")),
                    key=lambda e: e["ts"])
    if len(scopes) != OBSERVE_STEPS:
        raise AssertionError(f"{len(scopes)} step scopes in the trace")
    steps = []
    for sc in scopes:
        lo, hi = sc["ts"], sc["ts"] + sc["dur"]
        inside = [k for k in kernels if lo <= k["ts"] <= hi]
        n = sum(1 for k in inside if k in norms)
        if n != per_step:
            raise AssertionError(f"{sc['name']}: {n} {cls} events start "
                                 f"inside its scope, expected {per_step}: "
                                 f"scopes and kernels on two time axes")
        steps.append({
            "span_ms": (max(k["ts"] + k["dur"] for k in inside)
                        - min(k["ts"] for k in inside)) / 1e3,
            "busy_ms": sum(k["dur"] for k in inside) / 1e3,
            "kernels": len(inside)})
    return {"calls": attempt, "launches": launched, "steps": steps,
            "trace": path}


def _hold_scope_in_capture() -> dict:
    """A call with a ``RecordEvent`` inside, captured while a device
    Profiler records: the capture succeeds, its replay's kernels in
    CUPTI's records are the eager call's, and it computes the eager
    call's values."""
    from paddle_tpu_torch import jit, profiler
    targets = [profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU]

    def f(x):
        with profiler.RecordEvent("observe::inside_capture"):
            return torch.tanh(x) * 2 + 1

    x = torch.randn(4096, device="cuda")
    sf = jit.StaticFunction(f)
    with profiler.Profiler(targets=targets), torch.no_grad():
        sf(x)                           # warm-up and capture
        torch.cuda.synchronize()
    (graph,) = sf._live.values()

    def kernels(fn):
        for _ in range(PROFILE_TRIES):
            with profiler.Profiler(targets=targets) as p:
                fn()
                torch.cuda.synchronize()
            got = sorted(e.name for e in p.events if e.category == "kernel")
            if got:
                return got
        return got

    with torch.no_grad():
        eager, replayed = kernels(lambda: f(x)), kernels(graph.replay)
        same = torch.equal(sf(x), f(x))
    if replayed != eager or not same:
        raise AssertionError(f"a scope inside the capture: the replay "
                             f"launched {replayed}, the eager call {eager}; "
                             f"values equal: {same}")
    log(f"  a RecordEvent inside a capture under the Profiler: the replay "
        f"launches the eager call's {len(eager)} kernels and its values")
    return {"kernels": eager}


def _observe_run_steps(seed, device="cuda") -> dict:
    """``run_steps`` with tracing on at the run_steps cell's width:
    OBSERVE_DISPATCHES dispatches of ``steps=K, accumulate=M`` after the
    step's first call (its capture)."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.models import create_multistep_train_step, run_steps
    from paddle_tpu_torch.optimizer import AdamW
    K, M, micro = TRAINLOOP_K, TRAINLOOP_M, 4
    cfg, (m,) = _gpt2_twins(seed, 1, device=device, bf16=True)
    seq = cfg.max_position_embeddings
    rng = np.random.RandomState(seed + 5)

    def dispatch():
        bs = _loop_batches(rng, cfg.vocab_size, seq, K, micro)
        return tuple(torch.as_tensor(np.stack([b[i] for b in bs]),
                                     device=device) for i in (0, 1))

    step = create_multistep_train_step(
        m, AdamW(TRAIN_LR, parameters=m.parameters(), weight_decay=0.01),
        steps=K, accumulate=M)
    first = profiler.compile_count()
    step(*dispatch(), TRAIN_LR)
    _sync(device)
    c0 = profiler.compile_count()
    feed = [dispatch() for _ in range(OBSERVE_DISPATCHES)]
    profiler.enable_tracing()
    _reset_counts()                                 # counted run starts
    try:
        losses = run_steps(step, feed, lr=TRAIN_LR)
        _sync(device)
        counts = _counts()                          # counted run ends
    finally:
        profiler.disable_tracing()
    spans = {}
    for e in profiler.snapshot_events():
        if e["name"].startswith("train::"):
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    n = OBSERVE_DISPATCHES
    want = {"train::feed_wait": n, "train::dispatch": n, "train::fetch": n}
    if spans != want:
        raise AssertionError(f"run_steps spans {spans}, expected {want}")
    if c0 - first != 1 or profiler.compile_count() != c0:
        raise AssertionError(f"captures: {c0 - first} at the first call "
                             f"(expected 1), "
                             f"{profiler.compile_count() - c0} in run_steps "
                             f"(expected 0)")
    expect = _expected_counts(cfg.num_layers, M * K * n, "wgmma")
    if counts != expect:
        raise AssertionError(f"run_steps launches {counts}, expected "
                             f"{expect}")
    if not all(np.isfinite(v).all() and v.shape == (K,) for v in losses):
        raise AssertionError(f"run_steps losses {losses}")
    log(f"  run_steps traced: {spans}, one capture at the first call and "
        f"none after; launches as the run_steps cell's")
    return {"spans": spans, "launches": counts,
            "losses": [v.tolist() for v in losses]}


def phase_observe(seed, card, out_dir, device="cuda") -> dict:
    """The flight recorder, the Profiler, the device API and the stats
    registries on the captured GPT-2 small server (module docstring,
    10a-e)."""
    from paddle_tpu_torch import device as pdev
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.serving.decode import DecodeServer
    _, _, norm, prompt_lens, max_context = SERVE_CELLS[OBSERVE_CELL]
    cfg, model = _serve_model(OBSERVE_CELL, seed, device)
    per_step = 2 * cfg.num_layers + 1
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in prompt_lens]
    profiler.disable_tracing()
    profiler.reset_tracing()
    res = {"card": card}
    srv = DecodeServer(model, max_slots=8, page_len=16,
                       max_context=max_context, device=device,
                       name="observe")
    try:
        c0 = profiler.compile_count()
        n_warm = srv.warmup()
        if profiler.compile_count() - c0 != n_warm:
            raise AssertionError(f"warmup captured {n_warm}, compile_count "
                                 f"rose {profiler.compile_count() - c0}")
        # (a) a burst with the flight recorder on
        real_run = srv._exec.run
        decode_args = []

        def run(host_arrays, pools):
            if host_arrays[0].shape == (8, 1):
                decode_args[:] = [[a.copy() for a in host_arrays]]
            return real_run(host_arrays, pools)
        srv._exec.run = run
        c1 = profiler.compile_count()
        profiler.enable_tracing()
        _reset_counts()                             # counted run starts
        try:
            outs, wall = _burst(srv, prompts)
            launches = _counts()                    # counted run ends
        finally:
            profiler.disable_tracing()
            srv._exec.__dict__.pop("run", None)
        events = profiler.snapshot_events()
        st = srv.stats()
        tokens = sum(len(o) for o in outs)
        gaps = _hold_request_traces(events, len(prompts))
        steps = sum(1 for e in events if e["name"] == "decode::step")
        if steps != st["decode_steps"]:
            raise AssertionError(f"{steps} decode::step spans, "
                                 f"decode_steps {st['decode_steps']}")
        if profiler.compile_count() != c1:
            raise AssertionError(f"the traced run captured "
                                 f"{profiler.compile_count() - c1}")
        if profiler.decode_stats("observe") != srv.stats():
            raise AssertionError("decode_stats('observe') differs from "
                                 "server.stats()")
        text = profiler.export_stats("text")
        lines = text.strip().splitlines()
        leaves = _numeric_leaves(profiler.export_stats())
        served = [ln for ln in lines if ln.startswith(
            "paddle_tpu_decode_observe_tokens_generated ")]
        if len(lines) != leaves or served != [
                f"paddle_tpu_decode_observe_tokens_generated {tokens}"]:
            raise AssertionError(f"export_stats text: {len(lines)} lines "
                                 f"for {leaves} numeric leaves; {served} "
                                 f"for {tokens} tokens served")
        expect = dict.fromkeys(launches, 0)
        expect[norm] = per_step * (st["prefills"] + st["decode_steps"])
        if launches != expect or st["completed"] != len(prompts):
            raise AssertionError(f"launches {launches}, expected {expect}; "
                                 f"stats {st}")
        path = profiler.export_trace(os.path.join(out_dir,
                                                  "observe_trace.json"))
        with open(path) as f:
            doc = json.load(f)
        if set(doc.get("paddleTrace", {})) != {
                "pid", "metadata", "clock_offsets", "compile_count"}:
            raise AssertionError(f"export_trace: {sorted(doc)}")
        log(f"  trace: {len(prompts)} requests each enqueue -> admit -> "
            f"prefill -> first_token -> finish (mean gaps ms {gaps}); "
            f"{steps} decode::step spans = decode_steps; no capture; "
            f"decode_stats = stats(); {len(lines)} scrape lines; "
            f"{len(events)} events exported to {path}")
        res.update({"launches": launches, "decode_steps": steps,
                    "request_gaps_ms": gaps, "warmup_captures": n_warm,
                    "scrape_lines": len(lines),
                    "tokens_per_s": tokens / wall})

        # (b) the Profiler over replayed decode steps
        (arrays,) = decode_args
        res["profiler"] = _profiled_decode_steps(
            lambda: real_run(arrays, srv._pools), norm, per_step, out_dir)
        res["scope_in_capture"] = _hold_scope_in_capture()

        # (c) the device API
        start = pdev.Event(enable_timing=True)
        end = pdev.Event(enable_timing=True)
        ev_ms = []
        for _ in range(5):
            pdev.synchronize()
            start.record()
            real_run(arrays, srv._pools)
            end.record()
            end.synchronize()
            ev_ms.append(start.elapsed_time(end))
        prof_steps = res["profiler"]["steps"]
        log(f"  device.Event: a replayed batch-8 decode step {ev_ms} ms; "
            f"the Profiler's device span per step "
            f"{[round(s['span_ms'], 4) for s in prof_steps]} ms, kernels "
            f"busy {[round(s['busy_ms'], 4) for s in prof_steps]} ms "
            f"[{card}]")
        pdev.synchronize()
        mine, theirs = pdev.memory_stats(), torch.cuda.memory_stats()
        want = {"bytes_in_use": theirs["allocated_bytes.all.current"],
                "peak_bytes_in_use": theirs["allocated_bytes.all.peak"],
                "bytes_limit": torch.cuda.get_device_properties(
                    0).total_memory,
                "num_allocs": theirs["allocation.all.allocated"]}
        if mine != want or pdev.cuda.max_memory_allocated() != \
                torch.cuda.max_memory_allocated():
            raise AssertionError(f"device.memory_stats {mine}, "
                                 f"torch.cuda.memory_stats {want}")
        res["device"] = {"event_ms": ev_ms, "memory_stats": mine}

        # (e) the cost of tracing: a span's host cost, then bursts with
        # the flight recorder off and on in turns, each with the garbage
        # collections it ran
        res["span_us"] = _span_cost_us()
        log(f"  one trace_span + end(), one trace_event on this host (us): "
            f"{res['span_us']}")
        hist = srv._metrics._hists["decode_step_ms"]
        res["tracing_cost"] = []
        for turn, on in enumerate(TRACING_TURNS):
            if on:
                profiler.enable_tracing()
            n0 = hist.count
            gc0 = [g["collections"] for g in gc.get_stats()]
            try:
                outs, wall = _burst(srv, prompts)
            finally:
                profiler.disable_tracing()
            gcs = [g["collections"] - c
                   for g, c in zip(gc.get_stats(), gc0)]
            if hist.count > len(hist._ring):
                raise AssertionError("the decode_step_ms reservoir wrapped")
            samples = hist._ring[n0:hist.count]
            p50 = float(np.percentile(samples, 50))
            tps = sum(len(o) for o in outs) / wall
            res["tracing_cost"].append({
                "tracing": on, "tokens_per_s": tps,
                "decode_step_ms_p50": p50,
                "decode_step_ms_mean": float(np.mean(samples)),
                "gc_collections": gcs})
            log(f"  tracing {'on ' if on else 'off'} turn {turn}: "
                f"{tps:.1f} tokens/s, decode step p50 {p50:.3f} ms, mean "
                f"{np.mean(samples):.3f} ms over {len(samples)} steps; gc "
                f"collections by generation {gcs} [{card}]")
    finally:
        srv.shutdown()
        srv._exec.__dict__.pop("run", None)
    del srv, model
    torch.cuda.empty_cache()
    # (d) run_steps with tracing on
    res["run_steps"] = _observe_run_steps(seed, device)
    torch.cuda.empty_cache()
    return res


PHASES = ("kernels", "serve", "train", "bert", "llama", "trainloop",
          "observe")
TRAIN_STEPS = 20
TRAIN_LR = 3e-4
BERT_LR = 1e-4
BERT_CELL = "bert-large-bf16-pretrain-b16"
BERT_MASK_ID = 103                      # [MASK] in BERT's vocabulary
LLAMA_CELL = "llama-0.7b-bf16-train-b8"


def _counts() -> dict:
    """Every kernel's launch count, by the name the kernels line gives it
    (a captured step's launches count at every replay)."""
    from paddle_tpu_torch.ops.kernels import launch_counters
    return {k: w.launches for k, w in launch_counters().items()}


def _reset_counts():
    from paddle_tpu_torch.ops.kernels import launch_counters
    for w in launch_counters().values():
        w.launches = 0


def _expected_counts(layers: int, steps: int, route: str,
                     norms: int = None, ces: int = 1,
                     bias: bool = False, norm: str = "layer_norm",
                     fwds: int = None) -> dict:
    """Per train step: one flash forward, one dq and one dkv per layer on
    the kernels of ``route`` ("wgmma" for bf16, "fma" for fp32), their
    bias instantiations with ``bias`` (a padding mask: on the wgmma route
    the "keys" class), and none of the others; ``norms`` launches of the
    ``norm`` kernel ("layer_norm" or "rms_norm"; by default two per layer
    and the final one); ``ces`` CE forwards and as many CE backwards
    (GPT-2: one); ``fwds`` flash forwards per step when a replay adds to
    the layers' own."""
    norms = 2 * layers + 1 if norms is None else norms
    fwds = layers if fwds is None else fwds
    sfx = _sfx(route) + (("_keybias" if route == "wgmma" else "_bias")
                         if bias else "")
    out = dict.fromkeys(_counts(), 0)
    out.update({f"flash_fwd{sfx}": fwds * steps,
                f"flash_dq{sfx}": layers * steps,
                f"flash_dkv{sfx}": layers * steps,
                norm: norms * steps,
                "softmax_xent_fwd": ces * steps,
                "softmax_xent_bwd": ces * steps})
    return out


def phase_train_oracle(seed):
    """One train step of GPT-2 small's widths (2 layers, fp32, batch
    1 x 1024) on the card through the kernels and on the CPU through the
    plain versions, from the same weights and batch."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import (GPTForCausalLM, create_train_step,
                                         gpt2_small)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt2_small()
    cfg.num_layers, cfg.dropout = 2, 0.0
    cpu = GPTForCausalLM(cfg, device="cpu",
                         generator=make_generator(seed, "cpu"))
    gpu = GPTForCausalLM(cfg, device="cuda",
                         generator=make_generator(seed, "cuda"))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (1, cfg.max_position_embeddings + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    steps = {m: create_train_step(m, AdamW(TRAIN_LR, parameters=m.parameters(),
                                           weight_decay=0.01))
             for m in (cpu, gpu)}
    _reset_counts()
    loss_gpu = float(steps[gpu](x, y, TRAIN_LR))
    counts = _counts()
    t0 = time.perf_counter()
    loss_cpu = float(steps[cpu](x, y, TRAIN_LR))
    log(f"  oracle: loss card {loss_gpu:.6f}, CPU plain {loss_cpu:.6f} "
        f"({time.perf_counter() - t0:.1f} s on the CPU); launches {counts}")
    expect = _expected_counts(cfg.num_layers, 1, "fma")
    if counts != expect:
        raise AssertionError(f"oracle launches {counts}, expected {expect}")
    if not abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError("oracle loss differs beyond rtol 1e-4")
    worst, vanishing = _hold_oracle_grads(cpu, gpu)
    return {"loss_card": loss_gpu, "loss_cpu": loss_cpu,
            "worst_grad_rel": worst, "k_proj_bias_grad_rel": vanishing,
            "launches": counts}


def _hold_oracle_grads(cpu, gpu):
    """Every gradient of ``gpu`` within 1e-3 of its own max-abs of
    ``cpu``'s. The key projection's bias has a zero gradient in exact
    arithmetic (it shifts each query row's scores by one constant, which
    the softmax cancels), so what both sides hold there is rounding
    noise: it is held instead to 1e-6 of the largest gradient magnitude
    of the model, on both sides. Returns (the worst relative difference,
    the k_proj biases' magnitudes)."""
    gpu_params = dict(gpu.named_parameters())
    top = max(float(p.grad.abs().max()) for p in cpu.parameters())
    worst, vanishing = 0.0, {}
    for n, p in cpu.named_parameters():
        g_ref, g = p.grad, gpu_params[n].grad.cpu()
        if n.endswith("self_attn.k_proj.bias"):
            mag = max(float(g_ref.abs().max()), float(g.abs().max())) / top
            vanishing[n] = mag
            if not mag <= 1e-6:
                raise AssertionError(f"oracle grad {n}: {mag:.3e} of the "
                                     f"largest gradient, expected ~0")
            continue
        rel = float((g - g_ref).abs().max()) / max(float(g_ref.abs().max()),
                                                   1e-30)
        worst = max(worst, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"oracle grad {n}: max diff {rel:.3e} of "
                                 f"its max-abs > 1e-3")
    log(f"  oracle: {len(gpu_params) - len(vanishing)} gradients agree, "
        f"worst max diff {worst:.3e} of the tensor's max-abs (bound 1e-3)"
        + (f"; k_proj biases zero up to {max(vanishing.values()):.2e} of "
           f"the largest gradient" if vanishing else ""))
    return worst, vanishing


def _train_kernel_class(name: str) -> str:
    n = name.lower()
    # first match wins: "fwd_kernel<" is also a substring of the CE and
    # LayerNorm forward kernels' names, so those come before it
    for key, cls in (("fwd_sm90_kernel", "flash fwd wgmma kernel"),
                     ("fwd_fp32_kernel", "flash fwd kernel"),
                     ("dq_fp32_kernel", "flash dq kernel"),
                     ("dkv_fp32_kernel", "flash dkv kernel"),
                     ("fwd_overlap_sm90_kernel", "flash fwd wgmma kernel"),
                     ("dq_sm90_kernel", "flash dq wgmma kernel"),
                     ("dkv_sm90_kernel", "flash dkv wgmma kernel"),
                     ("dkv128_sm90_kernel", "flash dkv wgmma kernel"),
                     ("softmax_xent_fwd_kernel", "CE fwd kernel"),
                     ("softmax_xent_bwd_kernel", "CE bwd kernel"),
                     ("layer_norm_fwd_kernel", "layer_norm kernel"),
                     ("rms_norm_fwd_kernel", "rms_norm kernel"),
                     ("rms_norm_small_kernel", "rms_norm kernel"),
                     ("fwd_mma_kernel", "flash fwd mma kernel"),
                     ("dq_mma_kernel", "flash dq mma kernel"),
                     ("dkv_mma_kernel", "flash dkv mma kernel"),
                     ("fwd_kernel<", "flash fwd kernel"),
                     ("dq_kernel", "flash dq kernel"),
                     ("dkv_kernel", "flash dkv kernel")):
        if key in n:
            return cls
    if any(k in n for k in ("gemm", "gemv", "splitk", "cutlass", "sm90_xmma",
                            "nvjet")):
        return "matmul (cuBLAS/CUTLASS)"
    if "softmax" in n or "logsumexp" in n:
        return "softmax / logsumexp"
    if any(k in n for k in ("reduce", "sum")):
        return "reductions"
    if any(k in n for k in ("gather", "index", "scatter", "embedding")):
        return "gather/scatter (embedding, CE)"
    return "elementwise/copy"


def _counter_class(name: str) -> str:
    """The kernel class (``_train_kernel_class``) whose launches the
    counter ``name`` counts."""
    fixed = {"rms_norm": "rms_norm kernel",
             "layer_norm": "layer_norm kernel",
             "softmax_xent_fwd": "CE fwd kernel",
             "softmax_xent_bwd": "CE bwd kernel"}
    if name in fixed:
        return fixed[name]
    kind = name.split("_")[1]
    route = ("wgmma " if "_wgmma" in name else
             "mma " if "_mma" in name else "")
    return f"flash {kind} {route}kernel"


PROFILE_TRIES = 3


def _hold_profiled(what, fn, expect) -> dict:
    """One call of ``fn`` (a replayed step) under ``torch.profiler``:
    CUPTI's kernel records, classed by ``_train_kernel_class``, must show
    each kernel of ``expect`` (the launch counts of one call) exactly as
    often, and no other of the port's kernels: the proof that the
    kernels run inside the replayed graph. CUPTI now and then drops a
    record (one Llama replay of five, whose graph never changes, showed
    3072 of its 3075 records and 24 of its 25 RMSNorms), so a replay that
    shows fewer is profiled again, up to ``PROFILE_TRIES`` calls in all;
    one that shows more, or another of the port's kernels, fails at
    once. Returns the counts by class and the calls it took."""
    from torch.profiler import ProfilerActivity, profile
    want = {}
    for k, n in expect.items():
        if n:
            want[_counter_class(k)] = want.get(_counter_class(k), 0) + n
    ours = {_counter_class(k) for k in _counts()}
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                c = _train_kernel_class(e.key)
                seen[c] = seen.get(c, 0) + e.count
        got = {c: seen.get(c, 0) for c in sorted(ours) if c in want
               or seen.get(c)}
        log(f"  profiled replay ({what}, call {attempt}): {got} (expected "
            f"{want}); {sum(seen.values())} kernel records in all")
        if got == want:
            return {"kernels": got, "classes": seen, "calls": attempt}
        if set(got) != set(want) or any(got[c] > want[c] for c in got):
            break
    raise AssertionError(f"{what}: the profiled replay shows {got}, "
                         f"expected {want}: the kernels did not run "
                         f"inside the graph as counted")


def _loss_call(model, loss_fn):
    if loss_fn is None:
        return lambda ids, labels: model.loss(ids, labels)
    return lambda ids, labels: loss_fn(model, ids, labels)


def _eager_step(model, opt, loss_fn, x, y, lr, accumulate=None):
    """The smoke's own eager step, as ``create_train_step`` (``accumulate
    None``) or ``create_multistep_train_step`` (x, y stacked ``[K, M, B,
    S]`` for ``accumulate`` M > 1, else ``[K, B, S]``) computes it: the
    trainer's weight-decay mask, fp32 gradient sums over microbatches."""
    call = _loss_call(model, loss_fn)
    mask = {id(p): _decays(n) for n, p in model.named_parameters()}

    def one(xi, yi):
        opt.zero_grad(set_to_none=True)
        loss = call(xi, yi)
        loss.backward()
        opt.apply_gradients(lr, wd_mask=mask)
        return loss.detach()

    if accumulate is None:
        return one(x, y)
    losses = []
    for i in range(x.shape[0]):
        if accumulate == 1:
            losses.append(one(x[i], y[i]))
            continue
        params = list(model.parameters())
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        lsum = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(accumulate):
            opt.zero_grad(set_to_none=True)
            loss = call(x[i, j], y[i, j])
            loss.backward()
            with torch.no_grad():
                for s_, p in zip(gsum, params):
                    s_.add_(p.grad.float())
                lsum = lsum + loss.detach().float()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            grads = {id(p): s_.div_(accumulate)
                     for s_, p in zip(gsum, params)}
        opt.apply_gradients(lr, wd_mask=mask, grads=grads)
        losses.append(lsum / accumulate)
    return torch.stack(losses)


def _cell_start() -> int:
    """Reset the allocator's peak at a train cell's start; return and log
    what is allocated then (what the earlier cells left), by stream (the
    default stream, the capture stream of ``paddle_tpu_torch.jit``, or
    another), memory pool and block size."""
    from paddle_tpu_torch import jit
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    names = {torch.cuda.current_stream().cuda_stream: "default", 0: "default"}
    names.update({s.cuda_stream: "capture" for s in jit._streams.values()})
    held = {}
    for seg in torch.cuda.memory_snapshot():
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                stream = seg.get("stream", -1)
                key = (names.get(stream, hex(stream)),
                       tuple(seg.get("segment_pool_id") or ()), b["size"])
                held[key] = held.get(key, 0) + 1
    top = sorted(held.items(), key=lambda kv: -kv[0][2] * kv[1])[:8]
    log(f"  allocated at the cell's start: {at_start / 2**30:.3f} GiB; "
        f"largest by (stream, pool, block MiB) x count: "
        + ", ".join(f"({k[0]}, {k[1]}, {k[2] / 2**20:.1f}) x {n}"
                    for k, n in top))
    return at_start


def _noting_peaks(graphs, marks: dict):
    """Wrap the warm-up and the capture of ``graphs`` (a step's
    ``jit.Graphs``) so that each, when it ends, notes in ``marks`` the
    allocator's peak so far and what is allocated."""
    for name in ("warm_up", "capture"):
        def noted(*a, _fn=getattr(graphs, name), _name=name, **k):
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            marks[_name] = (torch.cuda.max_memory_allocated(),
                            torch.cuda.memory_allocated())
            return out
        setattr(graphs, name, noted)


def _hold_captured_equals_eager(what, model, make_opt, make_step, batches,
                                lr, loss_fn=None, accumulate=None):
    """Snapshot the parameters (in host memory) and the model's
    generators; run ``batches`` through the smoke's own eager loop
    (``_eager_step``); restore the snapshot; run them through
    ``make_step(model, opt)`` on a fresh optimizer, captured (the first
    call runs eagerly on the capture stream and is captured, the others
    replay). Losses and every parameter must be equal to the last bit.
    Returns (optimizer, step, the captured losses, the first call's
    seconds, memory): the allocator's peak over the eager steps and, from
    a reset after them, over the first call's warm-up, its capture, and
    the captured steps, with what is allocated after each, and the bytes
    of one set of gradients."""
    from paddle_tpu_torch.jit import _module_generators
    gens = _module_generators(model)
    params = list(model.parameters())
    snap = [p.detach().to("cpu", copy=True) for p in params]
    states = [g.get_state() for g in gens]
    torch.cuda.reset_peak_memory_stats()
    opt = make_opt(model)
    eager = [_eager_step(model, opt, loss_fn, x, y, lr, accumulate)
             for x, y in batches]
    torch.cuda.synchronize()
    mem = {"eager_peak": torch.cuda.max_memory_allocated(),
           "grads": sum(p.numel() * p.element_size() for p in params)}
    eager_params = [p.detach().to("cpu", copy=True) for p in params]
    del opt
    with torch.no_grad():
        for p, v in zip(params, snap):
            p.copy_(v)
    for g, st in zip(gens, states):
        g.set_state(st)
    del snap
    model.zero_grad(set_to_none=True)
    # the cell's peak memory is the captured run's: from here on
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = make_opt(model)
    step = make_step(model, opt)
    marks = {}
    _noting_peaks(step._graphs, marks)
    torch.cuda.synchronize()
    mem["before"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = [step(*batches[0], lr)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got += [step(x, y, lr) for x, y in batches[1:]]
    torch.cuda.synchronize()
    for name in ("warm_up", "capture"):
        mem[f"{name}_peak"], mem[f"after_{name}"] = marks[name]
        delattr(step._graphs, name)
    mem["steps_peak"] = torch.cuda.max_memory_allocated()
    mem["after_steps"] = torch.cuda.memory_allocated()
    bad = [i for i, (a, b) in enumerate(zip(got, eager))
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(
            f"{what}: captured losses {[v.tolist() for v in got]} differ "
            f"from the eager steps' {[v.tolist() for v in eager]}")
    names = [n for n, _ in model.named_parameters()]
    unequal = [(n, int((p != q).sum()), float((p.float() - q.float())
                                              .abs().max()))
               for n, p, q in ((n, p.detach().cpu(), q) for n, p, q in
                               zip(names, params, eager_params))
               if not torch.equal(p, q)]
    if unequal:
        raise AssertionError(f"{what}: after {len(batches)} captured steps "
                             f"these parameters differ from the eager "
                             f"steps' (name, entries, max diff): "
                             f"{unequal[:8]}")
    log(f"  captured = eager: {len(batches)} steps from one snapshot "
        f"(the model's {len(gens)} generators restored), losses "
        f"{[v.tolist() for v in got]} and {len(params)} parameters equal "
        f"to the last bit; first call (eager step + capture) "
        f"{first_s:.2f} s")
    log("  memory (GiB): " + ", ".join(
        f"{k} {v / 2**30:.3f}" for k, v in mem.items()))
    return opt, step, got, first_s, mem


def _timed_replays(step, x, y, lr, n=TRAIN_STEPS):
    """``n`` calls of a captured step, counted and timed: returns (losses,
    ms per step, launches, the bytes the allocator holds after them: live
    tensors, the graph pool and its cache)."""
    _reset_counts()                                  # counted run starts
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step(x, y, lr))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    counts = _counts()                               # counted run ends
    return losses, ms, counts, torch.cuda.memory_reserved()


def _hold_recompute_captured(what, make_model, x, y):
    """For each recompute policy, ``make_model(policy)`` (every layer
    recomputed, bf16): 3 captured steps equal to 3 eager ones from one
    snapshot (under capture the replay reads the forward's draws back;
    eagerly it restores the generators and draws again)."""
    from paddle_tpu_torch.models import create_train_step, write_back
    from paddle_tpu_torch.optimizer import AdamW
    res = {}
    for policy in ("full", "dots_saveable"):
        model = make_model(policy)
        write_back(model, {k: v.detach().to(torch.bfloat16)
                           for k, v in model.named_parameters()})
        log(f"  {what}, recompute {policy}, captured against eager:")
        _, step, losses, first_s, _ = _hold_captured_equals_eager(
            f"{what} recompute {policy}", model,
            lambda m: AdamW(TRAIN_LR, parameters=m.parameters(),
                            weight_decay=0.01),
            create_train_step, [(x, y)] * 3, TRAIN_LR)
        res[policy] = {"losses": [float(v) for v in losses],
                       "first_call_s": first_s,
                       "captures": step.compile_count}
        del model, step
    return res


def phase_train_recompute(seed):
    """GPT-2 small's widths with 2 layers, bf16, dropout 0.1, every layer
    recomputed: ``_hold_recompute_captured``."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    cfg = gpt2_small()
    cfg.num_layers, cfg.dropout, cfg.use_recompute = 2, 0.1, True
    batch, seq = 8, cfg.max_position_embeddings
    rng = np.random.RandomState(seed + 5)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq + 1)),
                          device="cuda")

    def gpt(policy):
        cfg.recompute_policy = policy
        return GPTForCausalLM(cfg, device="cuda",
                              generator=make_generator(seed, "cuda"))
    return _hold_recompute_captured("GPT-2, dropout 0.1, 2 layers", gpt,
                                    ids[:, :-1], ids[:, 1:])


def phase_train_full(seed, card, profile, out_dir):
    """bench.py's GPT-2 small training config on one batch: 3 captured
    steps equal to 3 eager ones from one snapshot, then 20 timed
    replays."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import (GPTForCausalLM, create_train_step,
                                         gpt2_small, write_back)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt2_small()
    cfg.dropout = 0.0
    batch, seq = 8, cfg.max_position_embeddings
    at_start = _cell_start()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=make_generator(seed, "cuda"))
    # bf16 parameters, fp32 moments (bench.py casts its params the same way)
    write_back(model, {k: v.detach().to(torch.bfloat16)
                       for k, v in model.named_parameters()})
    nparams = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq + 1)),
                          device="cuda")
    x, y = ids[:, :-1], ids[:, 1:]
    _, step, first, first_s, mem = _hold_captured_equals_eager(
        "train", model,
        lambda m: AdamW(TRAIN_LR, parameters=m.parameters(),
                        weight_decay=0.01),
        create_train_step, [(x, y)] * 3, TRAIN_LR)
    timed, ms_step, counts, reserved = _timed_replays(step, x, y, TRAIN_LR)
    losses = [float(v) for v in first + timed]
    peak = torch.cuda.max_memory_allocated()
    tokens_s = batch * seq / (ms_step / 1e3)
    h, L, inter, V = (cfg.hidden_size, cfg.num_layers,
                      cfg.intermediate_size, cfg.vocab_size)
    flops_per_tok = 6 * (L * (4 * h * h + 2 * h * inter) + V * h) \
        + 3 * L * seq * h                            # bench.py's count
    res = {"params": nparams, "batch": batch, "seq": seq,
           "losses": losses, "first_call_s": first_s,
           "ms_per_step": ms_step, "tokens_per_s": tokens_s,
           "mfu": tokens_s * flops_per_tok / BF16_FLOPS,
           "peak_mem_bytes": peak, "reserved_bytes": reserved,
           "mem_at_start_bytes": at_start, "memory_stages": mem,
           "captures": step.compile_count, "launches": counts,
           "card": card}
    log(f"  full: {nparams} params bf16, batch {batch} x {seq}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps "
        f"(3 against eager, {TRAIN_STEPS} timed)")
    log(f"  full: {ms_step:.2f} ms/step (replays), {tokens_s:.0f} tokens/s, "
        f"MFU {res['mfu']:.4f} (vs 989 TFLOP/s), peak memory "
        f"{peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB "
        f"reserved (graph pool included), first call (eager step + capture) "
        f"{first_s:.2f} s [{card}]")
    log(f"  full: launches {counts}")
    _hold_training(losses, counts, _expected_counts(L, TRAIN_STEPS, "wgmma"),
                   step)
    res["profiled"] = _hold_profiled("train", lambda: step(x, y, TRAIN_LR),
                                     _expected_counts(L, 1, "wgmma"))
    if profile:
        res["profile"] = phase_train_profile(step, x, y, out_dir)
    return res


def _hold_training(losses, counts, expect, step):
    """The checks of a captured train cell: finite losses that fall by at
    least 0.5 over the first ``TRAIN_STEPS`` steps from the
    initialisation, the exact launches of the timed replays, and one
    capture in all."""
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    fall = losses[0] - losses[TRAIN_STEPS - 1]
    if not fall >= 0.5:
        raise AssertionError(f"loss fell by {fall:.4f} < 0.5 over "
                             f"{TRAIN_STEPS} steps")
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    if step.compile_count != 1:
        raise AssertionError(f"{step.compile_count} captures, expected 1")


def phase_train_profile(step, x, y, out_dir, lr=TRAIN_LR,
                        name="train_profile.txt"):
    """One train step under torch.profiler (after one warm-up step):
    device time by kernel class and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        step(x, y, lr)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step(x, y, lr)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    totals, ranges = {}, {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if not dt:
            continue
        # a record_function range (the profiler's step, the optimizer's
        # Optimizer.step) is also drawn on the device timeline, spanning
        # the kernels launched inside it: adding it to the kernels would
        # count their time twice, so it is kept apart
        if (getattr(e, "is_user_annotation", False)
                or e.key.startswith("ProfilerStep")
                or e.key.startswith("Optimizer.")):
            ranges[e.key] = ranges.get(e.key, 0.0) + dt
        else:
            totals[e.key] = totals.get(e.key, 0.0) + dt
    busy = sum(totals.values())
    classes = {}
    for k, v in totals.items():
        c = _train_kernel_class(k)
        classes[c] = classes.get(c, 0.0) + v
    out = {"wall_us": wall_us, "busy_us": busy,
           "idle_share": 1.0 - busy / wall_us if wall_us else None,
           "classes_us": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
           "ranges_us": ranges,
           "top_kernels_us": sorted(totals.items(),
                                    key=lambda kv: -kv[1])[:15]}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(json.dumps(out, indent=1) + "\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40) + "\n")
    log(f"  profile: one step {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy / 1e3:.1f} ms (idle share {out['idle_share']:.3f}); "
        f"record_function ranges kept apart: "
        + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in ranges.items()))
    for c, v in out["classes_us"].items():
        log(f"    {v / 1e3:10.2f} ms  {c}")
    return out


def _bert_batch(vocab: int, lens, seq: int, rng, device):
    """One pretraining batch: ``lens`` valid tokens per row (random ids
    in [1, V), pad id 0), token type 1 after a split at 1/4-3/4 of the
    valid length, 15 % of valid positions masked to [MASK] and labelled
    with their original ids (-100 elsewhere), NSP labels 0/1. Returns
    (ids, labels, token types, 0/1 mask, NSP labels) on ``device``."""
    b = len(lens)
    lens = np.asarray(lens)
    pos = np.arange(seq)[None, :]
    valid = pos < lens[:, None]
    ids = np.where(valid, rng.randint(1, vocab, (b, seq)), 0)
    split = (lens * rng.uniform(0.25, 0.75, b)).astype(np.int64)
    tt = (valid & (pos >= split[:, None])).astype(np.int64)
    masked = valid & (rng.rand(b, seq) < 0.15)
    labels = np.where(masked, ids, -100)
    ids = np.where(masked, BERT_MASK_ID, ids)
    nsp = rng.randint(0, 2, b)
    return tuple(torch.as_tensor(a, device=device) for a in (
        ids.astype(np.int64), labels.astype(np.int64), tt,
        valid.astype(np.float32), nsp.astype(np.int64)))


def _bert_loss_fn(tt, mask, nsp):
    """``loss_fn`` of create_train_step: MLM + NSP, closing over the
    token types, the padding mask and the NSP labels."""
    def loss_fn(model, ids, labels):
        return model.loss(ids, labels, nsp, tt, mask)
    return loss_fn


class _DbiasSpy:
    """Counts, while active, the dq launches asked for dbias and the
    broadcast dbias sums: a train step whose bias needs no gradient must
    make none."""

    def __init__(self, fa):
        self.fa, self.dq_dbias, self.broadcast = fa, 0, 0

    def __enter__(self):
        fa = self.fa
        self._saved = fa._dq_launch, fa.flash_dbias_broadcast
        dq_launch, bcast = self._saved

        def dq_spy(*a, **kw):
            self.dq_dbias += bool(a[12] if len(a) > 12
                                  else kw.get("dbias", False))
            return dq_launch(*a, **kw)

        def bcast_spy(*a, **kw):
            self.broadcast += 1
            return bcast(*a, **kw)
        fa._dq_launch, fa.flash_dbias_broadcast = dq_spy, bcast_spy
        return self

    def __exit__(self, *exc):
        self.fa._dq_launch, self.fa.flash_dbias_broadcast = self._saved
        return False


def phase_bert_oracle(seed):
    """One pretraining step of BERT-large's widths (2 layers, fp32,
    dropout 0, batch 2 x 512 with valid lengths 300 and 512) on the card
    through the kernels (the FMA flash kernels with the mask's bias) and
    on the CPU through the plain versions, from the same weights and
    batch."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import (BertForPretraining, bert_large,
                                         create_train_step)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_large()
    cfg.num_layers, cfg.dropout = 2, 0.0
    cpu = BertForPretraining(cfg, device="cpu",
                             generator=make_generator(seed, "cpu"))
    gpu = BertForPretraining(cfg, device="cuda",
                             generator=make_generator(seed, "cuda"))
    gpu.load_state_dict(cpu.state_dict())
    batch = _bert_batch(cfg.vocab_size, (300, 512),
                        cfg.max_position_embeddings,
                        np.random.RandomState(seed), "cpu")
    losses, counts = {}, None
    for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
        ids, labels, tt, mask, nsp = (t.to(dev) for t in batch)
        step = create_train_step(
            m, AdamW(BERT_LR, parameters=m.parameters(), weight_decay=0.01),
            _bert_loss_fn(tt, mask, nsp))
        _reset_counts()
        t0 = time.perf_counter()
        losses[dev] = float(step(ids, labels, BERT_LR))
        if dev == "cuda":
            counts = _counts()
        else:
            log(f"  oracle: loss card {losses['cuda']:.6f}, CPU plain "
                f"{losses['cpu']:.6f} ({time.perf_counter() - t0:.1f} s "
                f"on the CPU); launches {counts}")
    expect = _expected_counts(cfg.num_layers, 1, "fma",
                              norms=2 * cfg.num_layers + 2, ces=2, bias=True)
    if counts != expect:
        raise AssertionError(f"oracle launches {counts}, expected {expect}")
    if not abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"]):
        raise AssertionError("oracle loss differs beyond rtol 1e-4")
    worst, vanishing = _hold_oracle_grads(cpu, gpu)
    return {"loss_card": losses["cuda"], "loss_cpu": losses["cpu"],
            "worst_grad_rel": worst, "k_proj_bias_grad_rel": vanishing,
            "launches": counts}


def phase_bert_full(seed, card, profile, out_dir):
    """BERT-large pretraining (MLM + NSP) at full width and depth on one
    batch of 16 x 512: 3 captured steps equal to 3 eager ones from one
    snapshot (dropout 0.1 drawn from the model's generator, registered
    with the graph), then 20 timed replays."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import (BertForPretraining, bert_large,
                                         create_train_step, write_back)
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_large()                               # dropout 0.1
    batch, seq = 16, cfg.max_position_embeddings
    at_start = _cell_start()
    model = BertForPretraining(cfg, device="cuda",
                               generator=make_generator(seed, "cuda"))
    # bf16 parameters, fp32 moments, as the GPT-2 train cell
    write_back(model, {k: v.detach().to(torch.bfloat16)
                       for k, v in model.named_parameters()})
    nparams = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, seq + 1, batch)
    ids, labels, tt, mask, nsp = _bert_batch(cfg.vocab_size, lens, seq, rng,
                                             "cuda")
    loss_fn = _bert_loss_fn(tt, mask, nsp)
    with _DbiasSpy(fa) as spy:
        _, step, first, first_s, mem = _hold_captured_equals_eager(
            "bert", model,
            lambda m: AdamW(BERT_LR, parameters=m.parameters(),
                            weight_decay=0.01),
            lambda m, o: create_train_step(m, o, loss_fn),
            [(ids, labels)] * 3, BERT_LR, loss_fn)
        timed, ms_step, counts, reserved = _timed_replays(
            step, ids, labels, BERT_LR)
    losses = [float(v) for v in first + timed]
    peak = torch.cuda.max_memory_allocated()
    tokens_s = batch * seq / (ms_step / 1e3)
    h, L, inter, V = (cfg.hidden_size, cfg.num_layers,
                      cfg.intermediate_size, cfg.vocab_size)
    # per token: the encoder's, the MLM transform's and the tied decoder's
    # matmuls (the pooler and NSP head act on one token a row: left out),
    # and attention that is not causal: QK^T and PV, forward and backward
    flops_per_tok = 6 * (L * (4 * h * h + 2 * h * inter) + h * h + V * h) \
        + 12 * L * seq * h
    res = {"params": nparams, "batch": batch, "seq": seq,
           "valid_lengths": [int(n) for n in lens],
           "valid_share": float(lens.sum()) / (batch * seq),
           "losses": losses, "first_call_s": first_s,
           "ms_per_step": ms_step, "tokens_per_s": tokens_s,
           "valid_tokens_per_s": tokens_s * float(lens.sum()) / (batch * seq),
           "mfu": tokens_s * flops_per_tok / BF16_FLOPS,
           "flops_per_token": flops_per_tok,
           "peak_mem_bytes": peak, "reserved_bytes": reserved,
           "mem_at_start_bytes": at_start, "memory_stages": mem,
           "captures": step.compile_count, "launches": counts,
           "dbias_requests": {"dq": spy.dq_dbias, "broadcast": spy.broadcast},
           "card": card}
    log(f"  full: {nparams} params bf16, batch {batch} x {seq} (valid "
        f"share {res['valid_share']:.3f}), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} steps (3 against eager, "
        f"{TRAIN_STEPS} timed)")
    log(f"  full: {ms_step:.2f} ms/step (replays), {tokens_s:.0f} tokens/s "
        f"({res['valid_tokens_per_s']:.0f} valid), MFU {res['mfu']:.4f} "
        f"(vs 989 TFLOP/s), peak memory {peak / 2**30:.2f} GiB allocated, "
        f"{reserved / 2**30:.2f} GiB reserved (graph pool included), first "
        f"call (eager step + capture) {first_s:.2f} s [{card}]")
    log(f"  full: launches {counts}; dbias requested {res['dbias_requests']}")
    _hold_training(losses, counts, _expected_counts(
        L, TRAIN_STEPS, "wgmma", norms=2 * L + 2, ces=2, bias=True), step)
    if spy.dq_dbias or spy.broadcast:
        raise AssertionError(f"dbias computed for the mask: "
                             f"{res['dbias_requests']}")
    res["profiled"] = _hold_profiled(
        "bert", lambda: step(ids, labels, BERT_LR),
        _expected_counts(L, 1, "wgmma", norms=2 * L + 2, ces=2, bias=True))
    if profile:
        res["profile"] = phase_train_profile(
            step, ids, labels, out_dir, BERT_LR, "bert_train_profile.txt")
    return res


def _llama_cfg(**kw):
    """bench_configs.py's single-chip Llama train config (the reference's
    0.7B cell: hidden 2048, 16 heads so D = 128, 16 KV heads,
    intermediate 5504, vocab 32000, 12 layers, 2048 positions, dropout 0,
    the blockwise LM-head CE), with ``kw`` changed."""
    from paddle_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig(vocab_size=32000, hidden_size=2048,
                      intermediate_size=5504, num_layers=12, num_heads=16,
                      num_kv_heads=16, max_position_embeddings=2048,
                      dropout=0.0, lm_ce="blockwise")
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _mfu_llama_flops(cfg, seq: int) -> float:
    """bench_configs.py ``_mfu_llama``'s FLOPs per token: 6 x the matmul
    parameters (attention with GQA's K/V share, the MLP, the LM head) +
    3 L S H for causal attention."""
    h, L, inter, V = (cfg.hidden_size, cfg.num_layers,
                      cfg.intermediate_size, cfg.vocab_size)
    kv = cfg.num_kv_heads / cfg.num_heads
    return 6 * (L * ((2 + 2 * kv) * h * h + 3 * h * inter) + V * h) \
        + 3 * L * seq * h


def check_fused_adamw_on_card(seed):
    """Two AdamW steps with ``use_fused_optimizer`` on (torch._foreach_*)
    and two with it off (the per-parameter loop), from the same
    parameters and gradients on the card: bf16 and fp32 parameters, bf16
    and fp32 moments, decay on and off; every parameter and moment must
    come out the same bit for bit. Returns the count of tensors
    compared."""
    from paddle_tpu_torch import get_flags, set_flags
    from paddle_tpu_torch.optimizer import AdamW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(2048, 5504), (5504, 2048), (2048,), (32000, 2048), (7, 3)]
    compared = 0
    prev = get_flags("use_fused_optimizer")
    try:
        for pdtype in (torch.bfloat16, torch.float32):
            for mdtype in (torch.bfloat16, None):
                data = [torch.randn(s, device="cuda", generator=gen)
                        .to(pdtype) for s in shapes]
                grads = [[torch.randn(s, device="cuda", generator=gen)
                          .to(pdtype) for s in shapes] for _ in range(2)]
                out = []
                for fused in (True, False):
                    set_flags({"use_fused_optimizer": fused})
                    ps = [torch.nn.Parameter(d.clone()) for d in data]
                    opt = AdamW(TRAIN_LR, parameters=ps, weight_decay=0.01,
                                moment_dtype=mdtype)
                    mask = {id(p): i % 2 == 0 for i, p in enumerate(ps)}
                    for gs in grads:
                        for p, g in zip(ps, gs):
                            p.grad = g.clone()
                        opt.step(lr=TRAIN_LR, wd_mask=mask)
                    out.append([t for p in ps for t in (
                        p.detach(), opt.state[p]["moment1"],
                        opt.state[p]["moment2"])])
                torch.cuda.synchronize()
                for a, b in zip(*out):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"fused AdamW ({pdtype}, moments {mdtype}) "
                            f"differs from the loop at "
                            f"{int((a != b).sum())} of {a.numel()}")
                    compared += 1
    finally:
        set_flags(prev)
    log(f"  fused AdamW step: {compared} parameters and moments equal the "
        f"per-parameter loop's bit for bit after two steps (bf16/fp32 "
        f"parameters, bf16/fp32 moments, decay on and off)")
    return compared


def _grads_run(model, x, y):
    """Loss and every gradient of one train-mode loss + backward."""
    model.zero_grad(set_to_none=True)
    model.train()
    loss = model.loss(x, y)
    loss.backward()
    return loss.detach().clone(), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()}


def _hold_recompute(gpu, x, y, layers):
    """The oracle's step on the card again (loss and gradients, no
    optimizer step), twice without recompute, then with
    ``use_recompute`` under each of "full" and "dots_saveable": loss and
    gradients must equal the run without recompute bit for bit, except
    where the two runs without it already differ (named, and held to
    that difference); each run with recompute must replay every layer's
    flash forward and RMSNorms (2L flash forwards, 4L + 1 RMSNorms)."""
    base = _grads_run(gpu, x, y)
    again = _grads_run(gpu, x, y)
    noisy = {}
    if not torch.equal(base[0], again[0]):
        noisy["loss"] = float((base[0] - again[0]).abs())
    for n in base[1]:
        if not torch.equal(base[1][n], again[1][n]):
            noisy[n] = float((base[1][n] - again[1][n]).abs().max())
    log(f"  recompute: the step run twice without recompute differs in "
        f"{noisy or 'nothing'}")
    res = {"run_to_run": noisy}
    for policy in ("full", "dots_saveable"):
        gpu.cfg.use_recompute, gpu.cfg.recompute_policy = True, policy
        try:
            _reset_counts()
            got = _grads_run(gpu, x, y)
            counts = _counts()
        finally:
            gpu.cfg.use_recompute = False
        expect = _expected_counts(layers, 1, "fma", norms=4 * layers + 1,
                                  ces=0, norm="rms_norm", fwds=2 * layers)
        if counts != expect:
            raise AssertionError(f"recompute {policy}: launches {counts}, "
                                 f"expected {expect}")
        diffs = {}
        for n, ref, g in [("loss", base[0], got[0])] + [
                (n, base[1][n], got[1][n]) for n in base[1]]:
            d = float((g - ref).abs().max())
            if n in noisy:
                if not d <= noisy[n]:
                    raise AssertionError(f"recompute {policy}: {n} differs "
                                         f"by {d:.3e}, beyond the "
                                         f"run-to-run {noisy[n]:.3e}")
                diffs[n] = d
            elif not torch.equal(g, ref):
                raise AssertionError(f"recompute {policy}: {n} differs at "
                                     f"{int((g != ref).sum())} entries "
                                     f"(max {d:.3e})")
        log(f"  recompute {policy}: loss and {len(base[1])} gradients equal "
            f"the run without recompute bit for bit"
            + (f" (run-to-run tensors within their spread: {diffs})"
               if diffs else "")
            + f"; {counts['flash_fwd']} flash forwards, "
            f"{counts['rms_norm']} RMSNorms")
        res[policy] = {"launches": counts, "within_spread": diffs}
    return res


def phase_llama_oracle(seed):
    """One train step of the Llama cell's widths with 2 layers, fp32,
    batch 1 x 1024, on the card (FMA flash kernels at D = 128, RMSNorm
    kernel) and on the CPU (plain versions) from the same weights; then
    the recompute check on the card."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import LlamaForCausalLM, create_train_step
    from paddle_tpu_torch.optimizer import AdamW
    cfg = _llama_cfg(num_layers=2)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=make_generator(seed, "cpu"))
    gpu = LlamaForCausalLM(cfg, device="cuda",
                           generator=make_generator(seed, "cuda"))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (1, 1025))
    x, y = ids[:, :-1], ids[:, 1:]
    steps = {m: create_train_step(m, AdamW(TRAIN_LR,
                                           parameters=m.parameters(),
                                           weight_decay=0.01))
             for m in (cpu, gpu)}
    _reset_counts()
    loss_gpu = float(steps[gpu](x, y, TRAIN_LR))
    counts = _counts()
    t0 = time.perf_counter()
    loss_cpu = float(steps[cpu](x, y, TRAIN_LR))
    log(f"  oracle: loss card {loss_gpu:.6f}, CPU plain {loss_cpu:.6f} "
        f"({time.perf_counter() - t0:.1f} s on the CPU); launches {counts}")
    expect = _expected_counts(cfg.num_layers, 1, "fma", ces=0,
                              norm="rms_norm")
    if counts != expect:
        raise AssertionError(f"oracle launches {counts}, expected {expect}")
    if not abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError("oracle loss differs beyond rtol 1e-4")
    worst, _ = _hold_oracle_grads(cpu, gpu)
    del cpu, steps
    xg, yg = (torch.as_tensor(a, device="cuda") for a in (x, y))
    rec = _hold_recompute(gpu, xg, yg, cfg.num_layers)
    del gpu

    def llama(policy):
        return LlamaForCausalLM(
            _llama_cfg(num_layers=2, use_recompute=True,
                       recompute_policy=policy),
            device="cuda", generator=make_generator(seed, "cuda"))
    rec["captured"] = _hold_recompute_captured("Llama, 2 layers", llama,
                                               xg, yg)
    return {"loss_card": loss_gpu, "loss_cpu": loss_cpu,
            "worst_grad_rel": worst, "launches": counts, "recompute": rec}


def phase_llama_full(seed, card, profile, out_dir):
    """The 0.7B Llama train cell: bench_configs.py's single-chip config
    at batch 8 x 2048, bf16 parameters and AdamW moments, on one batch:
    3 captured steps equal to 3 eager ones from one snapshot, then 20
    timed replays."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import (LlamaForCausalLM, create_train_step,
                                         write_back)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = _llama_cfg()
    batch, seq = 8, cfg.max_position_embeddings
    at_start = _cell_start()
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=make_generator(seed, "cuda"))
    write_back(model, {k: v.detach().to(torch.bfloat16)
                       for k, v in model.named_parameters()})
    nparams = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq + 1)),
                          device="cuda")
    x, y = ids[:, :-1], ids[:, 1:]
    # the reference's second candidate (bench_configs.py): batch 8 with
    # bf16 moment storage; weight decay off the norms (trainer._wd_mask)
    opt, step, first, first_s, mem = _hold_captured_equals_eager(
        "llama", model,
        lambda m: AdamW(TRAIN_LR, parameters=m.parameters(),
                        weight_decay=0.01, moment_dtype=torch.bfloat16),
        create_train_step, [(x, y)] * 3, TRAIN_LR)
    timed, ms_step, counts, reserved = _timed_replays(step, x, y, TRAIN_LR)
    losses = [float(v) for v in first + timed]
    peak = torch.cuda.max_memory_allocated()
    tokens_s = batch * seq / (ms_step / 1e3)
    flops_per_tok = _mfu_llama_flops(cfg, seq)
    res = {"params": nparams, "batch": batch, "seq": seq,
           "losses": losses, "first_call_s": first_s,
           "ms_per_step": ms_step,
           "tokens_per_s": tokens_s, "flops_per_token": flops_per_tok,
           "mfu": tokens_s * flops_per_tok / BF16_FLOPS,
           "moment_dtype": str(opt.state[model.lm_head.weight]["moment1"]
                               .dtype)[6:],
           "peak_mem_bytes": peak, "reserved_bytes": reserved,
           "mem_at_start_bytes": at_start, "memory_stages": mem,
           "captures": step.compile_count, "launches": counts, "card": card}
    log(f"  full: {nparams} params bf16, moments {res['moment_dtype']}, "
        f"batch {batch} x {seq}, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"over {len(losses)} steps (3 against eager, {TRAIN_STEPS} timed)")
    log(f"  full: {ms_step:.2f} ms/step (replays), {tokens_s:.0f} tokens/s, "
        f"MFU {res['mfu']:.4f} ({flops_per_tok / 1e9:.3f} GFLOP per token "
        f"vs 989 TFLOP/s), peak memory {peak / 2**30:.2f} GiB allocated, "
        f"{reserved / 2**30:.2f} GiB reserved (graph pool included), first "
        f"call (eager step + capture) {first_s:.2f} s [{card}]")
    log(f"  full: launches {counts}")
    _hold_training(losses, counts, _expected_counts(
        cfg.num_layers, TRAIN_STEPS, "wgmma", ces=0, norm="rms_norm"), step)
    res["profiled"] = _hold_profiled(
        "llama", lambda: step(x, y, TRAIN_LR),
        _expected_counts(cfg.num_layers, 1, "wgmma", ces=0, norm="rms_norm"))
    if profile:
        res["profile"] = phase_train_profile(step, x, y, out_dir,
                                             name="llama_train_profile.txt")
    return res


TRAINLOOP_EAGER_CELL = "gpt2s-bf16-O2-eager-b8"
TRAINLOOP_RUN_CELL = "gpt2s-bf16-run-steps-k4-m2"
TRAINLOOP_K, TRAINLOOP_M = 4, 2


def _warmup_cosine():
    """The loop's schedule: 2 warmup steps from 0 to 3e-4, then a cosine
    over 20 epochs (started at its epoch 1, as the reference's
    ``LinearWarmup`` steps it)."""
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    return LinearWarmup(CosineAnnealingDecay(TRAIN_LR, T_max=20),
                        warmup_steps=2, start_lr=0.0, end_lr=TRAIN_LR)


def _schedule_values(n: int) -> list:
    sched, out = _warmup_cosine(), []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


def _decays(name: str) -> bool:
    """AdamW's ``apply_decay_param_fun``: no decay on biases and norms
    (the trainer's ``_wd_mask``)."""
    return "bias" not in name and "norm" not in name.lower() \
        and "ln_" not in name


def _global_norm(pairs) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in pairs if g is not None))


class _ClipSpy:
    """Wraps an optimizer's ``grad_clip``: keeps the global norm of the
    gradients before and after clipping, on the device, for each step."""

    def __init__(self, clip):
        self.clip, self.before, self.after = clip, [], []

    def __call__(self, pairs):
        out = self.clip(pairs)
        self.before.append(_global_norm(pairs))
        self.after.append(_global_norm(out))
        return out


def _gpt2_twins(seed, n, layers=None, device="cuda", bf16=False):
    """``n`` GPT-2 small models (``layers`` deep) with the same weights,
    dropout 0; fp32, or bf16 parameters."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt2_small,
                                         write_back)
    cfg = gpt2_small()
    cfg.dropout = 0.0
    if layers is not None:
        cfg.num_layers = layers
    models = [GPTForCausalLM(cfg, device=device,
                             generator=make_generator(seed, device))
              for _ in range(n)]
    for m in models:
        if bf16:
            write_back(m, {k: v.detach().to(torch.bfloat16)
                           for k, v in m.named_parameters()})
    return cfg, models


def _eager_optimizer(model, clip_norm):
    """The Paddle user's optimizer: AdamW under the warmup-cosine
    schedule, weight decay 0.01 off biases and norms (by name), global-
    norm clipping at ``clip_norm`` (watched by a ``_ClipSpy``). Returns
    (schedule, spy, optimizer)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    sched = _warmup_cosine()
    spy = _ClipSpy(ClipGradByGlobalNorm(clip_norm))
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=0.01, apply_decay_param_fun=_decays,
                grad_clip=spy)
    return sched, spy, opt


def _hold_loop_changes(runs) -> dict:
    """The oracle's three AdamW steps held entry by entry. Every
    gradient of every step within 1e-3 of its max-abs on the CPU (the key
    projections' biases, zero in exact arithmetic, within 1e-6 of the
    model's largest gradient on both sides). Every parameter's change
    over the three steps within 1e-3 of that change's largest magnitude,
    apart from the entries whose gradient the arithmetic does not fix:
    Adam divides each entry's moment by the root of its second moment
    plus eps (1e-8), so a relative change f of an entry's gradients moves
    its update by up to f x lr, and an entry whose gradient is rounding
    noise (~1e-9 beside a largest of ~1e-2 on the card) takes an update
    of up to the learning rate in a direction the noise picks. So the
    entries where at some step the two sides' gradients differ by more
    than the bound itself, 1e-3 x (|gradient| + eps), are held by their
    gradients (above) and counted (0.18 % of the entries on an H100;
    the worst of the others then used 0.63 of the bound)."""
    card, cpu = runs["card"], runs["cpu"]
    top = max(float(g.abs().max()) for step in cpu["grads"]
              for g in step.values())
    worst_grad = worst = vanishing = 0.0
    noisy = total = 0
    for n, d_ref in cpu["delta"].items():
        pairs = [(a[n], b[n]) for a, b in zip(card["grads"], cpu["grads"])]
        if n.endswith("self_attn.k_proj.bias"):
            mag = max(float(t.abs().max()) for pr in pairs for t in pr) / top
            vanishing = max(vanishing, mag)
            if not mag <= 1e-6:
                raise AssertionError(f"oracle grad {n}: {mag:.3e} of the "
                                     f"largest gradient, expected ~0")
            continue
        loose = torch.zeros(d_ref.shape, dtype=torch.bool)
        for g, g_ref in pairs:
            rel = float((g - g_ref).abs().max()) / max(
                float(g_ref.abs().max()), 1e-30)
            worst_grad = max(worst_grad, rel)
            if not rel <= 1e-3:
                raise AssertionError(f"oracle grad {n}: max diff {rel:.3e} "
                                     f"of its max-abs > 1e-3")
            loose |= (g - g_ref).abs() > 1e-3 * (g_ref.abs() + 1e-8)
        noisy += int(loose.sum())
        total += loose.numel()
        d = card["delta"][n]
        diff = torch.where(loose, torch.zeros_like(d), (d - d_ref).abs())
        rel = float(diff.max()) / max(float(d_ref.abs().max()), 1e-30)
        worst = max(worst, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"oracle change of {n}: max diff {rel:.3e} "
                                 f"of its max-abs > 1e-3")
    log(f"  oracle: every gradient of the 3 steps agrees, worst "
        f"{worst_grad:.3e} of its max-abs; every parameter's change agrees, "
        f"worst {worst:.3e} of its max-abs (bound 1e-3), apart from "
        f"{noisy} of {total} entries whose gradients are rounding noise "
        f"(held by those); k_proj biases' gradients zero up to "
        f"{vanishing:.2e} of the largest")
    return {"worst_grad_rel": worst_grad, "worst_change_rel": worst,
            "noise_gradient_entries": noisy, "entries": total,
            "k_proj_bias_grad_rel": vanishing}


def phase_trainloop_oracle(seed, device="cuda"):
    """Three eager steps of the Paddle loop (AdamW, warmup-cosine,
    global-norm clipping that engages) with GPT-2 small's widths at 2
    layers, fp32, batch 1 x 1024, on the card (FMA flash kernels) and on
    the CPU (plain versions) from the same weights; then SGD through
    ``create_multistep_train_step(steps=1, accumulate=2)`` on 2 x
    (1 x 512) microbatches against the concatenated [2, 512] batch on
    the card, 3 steps each."""
    from paddle_tpu_torch.models import create_multistep_train_step
    from paddle_tpu_torch.optimizer import SGD
    cfg, (cpu,) = _gpt2_twins(seed, 1, layers=2, device="cpu")
    _, (gpu,) = _gpt2_twins(seed, 1, layers=2, device=device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (1, cfg.max_position_embeddings + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    # the clip is set at half the first step's global norm: it engages
    t0 = time.perf_counter()
    cpu.loss(torch.as_tensor(x), torch.as_tensor(y)).backward()
    norm0 = float(_global_norm((None, p.grad) for p in cpu.parameters()))
    cpu.zero_grad(set_to_none=True)
    clip_norm = 0.5 * norm0
    runs = {}
    # the counted run: the card's eager steps and SGD runs below (the
    # CPU's steps between them launch nothing)
    _reset_counts()
    for side, m in (("card", gpu), ("cpu", cpu)):
        dev = next(m.parameters()).device
        xs, ys = (torch.as_tensor(a, device=dev) for a in (x, y))
        before = {n: p.detach().clone() for n, p in m.named_parameters()}
        sched, spy, opt = _eager_optimizer(m, clip_norm)
        losses, grads = [], []
        for _ in range(3):
            loss = m.loss(xs, ys)
            loss.backward()
            grads.append({n: p.grad.detach().cpu().clone()
                          for n, p in m.named_parameters()})
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss.detach()))
        runs[side] = {"losses": losses, "grads": grads,
                      "norms": [float(v) for v in spy.before],
                      "delta": {n: (p.detach() - before[n]).cpu()
                                for n, p in m.named_parameters()}}
    log(f"  oracle: 3 eager steps, card {runs['card']['losses']}, CPU "
        f"{runs['cpu']['losses']} ({time.perf_counter() - t0:.1f} s); "
        f"global norm before clipping {runs['card']['norms']} (clip at "
        f"{clip_norm:.4f})")
    for a, b in zip(runs["card"]["losses"], runs["cpu"]["losses"]):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"oracle loss {a} vs CPU {b}: beyond "
                                 f"rtol 1e-4")
    if not runs["card"]["norms"][0] > clip_norm:
        raise AssertionError("the clip did not engage at the first step")
    held = _hold_loop_changes(runs)
    # SGD: accumulate=2 on two microbatches against the concatenated batch    # SGD: accumulate=2 on two microbatches against the concatenated batch
    ids2 = rng.randint(0, cfg.vocab_size, (2, 513))
    cx, cy = ids2[None, :, :-1], ids2[None, :, 1:]           # [1, 2, 512]
    mx, my = cx.reshape(1, 2, 1, 512), cy.reshape(1, 2, 1, 512)
    _, (cat, acc) = _gpt2_twins(seed, 2, layers=2, device=device)
    sgd = {}
    for name, m, xs, ys, accumulate in (("concat", cat, cx, cy, 1),
                                        ("accumulate", acc, mx, my, 2)):
        step = create_multistep_train_step(
            m, SGD(0.05, parameters=m.parameters()), steps=1,
            accumulate=accumulate)
        sgd[name] = torch.cat([step(xs, ys, 5e-3) for _ in range(3)])
    counts = _counts()                               # counted run ends
    expect = _expected_counts(cfg.num_layers, 3 + 3 + 2 * 3, "fma")
    if counts != expect:
        raise AssertionError(f"oracle launches {counts}, expected {expect}")
    la, lc = sgd["accumulate"].cpu().numpy(), sgd["concat"].cpu().numpy()
    np.testing.assert_allclose(la, lc, rtol=1e-5, atol=1e-6)
    for (n, p), q in zip(cat.named_parameters(), acc.parameters()):
        np.testing.assert_allclose(q.detach().cpu().numpy(),
                                   p.detach().cpu().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    log(f"  oracle: SGD accumulate=2 losses {la.tolist()} vs the "
        f"concatenated batch {lc.tolist()}; every parameter within rtol "
        f"1e-4 / atol 1e-5")
    return {"losses_card": runs["card"]["losses"],
            "losses_cpu": runs["cpu"]["losses"],
            "global_norms_card": runs["card"]["norms"],
            "clip_norm": clip_norm, **held,
            "sgd_accumulate_losses": la.tolist(),
            "sgd_concat_losses": lc.tolist(), "launches": counts}


def phase_trainloop_eager(seed, card, device="cuda", profile=False,
                          out_dir=None):
    """The eager Paddle loop at full width: GPT-2 small in fp32, then
    ``amp.decorate(..., level="O2", dtype="bfloat16")`` (bf16 parameters,
    fp32 master weights), the warmup-cosine AdamW with
    ``ClipGradByGlobalNorm(1.0)``, 20 steps on one batch of 8 x 1024."""
    from paddle_tpu_torch import amp
    cfg, (model,) = _gpt2_twins(seed, 1, device=device)
    batch, seq = 8, cfg.max_position_embeddings
    sched, spy, opt = _eager_optimizer(model, 1.0)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    if not (opt._multi_precision and all(
            p.dtype == torch.bfloat16 for p in model.parameters())):
        raise AssertionError("amp.decorate: parameters not bf16 or master "
                             "weights off")
    rng = np.random.RandomState(seed + 1)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq + 1)),
                          device=device)
    x, y = ids[:, :-1], ids[:, 1:]
    expected_lrs = _schedule_values(TRAIN_STEPS)
    at_start = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated()     # model and optimizer
    _reset_counts()                                  # counted run starts
    losses, lrs = [], []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss = model.loss(x, y)
        loss.backward()
        lrs.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss.detach())
        if i == 0:
            _sync(device)
            t1 = time.perf_counter()
    _sync(device)
    t2 = time.perf_counter()
    counts = _counts()                               # counted run ends
    losses = [float(v) for v in losses]
    before = [float(v) for v in spy.before]
    after = [float(v) for v in spy.after]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    ms_step = (t2 - t1) / (TRAIN_STEPS - 1) * 1e3
    tokens_s = batch * seq / (ms_step / 1e3)
    log(f"  eager O2: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{TRAIN_STEPS} steps; lr {['%.3e' % v for v in lrs]}")
    log(f"  eager O2: global norm before clipping "
        f"{['%.4f' % v for v in before]}; after, at most {max(after):.6f}")
    log(f"  eager O2: {ms_step:.2f} ms/step, {tokens_s:.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB ({at_start / 2**30:.3f} allocated "
        f"before the first step), first step {t1 - t0:.2f} s [{card}]")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[0] - losses[-1] >= 0.5:
        raise AssertionError(f"loss fell by {losses[0] - losses[-1]:.4f} "
                             f"< 0.5 over {TRAIN_STEPS} steps")
    if lrs != expected_lrs:
        raise AssertionError(f"lr used {lrs}, the schedule gives "
                             f"{expected_lrs}")
    if not max(after) <= 1.0 * (1 + 1e-2):
        raise AssertionError(f"global norm after clipping {max(after)} > "
                             f"1.0 (1 + 1e-2)")
    unequal = [n for n, p in model.named_parameters()
               if not torch.equal(p, opt._master_weights[p].to(p.dtype))]
    if unequal:
        raise AssertionError(f"bf16 parameters differ from their rounded "
                             f"fp32 masters: {unequal[:5]}")
    expect = _expected_counts(cfg.num_layers, TRAIN_STEPS, "wgmma")
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    log(f"  eager O2: every bf16 parameter equals its fp32 master rounded, "
        f"bit for bit; launches per step as the train cell's")
    res = {"batch": batch, "seq": seq, "losses": losses, "lrs": lrs,
           "global_norm_before_clip": before,
           "global_norm_after_clip": after, "ms_per_step": ms_step,
           "tokens_per_s": tokens_s, "first_step_s": t1 - t0,
           "peak_mem_bytes": peak, "mem_at_start_bytes": at_start,
           "launches": counts, "card": card}
    if profile:
        def o2_step(x, y, lr):
            loss = model.loss(x, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
        res["profile"] = phase_train_profile(o2_step, x, y, out_dir, None,
                                             "o2_eager_profile.txt")
    return res


def phase_trainloop_clip_bf16(seed, card, device="cuda"):
    """The global-norm clip engaged on bf16 gradients: a 2-layer GPT-2
    small after ``amp.decorate(level="O2")``, 3 eager steps of the
    warmup-cosine AdamW with ``ClipGradByGlobalNorm`` at half the first
    step's global norm. Every step's norm after clipping must be within
    1 % of the clip norm (the bf16 gradients scaled, not dropped), every
    bf16 parameter its fp32 master rounded, bit for bit, and every step
    launch the train cell's kernels for two layers."""
    from paddle_tpu_torch import amp
    cfg, (model,) = _gpt2_twins(seed, 1, layers=2, device=device)
    batch, seq, steps = 2, cfg.max_position_embeddings, 3
    rng = np.random.RandomState(seed + 2)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq + 1)),
                          device=device)
    x, y = ids[:, :-1], ids[:, 1:]
    sched, spy, opt = _eager_optimizer(model, 1.0)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    # the first step's global norm, on the same parameters and batch
    model.loss(x, y).backward()
    first = float(_global_norm(
        [(p, p.grad) for p in model.parameters()]))
    opt.clear_grad()
    clip_norm = first / 2
    spy.clip.clip_norm = clip_norm
    _reset_counts()                                  # counted run starts
    for _ in range(steps):
        loss = model.loss(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
    _sync(device)
    counts = _counts()                               # counted run ends
    before = [float(v) for v in spy.before]
    after = [float(v) for v in spy.after]
    log(f"  clip on bf16 gradients: clip_norm {clip_norm:.6f} (half of "
        f"{first:.6f}); global norm before {['%.6f' % v for v in before]},"
        f" after {['%.6f' % v for v in after]} [{card}]")
    if not (before[0] > clip_norm and all(
            abs(a - clip_norm) <= 1e-2 * clip_norm
            for a, b_ in zip(after, before) if b_ > clip_norm)):
        raise AssertionError(f"clip at {clip_norm}: norms before {before}, "
                             f"after {after}")
    unequal = [n for n, p in model.named_parameters()
               if not torch.equal(p, opt._master_weights[p].to(p.dtype))]
    if unequal:
        raise AssertionError(f"bf16 parameters differ from their rounded "
                             f"fp32 masters: {unequal[:5]}")
    expect = _expected_counts(cfg.num_layers, steps, "wgmma")
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    log(f"  clip on bf16 gradients: engaged at every step, within 1 % of "
        f"the clip norm; bf16 parameters their rounded masters")
    return {"clip_norm": clip_norm, "global_norm_before_clip": before,
            "global_norm_after_clip": after, "launches": counts}


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _loop_batches(rng, vocab, seq, steps, micro):
    """``steps`` host batches of ``[M, micro, seq]`` ids and labels: the
    same 8 sequences in a new order each step (so the loss can fall)."""
    pool = rng.randint(0, vocab, (TRAINLOOP_M * micro, seq + 1))
    out = []
    for _ in range(steps):
        ids = pool[rng.permutation(len(pool))].reshape(
            TRAINLOOP_M, micro, seq + 1)
        out.append((ids[..., :-1].copy(), ids[..., 1:].copy()))
    return out


def phase_trainloop_run_steps(seed, card, device="cuda", profile=False,
                              out_dir=None):
    """``create_multistep_train_step`` and ``run_steps`` at full width,
    bf16 parameters, AdamW(3e-4, weight decay 0.01 off biases and
    norms): (1) ``steps=4`` against 4 ``create_train_step`` calls on a
    twin, bit for bit; (2) 20 optimizer steps as 5 dispatches of
    ``steps=4, accumulate=2`` (microbatch 4 x 1024), fed by
    ``prefetch_to_device(..., stack=4, depth=2)`` with the warmup-cosine
    schedule as ``lr(i)``, against a synchronous loop on a twin over the
    same batches, bit for bit; then both timed in turns, after each
    twin's first call (its capture), which is timed apart."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.io import prefetch_to_device
    from paddle_tpu_torch.models import (create_multistep_train_step,
                                         create_train_step, run_steps)
    from paddle_tpu_torch.optimizer import AdamW
    K, M, micro = TRAINLOOP_K, TRAINLOOP_M, 4
    rng = np.random.RandomState(seed + 2)

    def adamw(m):
        return AdamW(TRAIN_LR, parameters=m.parameters(), weight_decay=0.01)

    # (1) steps=4 against four single steps
    cfg, (one, four) = _gpt2_twins(seed, 2, device=device, bf16=True)
    seq = cfg.max_position_embeddings
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (K, 8, seq + 1)),
                          device=device)
    x, y = ids[..., :-1], ids[..., 1:]
    step1 = create_train_step(one, adamw(one))
    ref = torch.stack([step1(x[i], y[i], TRAIN_LR) for i in range(K)])
    got = create_multistep_train_step(four, adamw(four), steps=K)(
        x, y, TRAIN_LR)
    if not torch.equal(got, ref):
        raise AssertionError(f"steps={K} losses {got.tolist()} vs {K} "
                             f"single steps {ref.tolist()}")
    unequal = [n for (n, p), q in zip(one.named_parameters(),
                                      four.parameters())
               if not torch.equal(p, q)]
    if unequal:
        raise AssertionError(f"steps={K}: parameters differ from {K} "
                             f"single steps: {unequal[:5]}")
    log(f"  multistep: steps={K} equals {K} create_train_step calls bit for "
        f"bit (losses {got.tolist()} and every parameter)")
    del one, four, step1

    # (1b) the cell's dispatch (steps=K, accumulate=M) captured, against
    # the smoke's own eager loop from one snapshot
    _, (twin,) = _gpt2_twins(seed, 1, device=device, bf16=True)
    drng = np.random.RandomState(seed + 3)
    dispatches = []
    for _ in range(3):
        bs = _loop_batches(drng, cfg.vocab_size, seq, K, micro)
        dispatches.append(tuple(torch.as_tensor(
            np.stack([b[i] for b in bs]), device=device) for i in (0, 1)))
    _hold_captured_equals_eager(
        "run_steps cell", twin, adamw,
        lambda m, o: create_multistep_train_step(m, o, steps=K,
                                                 accumulate=M),
        dispatches, TRAIN_LR, accumulate=M)
    del twin, dispatches
    if device == "cuda":
        torch.cuda.empty_cache()

    # (2) run_steps over the prefetcher against the synchronous loop
    _, (run_m, sync_m) = _gpt2_twins(seed, 2, device=device, bf16=True)
    steps = TRAIN_STEPS // K                         # dispatches per turn
    lr_of = _schedule_values(TRAIN_STEPS)

    def lr(i):                 # dispatch i: the schedule at its first step
        return lr_of[i * K]

    step_run = create_multistep_train_step(run_m, adamw(run_m), steps=K,
                                           accumulate=M)
    step_sync = create_multistep_train_step(sync_m, adamw(sync_m), steps=K,
                                            accumulate=M)
    # each twin's first call (an eager dispatch and its capture), timed
    # apart and on a dispatch of its own, so that every turn replays
    first_batch = tuple(torch.as_tensor(np.stack([b[i] for b in
                                                  _loop_batches(
        np.random.RandomState(seed + 4), cfg.vocab_size, seq, K, micro)]),
        device=device) for i in (0, 1))
    res = {"turns": [], "first_call_s": {}}
    for kind, st in (("run_steps", step_run), ("sync", step_sync)):
        _sync(device)
        t0 = time.perf_counter()
        st(*first_batch, lr(0))
        _sync(device)
        res["first_call_s"][kind] = time.perf_counter() - t0
    log(f"  first calls (eager dispatch + capture), before the turns: "
        f"{res['first_call_s']} s")
    for turn in range(4):
        batches = _loop_batches(rng, cfg.vocab_size, seq, TRAIN_STEPS,
                                micro)
        kind = ("run_steps", "sync")[turn % 2]
        _sync(device)
        t0 = time.perf_counter()
        if kind == "run_steps":
            if turn == 0:
                _reset_counts()                      # counted run starts
            feed = prefetch_to_device(iter(batches), depth=2, stack=K,
                                      device=device, name="trainloop")
            losses = run_steps(step_run, feed, lr=lr)
            _sync(device)
            wall = time.perf_counter() - t0
            if turn == 0:
                counts = _counts()                   # counted run ends
            stats = profiler.pipeline_stats("trainloop")
            feed.close()
            losses = np.concatenate(losses)
            # the synchronous twin goes over the same batches next
            pending = (batches, losses)
        else:
            batches, ref_losses = pending
            losses = []
            for j in range(steps):
                bx = np.stack([b[0] for b in batches[j * K:(j + 1) * K]])
                by = np.stack([b[1] for b in batches[j * K:(j + 1) * K]])
                losses.append(step_sync(bx, by, lr(j)).cpu().numpy())
            _sync(device)
            wall = time.perf_counter() - t0
            losses = np.concatenate(losses)
            stats = None
            if not np.array_equal(losses, ref_losses):
                raise AssertionError(f"turn {turn}: run_steps losses "
                                     f"{ref_losses.tolist()} vs the "
                                     f"synchronous loop {losses.tolist()}")
        ms = wall / TRAIN_STEPS * 1e3
        res["turns"].append({"kind": kind, "ms_per_step": ms,
                             "losses": losses.tolist(), "pipeline": stats})
        log(f"  {kind} turn {turn}: {ms:.2f} ms/step, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}"
            + (f"; host blocked {stats['host_blocked_s']:.4f} s, device "
               f"blocked {stats['device_blocked_s']:.4f} s, producer busy "
               f"{stats['producer_busy_s']:.4f} s, transfer p50 "
               f"{stats['transfer_ms']['p50']:.3f} ms ({stats['bound']}-"
               f"bound)" if stats else "") + f" [{card}]")
    unequal = [n for (n, p), q in zip(run_m.named_parameters(),
                                      sync_m.parameters())
               if not torch.equal(p, q)]
    if unequal:
        raise AssertionError(f"run_steps and the synchronous loop end with "
                             f"different parameters: {unequal[:5]}")
    first = res["turns"][0]["losses"]
    if not first[0] - first[-1] > 0:
        raise AssertionError(f"run_steps: the loss did not fall: {first}")
    expect = _expected_counts(cfg.num_layers, M * TRAIN_STEPS, "wgmma")
    if counts != expect:
        raise AssertionError(f"run_steps launches {counts}, expected "
                             f"{expect}")
    captures = {"run_steps": step_run.compile_count,
                "sync": step_sync.compile_count}
    if captures != {"run_steps": 1, "sync": 1}:
        raise AssertionError(f"captures {captures}, expected one each")
    log(f"  run_steps: losses equal the synchronous loop's bit for bit in "
        f"every turn, parameters too; launches per step 24/24/24 wgmma "
        f"flash, 50 LayerNorm, 2/2 CE; one capture each")
    bx = np.stack([b[0] for b in batches[:K]])
    by = np.stack([b[1] for b in batches[:K]])
    res["profiled"] = _hold_profiled(
        "run_steps dispatch", lambda: step_sync(bx, by, lr(0)),
        _expected_counts(cfg.num_layers, M * K, "wgmma"))
    if profile:
        res["profile"] = phase_train_profile(
            step_sync, bx, by, out_dir, lr(0), "run_steps_profile.txt")
    res.update({"microbatch": [micro, seq], "steps": K, "accumulate": M,
                "launches": counts, "captures": captures, "card": card})
    return res


def phase_optimizer_ab(seed, out_dir):
    """GPT-2's and BERT's train cells with ``use_fused_optimizer`` on and
    off in turns (on, off, on, off), each turn on a fresh AdamW over the
    same model: one warm-up step, ``TRAIN_STEPS`` timed steps (ms/step)
    and one profiled step (the ``Optimizer.step`` range and the device's
    idle share)."""
    from paddle_tpu_torch import get_flags, set_flags
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import (BertForPretraining, GPTForCausalLM,
                                         bert_large, create_train_step,
                                         gpt2_small, write_back)
    from paddle_tpu_torch.optimizer import AdamW
    out = {}
    prev = get_flags("use_fused_optimizer")
    for cell in ("gpt2s-bf16-train-b8", BERT_CELL):
        rng = np.random.RandomState(seed)
        if cell == BERT_CELL:
            cfg, lr = bert_large(), BERT_LR
            model = BertForPretraining(cfg, device="cuda",
                                       generator=make_generator(seed, "cuda"))
            seq = cfg.max_position_embeddings
            ids, labels, tt, mask, nsp = _bert_batch(
                cfg.vocab_size, rng.randint(128, seq + 1, 16), seq, rng,
                "cuda")
            loss_fn = _bert_loss_fn(tt, mask, nsp)
        else:
            cfg, lr = gpt2_small(), TRAIN_LR
            cfg.dropout = 0.0
            model = GPTForCausalLM(cfg, device="cuda",
                                   generator=make_generator(seed, "cuda"))
            seq = cfg.max_position_embeddings
            t = torch.as_tensor(rng.randint(0, cfg.vocab_size, (8, seq + 1)),
                                device="cuda")
            ids, labels, loss_fn = t[:, :-1], t[:, 1:], None
        write_back(model, {k: v.detach().to(torch.bfloat16)
                           for k, v in model.named_parameters()})
        turns = []
        try:
            for fused in (True, False, True, False):
                set_flags({"use_fused_optimizer": fused})
                opt = AdamW(lr, parameters=model.parameters(),
                            weight_decay=0.01)
                step = create_train_step(model, opt, loss_fn)
                step(ids, labels, lr)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TRAIN_STEPS):
                    step(ids, labels, lr)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
                prof = phase_train_profile(
                    step, ids, labels, out_dir, lr,
                    f"optimizer_ab-{cell}-{len(turns)}.txt")
                span = sum(v for k, v in prof["ranges_us"].items()
                           if k.startswith("Optimizer.step"))
                turns.append({"fused": fused, "ms_per_step": ms,
                              "optimizer_step_span_ms": span / 1e3,
                              "profiled_wall_ms": prof["wall_us"] / 1e3,
                              "busy_ms": prof["busy_us"] / 1e3,
                              "idle_share": prof["idle_share"]})
                log(f"  optimizer A/B {cell} fused={fused}: {ms:.2f} "
                    f"ms/step; profiled step: Optimizer.step spans "
                    f"{span / 1e3:.2f} ms of {prof['wall_us'] / 1e3:.2f} "
                    f"ms wall, idle {prof['idle_share']:.3f}")
                del opt, step
        finally:
            set_flags(prev)
        out[cell] = turns
        del model
        torch.cuda.empty_cache()
    return out


# the wgmma kernels of the train cells' bias-free attention, reported on
# lines of their own by the build phase: the forward at GPT-2's D = 64 and
# the Llama cell's D = 128, and the Llama cell's dq and dkv (no dropout)
MAIN_PATH_KERNELS = {
    "fwd_overlap_sm90_kernel<64>": "GPT-2's bias-free D = 64 forward",
    "fwd_overlap_sm90_kernel<128>": "Llama cell's bias-free D = 128 forward",
    "dq_sm90_kernel<128,0,0,0>": "Llama cell's bias-free D = 128 dq",
    "dkv128_sm90_kernel<0,0,0>": "Llama cell's bias-free D = 128 dkv",
}


def _short_kernel(mangled: str) -> str:
    """``dq_sm90_kernel<64,0,1,0>`` for a mangled wgmma kernel name: its
    template arguments (the head dim it is built for, then dropout, bias
    and segments off or on, as the kernel declares them;
    ``dkv128_sm90_kernel`` is built for D = 128 alone); likewise
    ``fwd_fp32_kernel<64,1>`` (head dim, Mask) for the fp32 forward, dq
    and dkv of the FMA route. Kernels templated on a type keep their mangled name."""
    m = re.search(r"\d+([a-z]+(?:128)?(?:_[a-z][a-z0-9]*)*?_kernel)I"
                  r"((?:L[ib]\d+E)+)", mangled)
    if not m:
        return mangled
    args = re.findall(r"(\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(text: str, sass: str = "") -> dict:
    """Per kernel entry of an ``-Xptxas -v`` build log: registers and
    spill bytes (under ``_short_kernel``'s name), and with the library's
    SASS (``cuobjdump -sass``) its HGMMA instructions and the wgmma waits
    (``WARPGROUP.DEPBAR``) among them: one wait per HGMMA means ptxas
    serialised the products; under ``ops`` its HMMA, FFMA and shared-load
    (LDS) instructions, as they stand in the code. Also every warning
    line, names shortened."""
    kernels, warnings, cur = [], [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": _short_kernel(m.group(1))}
            kernels.append(cur)
        elif "warning" in line:
            warnings.append(re.sub(
                r"_Z\w+", lambda w: _short_kernel(w.group(0)), line.strip()))
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    code, loads, top, ops = {}, {}, {}, {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split(None, 1)
        code[_short_kernel(name)] = (body.count("HGMMA"),
                             body.count("WARPGROUP.DEPBAR"))
        # global (LDG) and generic (LD) loads in the code, not per run
        loads[_short_kernel(name)] = len(re.findall(r"\bLDG?\.E", body))
        # the highest register the code names: above ptxas's count (the
        # launch's 168) where setmaxnreg gave the consumers more
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        top[_short_kernel(name)] = max(regs, default=None)
        ops[_short_kernel(name)] = {
            op: len(re.findall(rf"\b{op}\b(?!M)", body))
            for op in ("HMMA", "FFMA", "LDS")}
    for row in kernels:
        if row["kernel"] in code:
            row["hgmma"], row["wgmma_waits"] = code[row["kernel"]]
    return {"kernels": kernels, "warnings": warnings, "global_loads": loads,
            "max_register": top, "ops": ops}


def sass_of(lib) -> str:
    """``cuobjdump -sass`` of a built library (the toolkit's, beside
    nvcc), or "" where it cannot be read."""
    from paddle_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    try:
        return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                    help="directory for the JSON report and the profiles")
    ap.add_argument("--profile", action="store_true",
                    help="also profile decode steps and one train step")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of kernels,serve,train,bert"
                         ",llama,trainloop,observe (default: all); a subset "
                         "is a development aid and ends with \"ok\": "
                         "\"partial\", not true")
    ap.add_argument("--optimizer-ab", action="store_true",
                    help="also time GPT-2's and BERT's train cells with "
                         "use_fused_optimizer on and off in turns")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"--phases: unknown {sorted(phases - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs the card",
              file=sys.stderr)
        return 2
    # the port itself: a checkout without it fails here
    from paddle_tpu_torch.ops.kernels import _build, norms
    from paddle_tpu_torch.ops.kernels import cross_entropy as ce
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {built or 'nothing new'} in {build_s:.1f} s -> "
        f"{_build.BUILD_DIR}")
    sm90_log = _build.BUILD_LOGS.get("flash_attention_sm90", "")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ptxas_flash_attention_sm90.txt"),
              "w") as f:
        f.write(sm90_log)
    ptxas = ptxas_report(sm90_log, sass_of(
        _build.library_path("flash_attention_sm90")))
    for row in ptxas["kernels"]:
        log(f"  ptxas {row['kernel']}: {row.get('registers')} registers "
            f"(highest R{ptxas['max_register'].get(row['kernel'])}), "
            f"spill stores {row.get('spill_stores')} B, loads "
            f"{row.get('spill_loads')} B; SASS {row.get('hgmma')} HGMMA, "
            f"{row.get('wgmma_waits')} wgmma waits, "
            f"{ptxas['global_loads'].get(row['kernel'])} global loads")
    for line in ptxas["warnings"]:
        log(f"  ptxas {line}")
    for row in ptxas["kernels"]:
        if row["kernel"] in MAIN_PATH_KERNELS:
            serial = (row.get("wgmma_waits") or 0) >= (row.get("hgmma") or 1)
            log(f"  ptxas {MAIN_PATH_KERNELS[row['kernel']]}, "
                f"{row['kernel']}: spill stores {row.get('spill_stores')} "
                f"B, loads {row.get('spill_loads')} B; {row.get('hgmma')} "
                f"HGMMA, "
                f"{row.get('wgmma_waits')} wgmma waits (products "
                f"{'serialised' if serial else 'not serialised'})")

    # the FMA route's fp32 forward, dq and dkv (head dims up to 128): FFMA
    # blocked in registers, no tensor-core product
    fma_log = _build.BUILD_LOGS.get("flash_attention", "")
    with open(os.path.join(args.out, "ptxas_flash_attention.txt"), "w") as f:
        f.write(fma_log)
    ptxas_fp32 = ptxas_report(fma_log, sass_of(
        _build.library_path("flash_attention")))
    for row in ptxas_fp32["kernels"]:
        if "_fp32_kernel<" in row["kernel"] or "mma_kernel<" in row["kernel"]:
            ops = ptxas_fp32["ops"].get(row["kernel"], {})
            what = ("bf16 " + row["kernel"].split("_")[0]
                    if "mma_kernel<" in row["kernel"]
                    else "fp32 forward / dq / dkv")
            log(f"  ptxas {row['kernel']} ({what}, FMA "
                f"route): "
                f"{row.get('registers')} registers, spill stores "
                f"{row.get('spill_stores')} B, loads {row.get('spill_loads')}"
                f" B; SASS {ops.get('HMMA')} HMMA, {ops.get('FFMA')} FFMA, "
                f"{ops.get('LDS')} shared loads")

    report = {"card": card, "build": {"sources": built, "seconds": build_s,
                                      "ptxas_sm90": ptxas,
                                      "ptxas_fp32": ptxas_fp32}}
    rows = {}
    if "kernels" in phases:
        log("kernels:")
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        worst, timings, report["rms_norm_tolerance_used"] = phase_kernels(
            norms, gen)
        report["timings"] = timings
        main_t = next(t for t in timings
                      if t["rows"] == 8 and t["dtype"] == "float32")
        rows["rms_norm"] = dict(main_t, max_abs_err=worst)
        rows["layer_norm"], report["layer_norm_bert"], \
            report["layer_norm_tolerance_used"] = phase_layer_norm(
                norms, gen)
        timed, report["flash_errors"], report["flash_tolerance_used"] = \
            phase_flash(fa, gen)
        # the table's rows: the bias-free wgmma kernels at GPT-2's shape and
        # the FMA ones at its fp32 oracle's (the shape their launches run
        # at), their bias instantiations at BERT's (wgmma, with its
        # dropout: the forward's, dq's and dkv's "keys" class, and the
        # "plane" class on the mask materialised, which gives the same
        # bits) and the BERT oracle's (FMA)
        for kind in WGMMA_KINDS:
            rows["flash_" + kind] = timed["gpt2"].pop(kind)
        for kind in FMA_KINDS:
            rows["flash_" + kind] = timed["gpt2_oracle_fp32"].pop(kind)
        for kind in WGMMA_KINDS:
            rows[f"flash_{kind}_keybias"] = timed["bert"].pop(kind)
            rows[f"flash_{kind}_bias"] = dict(
                timed["bert_plane"].pop(kind),
                max_abs_err=rows[f"flash_{kind}_keybias"]["max_abs_err"])
        for kind in FMA_KINDS:
            rows[f"flash_{kind}_bias"] = timed["bert_oracle_fp32"].pop(kind)
        # the FMA route's bf16 forward, dq and dkv at GPT-2's shape, and
        # with BERT's key mask and dropout (their Mask instantiations)
        for kind in FMA_KINDS:
            rows[f"flash_{kind}_mma"] = timed["gpt2"].pop(kind)
            rows[f"flash_{kind}_mma_bias"] = timed["bert"].pop(kind)
        report["flash_timings"] = timed
        torch.cuda.empty_cache()
        ce_rows, report["ce_bert"], report["ce_errors"], \
            report["ce_tolerance_used"] = phase_ce(ce, gen)
        report["ce_fwd_bwd_ms"] = ce_rows.pop("fwd_bwd_ms")
        for kind, row in ce_rows.items():
            rows["softmax_xent_" + kind] = row
        torch.cuda.empty_cache()

    by_path = {}                        # launches of each path's counted run
    if "serve" in phases:
        report["serve"] = {}
        for cell in SERVE_CELLS:
            log(f"serve {cell}:")
            model, prompts, report["serve"][cell], by_path[cell] = \
                phase_serve(cell, args.seed, card)
            if args.profile:
                log(f"profile {cell}:")
                report["serve"][cell]["profile"] = phase_profile(
                    cell, model, prompts, args.out)
            del model
            torch.cuda.empty_cache()

    if "train" in phases:
        cell = "gpt2s-bf16-train-b8"
        log(f"train {cell}:")
        oracle = phase_train_oracle(args.seed)
        by_path["gpt2s-fp32-train-oracle"] = oracle["launches"]
        recomputed = phase_train_recompute(args.seed)
        torch.cuda.empty_cache()
        res = phase_train_full(args.seed, card, args.profile, args.out)
        res["oracle"] = oracle
        res["recompute_captured"] = recomputed
        report["train"] = {cell: res}
        by_path[cell] = res["launches"]
        torch.cuda.empty_cache()

    if "bert" in phases:
        log(f"bert {BERT_CELL}:")
        oracle = phase_bert_oracle(args.seed)
        by_path["bert-fp32-pretrain-oracle"] = oracle["launches"]
        torch.cuda.empty_cache()
        res = phase_bert_full(args.seed, card, args.profile, args.out)
        res["oracle"] = oracle
        report.setdefault("train", {})[BERT_CELL] = res
        by_path[BERT_CELL] = res["launches"]
        torch.cuda.empty_cache()

    if "llama" in phases:
        log(f"llama {LLAMA_CELL}:")
        t0 = time.perf_counter()
        fused_checked = check_fused_adamw_on_card(args.seed)
        oracle = phase_llama_oracle(args.seed)
        by_path["llama-fp32-train-oracle"] = oracle["launches"]
        for policy in ("full", "dots_saveable"):
            by_path[f"llama-fp32-recompute-{policy}"] = \
                oracle["recompute"][policy]["launches"]
        torch.cuda.empty_cache()
        res = phase_llama_full(args.seed, card, args.profile, args.out)
        res["oracle"] = oracle
        res["fused_adamw_tensors_checked"] = fused_checked
        res["phase_seconds"] = time.perf_counter() - t0
        log(f"  phase llama: {res['phase_seconds']:.1f} s")
        report.setdefault("train", {})[LLAMA_CELL] = res
        by_path[LLAMA_CELL] = res["launches"]
        torch.cuda.empty_cache()

    if "trainloop" in phases:
        log("trainloop:")
        t0 = time.perf_counter()
        res = {"oracle": phase_trainloop_oracle(args.seed)}
        by_path["gpt2s-fp32-trainloop-oracle"] = res["oracle"]["launches"]
        torch.cuda.empty_cache()
        res[TRAINLOOP_EAGER_CELL] = phase_trainloop_eager(
            args.seed, card, profile=args.profile, out_dir=args.out)
        by_path[TRAINLOOP_EAGER_CELL] = res[TRAINLOOP_EAGER_CELL]["launches"]
        torch.cuda.empty_cache()
        res["clip_bf16"] = phase_trainloop_clip_bf16(args.seed, card)
        by_path["gpt2s-bf16-O2-clip-2l"] = res["clip_bf16"]["launches"]
        torch.cuda.empty_cache()
        res[TRAINLOOP_RUN_CELL] = phase_trainloop_run_steps(
            args.seed, card, profile=args.profile, out_dir=args.out)
        by_path[TRAINLOOP_RUN_CELL] = res[TRAINLOOP_RUN_CELL]["launches"]
        res["phase_seconds"] = time.perf_counter() - t0
        log(f"  phase trainloop: {res['phase_seconds']:.1f} s")
        report["trainloop"] = res
        torch.cuda.empty_cache()

    if "observe" in phases:
        log(f"observe {OBSERVE_CELL}:")
        t0 = time.perf_counter()
        res = phase_observe(args.seed, card, args.out)
        res["phase_seconds"] = time.perf_counter() - t0
        log(f"  phase observe: {res['phase_seconds']:.1f} s")
        report["observe"] = res
        by_path[f"{OBSERVE_CELL}-traced"] = res["launches"]
        by_path[f"{TRAINLOOP_RUN_CELL}-traced"] = \
            res["run_steps"]["launches"]

    if args.optimizer_ab:
        log("optimizer A/B (use_fused_optimizer on, off, on, off):")
        report["optimizer_ab"] = phase_optimizer_ab(args.seed, args.out)
        torch.cuda.empty_cache()

    sources = {
        "rms_norm": ("rms_norm.cu", "paddle_tpu/ops/pallas/norms.py:66"),
        "layer_norm": ("layer_norm.cu", "paddle_tpu/ops/pallas/norms.py:162"),
        "softmax_xent_fwd": ("cross_entropy.cu",
                             "paddle_tpu/ops/pallas/cross_entropy.py:32"),
        "softmax_xent_bwd": ("cross_entropy.cu",
                             "paddle_tpu/ops/pallas/cross_entropy.py:48"),
        "flash_fwd": ("flash_attention.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:158"),
        "flash_fwd_wgmma": ("flash_attention_sm90.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:158"),
        "flash_dq": ("flash_attention.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:383"),
        "flash_dq_wgmma": ("flash_attention_sm90.cu",
                           "paddle_tpu/ops/pallas/flash_attention.py:383"),
        "flash_dkv": ("flash_attention.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:455"),
        "flash_dkv_wgmma": ("flash_attention_sm90.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:455"),
    }
    # the bias instantiations (each counted on its own counter): the BERT
    # paths, where every attention carries the mask; the wgmma kernels
    # take it as a "keys" bias, and their "plane" instantiations run for
    # every other bias (no main path has one)
    for kind in FLASH_KINDS:
        sources[f"flash_{kind}_bias"] = sources[f"flash_{kind}"]
    for kind in WGMMA_KINDS:
        sources[f"flash_{kind}_keybias"] = sources[f"flash_{kind}"]
    # the FMA route's bf16 forward, dq and dkv (fwd_mma_kernel,
    # dq_mma_kernel, dkv_mma_kernel), without and with the Mask; no main
    # path launches them
    for kind in FMA_KINDS:
        sources[f"flash_{kind}_mma"] = sources[f"flash_{kind}_mma_bias"] = \
            sources[f"flash_{kind}"]
    report["launches_by_path"] = by_path
    kernels = []
    for name, (src, replaces) in sources.items():
        row = rows.get(name, {})
        mine = {path: c[name] for path, c in by_path.items() if c[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": sum(mine.values()) if by_path else None,
            "launches_by_path": mine,
            **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}})
    report["kernels"] = kernels
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if phases == set(PHASES):
        print(json.dumps({"ok": True, "device": device}), flush=True)
    else:
        print(json.dumps({"ok": "partial", "phases": sorted(phases),
                          "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
