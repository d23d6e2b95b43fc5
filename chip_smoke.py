"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

    python3 chip_smoke.py [--seed N] [--out DIR]

Needs one CUDA card; without one it exits non-zero and prints no result.
Phases, each fatal on failure:

1. card: the ``nvidia-smi`` name and power limit; TF32 off for matmuls
   and cuDNN, so fp32 means fp32.
2. build: every kernel under ``paddle_tpu_torch/ops/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, in parallel), timed.
3. kernels: each kernel against its plain PyTorch version on the card
   at the main path's shapes, then timed beside its bound, its plain
   version and the one PyTorch call computing the same function.
4. serve: Llama-2 7B at full width, fp32, random weights from ``--seed``,
   behind the continuous-batching ``DecodeServer``: 8 mixed-length
   prompts from client threads, 32 greedy tokens each. Every RMSNorm of
   the run must go through the CUDA kernel (launch counts), and two of
   the requests are replayed through ``decode_step`` with a contiguous
   cache, teacher-forced along the server's tokens, as the oracle.
5. profile (only with ``--profile``): a second round whose batch-8
   decode steps run under ``torch.profiler``: device time by kernel
   class and the device's idle share, written to ``--out``.

The line before the last holds the kernel table as JSON; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
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

PROMPT_LENS = (17, 40, 64, 100, 128, 200, 256, 300)
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


def phase_kernels(norms, gen):
    """RMSNorm kernel vs rms_norm_plain on the card, then timings."""
    dev = torch.device("cuda")
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    worst = 0.0
    # the main path's rows: decode batch bucket 8 and the prompt buckets
    # 32..512 of the served prompts, at N = 4096; then a ragged row
    # count and a width that takes the scalar path
    shapes = [(r, 4096) for r in (8, 32, 64, 128, 256, 512)]
    for rows, n in shapes + [(13, 4096), (3, 1000)]:
        for dtype in (torch.float32, torch.bfloat16):
            for with_w in (True, False):
                x = torch.randn(rows, n, device=dev, generator=gen,
                                dtype=torch.float32).to(dtype)
                w = (torch.randn(n, device=dev, generator=gen) + 1.0
                     ).to(dtype) if with_w else None
                y, inv = norms.rms_norm(x, w, 1e-5)
                yp, invp = norms.rms_norm_plain(x, w, 1e-5)
                torch.cuda.synchronize()
                t = tol[dtype]
                torch.testing.assert_close(y.float(), yp.float(), atol=t,
                                           rtol=t)
                torch.testing.assert_close(inv, invp, atol=1e-5, rtol=1e-5)
                err = float((y.float() - yp.float()).abs().max())
                if dtype == torch.float32:
                    worst = max(worst, err)
                log(f"  rms_norm [{rows},{n}] {str(dtype)[6:]} "
                    f"w={'yes' if with_w else 'no'}: max|y-plain| {err:.3e}"
                    f" (tol {t:g}) ok")
    timings = []
    for rows in (8, 512):
        for dtype in (torch.float32, torch.bfloat16):
            n = 4096
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
            }
            row["bound_ms"], row["bound_by"], row["bytes"] = rms_bound(
                rows, n, dtype)
            timings.append(row)
            log(f"  time rms_norm [{rows},{n}] {row['dtype']}: kernel "
                f"{row['ms'] * 1e3:.2f} us (eager call "
                f"{row['eager_ms'] * 1e3:.2f} us), plain "
                f"{row['plain_ms'] * 1e3:.2f} us (eager "
                f"{row['eager_plain_ms'] * 1e3:.2f} us), "
                f"F.rms_norm {row['library_ms'] * 1e3:.2f} us; bound "
                f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
                f"({row['bytes']} B)")
    return worst, timings


def phase_serve(cfg, seed, card, device="cuda"):
    """Serve the prompts through DecodeServer; check launch counts and
    the teacher-forced contiguous-cache oracle. Returns (model, prompts,
    results, rms_norm launches of the run)."""
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels.norms import rms_norm
    from paddle_tpu_torch.serving.decode import DecodeServer

    norms_per_call = 2 * cfg.num_layers + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device,
                             generator=make_generator(seed, device))
    model.eval()
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"  model: {cfg}, {nparams} params fp32, drawn on {device} "
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
               for n in PROMPT_LENS]
    srv = DecodeServer(model, max_slots=8, page_len=16, max_context=512,
                       device=device)
    try:
        streams = [None] * len(prompts)

        def client(i):
            streams[i] = srv.submit(prompts[i], max_new_tokens=NEW_TOKENS)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        rms_norm.launches = 0                       # counted run starts
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        outs = [s.result(timeout=600) for s in streams]
        t_total = time.perf_counter() - t_start
        launches = rms_norm.launches                # counted run ends
        st = srv.stats()
        n_exec = srv.num_executables()
    finally:
        srv.shutdown()
    for i, o in enumerate(outs):
        if len(o) != NEW_TOKENS:
            raise AssertionError(f"request {i} gave {len(o)} tokens, "
                                 f"expected {NEW_TOKENS}")
    steps = st["prefills"] + st["decode_steps"]
    expect = norms_per_call * steps
    log(f"  served {len(outs)} requests: {st['prefills']} prefills + "
        f"{st['decode_steps']} decode steps, rms_norm launches {launches} "
        f"(expected {norms_per_call} x {steps} = {expect})")
    if launches != expect:
        raise AssertionError("not every RMSNorm went through the kernel")
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
    peak = torch.cuda.max_memory_allocated()
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
        "rms_norm_launches": launches,
        "num_executables": n_exec,
        "peak_mem_bytes": peak,
        "oracle_worst_gap": worst_gap,
        "card": card,
    }
    log(f"  decode: {res['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{res['ttft_ms_p50']:.1f} ms, decode step p50 "
        f"{res['decode_step_ms_p50']:.2f} ms, peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    return model, prompts, res, launches


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "rms_norm_fwd_kernel" in n:
        return "rms_norm kernel"
    if any(k in n for k in ("gemm", "gemv", "splitk")):
        return "matmul (cuBLAS/CUTLASS)"
    if "softmax" in n:
        return "softmax"
    if any(k in n for k in ("gather", "index", "scatter")):
        return "gather/index (KV pages, embedding)"
    if "reduce" in n:
        return "reductions"
    return "elementwise/copy"


def phase_profile(model, prompts, out_dir, device="cuda"):
    """A second round (not counted): once all 8 prompts are prefilled,
    ``torch.profiler`` records the batch-8 decode steps. Reports device
    time by kernel and by class, and the device's busy share of the
    window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving.decode import DecodeServer
    srv = DecodeServer(model, max_slots=8, page_len=16, max_context=512,
                       device=device)
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
    with open(os.path.join(out_dir, "decode_profile.txt"), "w") as f:
        f.write(json.dumps(out, indent=1) + "\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=30) + "\n")
    log(f"  profile: {steps} batch-8 decode steps in {wall_us / 1e3:.1f} ms"
        f" wall, device busy {busy / 1e3:.1f} ms (idle share "
        f"{out['idle_share']:.3f})")
    for c, v in out["classes_us_per_step"].items():
        log(f"    {v:10.1f} us/step  {c}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                    help="directory for the JSON report and the profile")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a short second round of requests")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs the card",
              file=sys.stderr)
        return 2
    # the port itself: a checkout without it fails here
    from paddle_tpu_torch.ops.kernels import _build, norms

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {built or 'nothing new'} in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")

    log("kernels:")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst, timings = phase_kernels(norms, gen)

    log("serve:")
    from paddle_tpu_torch.models import llama_7b
    model, prompts, res, launches = phase_serve(llama_7b(), args.seed, card)

    top = None
    if args.profile:
        log("profile:")
        top = phase_profile(model, prompts, args.out)

    main_t = next(t for t in timings
                  if t["rows"] == 8 and t["dtype"] == "float32")
    kernels = [{
        "name": "rms_norm",
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/rms_norm.cu",
        "replaces": "paddle_tpu/ops/pallas/norms.py:66",
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
    }]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "timings": timings,
                   "serve": res, "profile": top}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
