"""A/B of kernel design choices on one CUDA card, timed in turns.

    python3 chip_ab.py [--out DIR]

Builds copies of two kernel sources, each with one design choice of the
committed source switched back or to an alternative, under
``build/chip_ab`` (one ``nvcc`` per copy, all started at once, with the
port's build flags), holds each copy's results to the committed
build's, and times every copy in CUDA graphs in turns (the list
forward, then backward):

- ``csrc/rms_norm.cu`` at decode's rows [1, 8, 13] x 4096 fp32, the
  prompt buckets [32..512] x 4096 and the Llama train cell's
  [16384, 2048] bf16: the many-row route alone (the small-row route
  off), the small-row route without each of its three parts (w loaded
  after the reduction; ``ptk::block_sum``'s two barriers; a plain
  launch, no programmatic dependent launch) and with each part alone,
  with a ``griddepcontrol.launch_dependents`` trigger added, and at
  every row count; beside an empty kernel's floor launched both ways. Outputs must
  equal the committed build's bit for bit.
- ``csrc/cross_entropy.cu`` at GPT-2's [8192, 50304] and BERT's
  [8192, 30522] bf16 logits, forward and backward: eight 16-byte vectors
  in flight a thread instead of four, and 512 threads a block instead of
  256. Loss and lse must stay within chip_smoke.py's ``CE_RTOL``.

Needs one card; prints the card's name and power limit, each copy's
time per turn, and writes them as JSON to ``DIR/chip_ab.json`` (default
``build/chip_ab``). A development aid for choosing among designs, not a
check of the port: chip_smoke.py is that.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
CSRC = REPO / "paddle_tpu_torch" / "ops" / "kernels" / "csrc"


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"chip_ab: the source no longer holds {old!r}")
    return src.replace(old, new)


# (old text, new text) rewrites of csrc/rms_norm.cu for each variant
_RMS_ROWS_ONLY = ("constexpr long long kSmallRows = 132;",
                  "constexpr long long kSmallRows = 0;")
_RMS_ALL_SMALL = ("constexpr long long kSmallRows = 132;",
                  "constexpr long long kSmallRows = 1LL << 40;")
_RMS_LATE_W = (
    "      if (w != nullptr) {\n"
    "        ptk::load_vec<TW, VEC>(w + v * VEC, wc[j]);",
    "      if (false) {\n"
    "        ptk::load_vec<TW, VEC>(w + v * VEC, wc[j]);")
_RMS_LATE_W_STORE = (
    "      float out[VEC];\n"
    "#pragma unroll\n"
    "      for (int k = 0; k < VEC; ++k) out[k] = xc[j][k] * r * wc[j][k];",
    "      float out[VEC];\n"
    "      if (w != nullptr) ptk::load_vec<TW, VEC>(w + v * VEC, wc[j]);\n"
    "#pragma unroll\n"
    "      for (int k = 0; k < VEC; ++k) out[k] = xc[j][k] * r * wc[j][k];")
_RMS_TWO_BARRIERS = (
    "  __shared__ float part[kWarps];\n"
    "  ss = ptk::warp_sum(ss);\n"
    "  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;\n"
    "  __syncthreads();\n"
    "  const float r = rsqrtf(sum_partials(part) / static_cast<float>(n) "
    "+ eps);",
    "  const float r = rsqrtf(ptk::block_sum(ss) / static_cast<float>(n) "
    "+ eps);")
_RMS_PLAIN_LAUNCH = (
    "                       Args... args) {\n",
    "                       Args... args) {\n"
    "  kernel<<<grid, kThreads, 0, s>>>(args...);\n"
    "  return cudaGetLastError();\n")
_RMS_TRIGGER = (
    "  wait_for_previous_grid();\n  const long long row = blockIdx.x;",
    "  wait_for_previous_grid();\n"
    "  asm volatile(\"griddepcontrol.launch_dependents;\");\n"
    "  const long long row = blockIdx.x;")

RMS_VARIANTS = {
    "committed": (),
    "many-row route only": (_RMS_ROWS_ONLY,),
    "no early w": (_RMS_LATE_W, _RMS_LATE_W_STORE),
    "two barriers": (_RMS_TWO_BARRIERS,),
    "no PDL": (_RMS_PLAIN_LAUNCH,),
    "early w only": (_RMS_TWO_BARRIERS, _RMS_PLAIN_LAUNCH),
    "one barrier only": (_RMS_LATE_W, _RMS_LATE_W_STORE, _RMS_PLAIN_LAUNCH),
    "PDL only": (_RMS_LATE_W, _RMS_LATE_W_STORE, _RMS_TWO_BARRIERS),
    "with trigger": (_RMS_TRIGGER,),
    "small-row route at every row count": (_RMS_ALL_SMALL,),
}
CE_VARIANTS = {
    "committed": (),
    "8 vectors in flight": (("constexpr int kUnroll = 4;",
                             "constexpr int kUnroll = 8;"),),
    "512 threads": (("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;"),),
}
RMS_SHAPES = [(1, 4096, torch.float32), (8, 4096, torch.float32),
              (13, 4096, torch.float32), (32, 4096, torch.float32),
              (128, 4096, torch.float32), (256, 4096, torch.float32),
              (512, 4096, torch.float32), (8, 4096, torch.bfloat16),
              (16384, 2048, torch.bfloat16)]
CE_SHAPES = [(8192, 50304), (8192, 30522)]


def variant_sources() -> dict:
    """{(source, variant): text} for every variant of both sources."""
    out = {}
    for name, table in (("rms_norm", RMS_VARIANTS),
                        ("cross_entropy", CE_VARIANTS)):
        base = (CSRC / f"{name}.cu").read_text()
        for variant, edits in table.items():
            text = base
            for old, new in edits:
                text = _edit(text, old, new)
            out[(name, variant)] = text
    return out


def _build_all(out_dir: Path) -> dict:
    sys.path.insert(0, str(REPO))
    from paddle_tpu_torch.ops.kernels import _build
    work = REPO / "build" / "chip_ab"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, text) in enumerate(variant_sources().items()):
        src = work / f"{key[0]}_{i}.cu"
        src.write_text(text)
        lib = work / f"lib{key[0]}_{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(lib), str(src)]
        procs[key] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"ptxas_{lib.stem}.txt").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log[-4000:]}")
        cdll = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in _build._SIGNATURES[key[0]].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = restype
        libs[key] = cdll
    return libs


def _time_graph_ms(fn, reps: int, iters: int) -> float:
    """chip_smoke.py's time_graph_ms: ``reps`` calls in a CUDA graph,
    replayed ``iters`` times between CUDA events."""
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


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _code(t):
    return 0 if t is None or t.dtype == torch.float32 else 1


def _in_turns(names, fn, reps, iters):
    """{name: [time in the forward turn, time in the backward turn]}."""
    times = {n: [] for n in names}
    for n in list(names) + list(names)[::-1]:
        times[n].append(_time_graph_ms(lambda: fn(n), reps, iters))
    return times


def ab_rms_norm(libs, gen) -> dict:
    names = list(RMS_VARIANTS)
    res = {}
    for rows, n, dtype in RMS_SHAPES:
        x = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(n, device="cuda", generator=gen) + 1.0).to(dtype)
        y = torch.empty_like(x)
        inv = torch.empty(rows, device="cuda")

        def call(name, ww=w, yy=y):
            lib = libs[("rms_norm", name)]
            rc = lib.rms_norm_fwd(_ptr(x), _ptr(ww), _ptr(yy), _ptr(inv),
                                  rows, n, 1e-5, _code(x), _code(ww),
                                  _stream())
            assert rc == 0, rc
        for ww in (w, None):
            want = None
            for name in names:
                yy = torch.empty_like(x)
                call(name, ww, yy)
                got = (yy, inv.clone())
                want = want or got
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"rms_norm {name} [{rows},{n}] "
                                         "differs from the committed build")
        key = f"[{rows},{n}] {str(dtype)[6:]}"
        res[key] = _in_turns(names, call, reps=100, iters=20)
        print(f"  rms_norm {key}: " + ", ".join(
            f"{k} {t[0] * 1e3:.3f}/{t[1] * 1e3:.3f}"
            for k, t in res[key].items()) + " us", flush=True)
        floor = libs[("rms_norm", "committed")]
        res[key + " floor"] = {
            f"pdl {pdl}": [_time_graph_ms(lambda: floor.rms_norm_floor(
                rows, pdl, _stream()), 100, 20) for _ in range(2)]
            for pdl in (0, 1)}
        print(f"  empty kernel of {rows} blocks: " + ", ".join(
            f"{k} {t[0] * 1e3:.3f}/{t[1] * 1e3:.3f}"
            for k, t in res[key + " floor"].items()) + " us", flush=True)
    return res


def ab_cross_entropy(libs, gen) -> dict:
    names = list(CE_VARIANTS)
    res = {}
    for rows, v in CE_SHAPES:
        x = torch.randn(rows, v, device="cuda", generator=gen).bfloat16()
        lab = torch.randint(0, v, (rows,), device="cuda", generator=gen)
        g = torch.randn(rows, device="cuda", generator=gen)
        loss = torch.empty(rows, device="cuda")
        lse = torch.empty(rows, device="cuda")
        dx = torch.empty_like(x)

        def fwd(name):
            rc = libs[("cross_entropy", name)].softmax_xent_fwd(
                _ptr(x), _ptr(lab), _ptr(loss), _ptr(lse), rows, v, 1,
                _stream())
            assert rc == 0, rc

        def bwd(name):
            rc = libs[("cross_entropy", name)].softmax_xent_bwd(
                _ptr(x), _ptr(lab), _ptr(lse), _ptr(g), _ptr(dx), rows, v,
                1, _stream())
            assert rc == 0, rc
        fwd("committed")
        want = (loss.clone(), lse.clone())
        for name in names:
            fwd(name)
            for got, ref in zip((loss, lse), want):
                tol = 5e-7 * (ref.abs() + ref.pow(2).mean().sqrt())
                if not bool(((got - ref).abs() <= tol).all()):
                    raise AssertionError(f"cross_entropy {name} [{rows},"
                                         f"{v}] outside CE_RTOL")
        for kind, fn in (("fwd", fwd), ("bwd", bwd)):
            key = f"{kind} [{rows},{v}] bf16"
            res[key] = _in_turns(names, fn, reps=10, iters=5)
            print(f"  softmax_xent {key}: " + ", ".join(
                f"{k} {t[0]:.4f}/{t[1]:.4f}" for k, t in res[key].items())
                + " ms", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "chip_ab"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = _build_all(out_dir)
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"card": card, "rms_norm": ab_rms_norm(libs, gen),
              "cross_entropy": ab_cross_entropy(libs, gen)}
    (out_dir / "chip_ab.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
