"""A/B of kernel design choices on one CUDA card, timed in turns.

    python3 chip_ab.py [--out DIR]

Builds copies of three kernel sources, each with one design choice of
the committed source switched back or to an alternative, under
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
- ``csrc/flash_attention.cu``'s fp32 forward, dq and dkv
  (``fwd_fp32_kernel``, ``dq_fp32_kernel``, ``dkv_fp32_kernel``) at the
  attention of the three fp32 oracles (BERT's B2 S512 H16 D64 with its
  key mask, GPT-2's B1 S1024 H12 D64 and the Llama's B1 S1024 H16 D128,
  both causal): the one-tile fwd_kernel in the forward's place (the
  parent of its redesign), P in the consumed K stage, two blocks an SM,
  the bias read after the products, blocks in the grid's own order;
  the one-tile FFMA kernels (fwd_kernel, dq_kernel, dkv_kernel) for all
  three passes, dq at two blocks an SM, dkv on 32-row q tiles (at one
  and at two blocks an SM), each of which must give the committed
  build's bits; and the forward, or dq and dkv, with their products on
  the tensor cores as 3xTF32 (mma.sync m16n8k8, each operand split into
  two TF32 parts), whose out and lse, or dq, dk and dv, are held to the
  plain version only to report the share of chip_smoke.py's
  ``FLASH_RTOL`` (and ``LSE_RTOL``) they use.
- the same source's bf16 forward of the FMA route (``fwd_mma_kernel``)
  at GPT-2's and Llama-2 7B's training attention, Gemma-7B's (D = 256)
  and an odd head dim (D = 45), all causal: the parent's one-tile
  fwd_kernel in its place, one 16-row block a warp, 4 warps or 32-key
  tiles at D = 256, 32-key tiles at D = 128, the S loop unrolled by two,
  O rescaled only when a max moved; out and lse within ``FLASH_RTOL``
  and ``LSE_RTOL`` of the plain version, each copy's ptxas registers and
  spills printed, timed in turns beside sdpa.
- its bf16 dq and dkv of the FMA route (``dq_mma_kernel``,
  ``dkv_mma_kernel``) at the same shapes: the parent's one-tile
  dq_kernel / dkv_kernel in their place, and the register budget's
  alternatives (dq with 4 warps at D = 256, also with 64-key tiles; dq
  on 32-key tiles; dq at three blocks an SM at D = 64; dkv on 32-row q
  tiles at D = 64, 128 and 256; dkv splitting D at D = 128 as at 256;
  dkv at one block an SM at D = 64), also at BERT-large's attention with
  its key mask and dropout 0.1; dq, dk and dv held by chip_smoke.py's
  ``check_exact`` against an fp64 backward (their share of
  ``FLASH_RTOL["bwd"]`` reported), each copy's ptxas registers and
  spills printed, timed in turns beside sdpa's backward.

    python3 chip_ab.py --kernels flash_attention [--flash-parts bf16_bwd]

runs one source's copies alone (``--flash-parts``: only the named flash
A/Bs, of fp32, bf16_fwd and bf16_bwd, are built and run). Needs one
card; prints the card's name and power limit, each copy's time per
turn, and writes them as JSON to ``DIR/chip_ab.json`` (default
``build/chip_ab``). A development aid for
choosing among designs, not a check of the port: chip_smoke.py is that.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
CSRC = REPO / "paddle_tpu_torch" / "ops" / "kernels" / "csrc"


def _edit(src: str, old, new: str) -> str:
    """``src`` with ``old`` replaced by ``new``; ``old`` a (start, end)
    pair replaces the text from start up to, not including, end. Each
    piece must occur once."""
    for piece in (old if isinstance(old, tuple) else (old,)):
        if src.count(piece) != 1:
            raise ValueError(f"chip_ab: the source no longer holds "
                             f"{piece!r}")
    if isinstance(old, tuple):
        start, end = old
        i, j = src.index(start), src.index(end)
        return src[:i] + new + src[j:]
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
# (old text, new text) rewrites of csrc/flash_attention.cu
_FA_ONE_TILE = (
    "constexpr bool kRing = std::is_same<T, float>::value && DP <= 128;",
    "constexpr bool kRing = false;")
_FA_DQ_TWO_BLOCKS = (
    "__global__ void __launch_bounds__(kThreads)\ndq_fp32_kernel",
    "__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)\n"
    "dq_fp32_kernel")
_FA_DKV_32_ROWS = ("constexpr int kDkvRows = DP == 64 ? 64 : 32;",
                   "constexpr int kDkvRows = 32;")
_FA_DKV_TWO_BLOCKS = (
    "__global__ void __launch_bounds__(kThreads)\ndkv_fp32_kernel",
    "__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)\n"
    "dkv_fp32_kernel")
_FA_SECTION = ("// dq: grid (nq, B*Hq), as dq_kernel\n",
               "// -----------------------------------------------------------"
               "----------------\n// bf16 forward on the tensor cores")
_FA_TF32_HELPERS = r"""// Products on the tensor cores, 3xTF32: each fp32
// operand x split into big = tf32(x) and small = tf32(x - big) (both to
// nearest), each product taken as small.big + big.small + big.big by
// mma.sync m16n8k8 with fp32 sums. Tiles of 64 rows x DP under a column
// swizzle (a fragment read hits the 32 banks once), the same cp.async
// ring; warp w owns rows 16 (w % 4) and the column half w / 4 of the
// score tile, and reads its accumulators in place as the A operand of the
// second product (the reduction index permuted, the B rows to match); the
// halves' partial sums meet in shared memory.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int N>
struct Split {
  uint32_t big[N], small[N];
};

__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + (c ^ ((((r >> 1) & 3) << 3) | ((r & 1) << 2)));
}

template <int DP>
__device__ __forceinline__ void load_tile_swz(float* dst, const float* base,
                                              size_t stride, int s0, int S,
                                              int D, bool vec) {
  if (vec) {
    constexpr int CH = DP / 4;
#pragma unroll
    for (int it = 0; it < 64 * CH / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / CH, c = (i % CH) * 4, s = s0 + r;
      const bool ok = s < S && c < D;
      cp_async16(dst + swz<DP>(r, c),
                 ok ? base + static_cast<size_t>(s) * stride + c : base,
                 ok ? 16 : 0);
    }
  } else {
    for (int it = 0; it < 64 * DP / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / DP, c = i % DP, s = s0 + r;
      const bool ok = s < S && c < D;
      cp_async4(dst + swz<DP>(r, c),
                ok ? base + static_cast<size_t>(s) * stride + c : base,
                ok ? 4 : 0);
    }
  }
}

template <int DP>
__device__ __forceinline__ Split<4> frag_a(const float* tile, int r0, int c0,
                                           int g, int t) {
  Split<4> f;
  split_tf32(tile[swz<DP>(r0 + g, c0 + t)], f.big[0], f.small[0]);
  split_tf32(tile[swz<DP>(r0 + g + 8, c0 + t)], f.big[1], f.small[1]);
  split_tf32(tile[swz<DP>(r0 + g, c0 + t + 4)], f.big[2], f.small[2]);
  split_tf32(tile[swz<DP>(r0 + g + 8, c0 + t + 4)], f.big[3], f.small[3]);
  return f;
}
template <int DP>
__device__ __forceinline__ Split<2> frag_b_rows(const float* tile, int n0,
                                                int c0, int g, int t) {
  Split<2> f;
  split_tf32(tile[swz<DP>(n0 + g, c0 + t)], f.big[0], f.small[0]);
  split_tf32(tile[swz<DP>(n0 + g, c0 + t + 4)], f.big[1], f.small[1]);
  return f;
}
template <int DP>
__device__ __forceinline__ Split<2> frag_b_cols(const float* tile, int k0,
                                                int n0, int g, int t) {
  Split<2> f;
  split_tf32(tile[swz<DP>(k0 + 2 * t, n0 + g)], f.big[0], f.small[0]);
  split_tf32(tile[swz<DP>(k0 + 2 * t + 1, n0 + g)], f.big[1], f.small[1]);
  return f;
}
__device__ __forceinline__ Split<4> frag_a_acc(const float (&c)[4]) {
  Split<4> f;
  split_tf32(c[0], f.big[0], f.small[0]);
  split_tf32(c[2], f.big[1], f.small[1]);
  split_tf32(c[1], f.big[2], f.small[2]);
  split_tf32(c[3], f.big[3], f.small[3]);
  return f;
}

template <int DP, int NT>
__device__ __forceinline__ void meet_halves(float* R, const float (&acc)[NT][4],
                                            int wr, bool first, int g, int t) {
  for (int pass = 0; pass < 2; ++pass) {
    if (first == (pass == 0)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = R[swz<DP>(wr + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1))];
          x = pass == 0 ? acc[n][e] : x + acc[n][e];
        }
    }
    __syncthreads();
  }
}

template <int DP>
__device__ __forceinline__ void store_tile(float* base, size_t stride,
                                           const float* R, float mul, int s0,
                                           int S, int D) {
  for (int i = threadIdx.x; i < 64 * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    if (s0 + r < S && c < D)
      base[static_cast<size_t>(s0 + r) * stride + c] = R[swz<DP>(r, c)] * mul;
  }
}

"""
_FA_3XTF32 = _FA_TF32_HELPERS + r"""template <int DP, bool MASK>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, Dims dm, float scale, int causal,
               Dropout dr, Mask mk) {
  constexpr int BQ = 64, BK = 64, TILE = 64 * DP, NT = DP / 8;
  extern __shared__ __align__(16) float smem16[];
  float* Qs = smem16;
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;
  float* Vs = Ks + 2 * TILE;
  float* lse_s = Vs + 2 * TILE;
  float* dl_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  const int nq = (dm.Sq + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int q0 = qi * BQ;
  const int offset = dm.Sk - dm.Sq;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
  const float* kb = k + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const float* vb = v + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const uint32_t seed_bh =
      dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
  const bool vec = rows16(q, k, v, dout, dm.D);

  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) nk = causal_k_tiles<BQ, BK>(q0, offset, nk);
  load_tile_swz<DP>(Qs, q + qoff, qstride, q0, dm.Sq, dm.D, vec);
  load_tile_swz<DP>(dOs, dout + qoff, qstride, q0, dm.Sq, dm.D, vec);
  if (nk > 0) {
    load_tile_swz<DP>(Ks, kb, kstride, 0, dm.Sk, dm.D, vec);
    load_tile_swz<DP>(Vs, vb, kstride, 0, dm.Sk, dm.D, vec);
  }
  cp_async_commit();
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int s = q0 + r;
    const size_t idx = static_cast<size_t>(bh) * dm.Sq + s;
    const float ls = s < dm.Sq ? lse[idx] : INFINITY;
    lse_s[r] = ls == -INFINITY ? 0.f : ls;
    dl_s[r] = s < dm.Sq ? delta[idx] : 0.f;
  }

  float acc[NT][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_tile_swz<DP>(Ks + nxt * TILE, kb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      load_tile_swz<DP>(Vs + nxt * TILE, vb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (kt & 1) * TILE;
    const float* Vt = Vs + (kt & 1) * TILE;

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      const Split<4> aq = frag_a<DP>(Qs, wr, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3(s[j], aq, frag_b_rows<DP>(Kt, wc + 8 * j, kk, g, t));
      const Split<4> ao = frag_a<DP>(dOs, wr, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3(dp[j], ao, frag_b_rows<DP>(Vt, wc + 8 * j, kk, g, t));
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = wr + g + 8 * (e >> 1), r = q0 + rl;
        const int c = k0 + wc + 8 * j + 2 * t + (e & 1);
        float p;
        if constexpr (MASK) {
          p = 0.f;
          if (visible(mk, dm, b, r, c, causal, offset))
            p = mk.bias ? expf(biased(s[j][e], scale, mk, dm, b, h, r, c) - lse_s[rl])
                        : expf(s[j][e] * scale - lse_s[rl]);
        } else {
          const bool ok = c < dm.Sk && (!causal || c <= r + offset);
          p = ok ? expf(s[j][e] * scale - lse_s[rl]) : 0.f;
        }
        float dpv = dp[j][e];
        if (dr.on) dpv = keep(seed_bh, r, c, dm.Sk, dr.thresh) ? dpv * dr.keep_scale : 0.f;
        const float ds = p * (dpv - dl_s[rl]);
        if constexpr (MASK)
          if (mk.dbias && r < dm.Sq && c < dm.Sk)
            mk.dbias[(static_cast<size_t>(bh) * dm.Sq + r) * dm.Sk + c] = ds;
        s[j][e] = ds;
      }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Split<4> a = frag_a_acc(s[j]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma3(acc[n], a, frag_b_cols<DP>(Kt, wc + 8 * j, 8 * n, g, t));
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  meet_halves<DP, NT>(Ks, acc, wr, wc == 0, g, t);
  store_tile<DP>(dq + qoff, qstride, Ks, scale, q0, dm.Sq, dm.D);
}

template <int DP>
constexpr int kDkvRows = 64;

template <int DP, bool MASK>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Dims dm,
                float scale, int causal, Dropout dr, Mask mk) {
  constexpr int BQ = 64, BK = 64, TILE = 64 * DP, NT = DP / 8;
  extern __shared__ __align__(16) float smem16[];
  float* Ks = smem16;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;
  float* dOs = Qs + 2 * TILE;
  float* lse_s = dOs + 2 * TILE;
  float* dl_s = lse_s + 2 * BQ;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  const int kt = blockIdx.x;
  const int bhk = blockIdx.y;
  const int b = bhk / dm.Hk, hk = bhk % dm.Hk;
  const int rep = dm.Hq / dm.Hk;
  const int k0 = kt * BK;
  const int offset = dm.Sk - dm.Sq;
  const int nq = (dm.Sq + BQ - 1) / BQ;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t koff = (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const bool vec = rows16(q, k, v, dout, dm.D);

  int qs = 0;
  if (causal)
    while (qs < nq && k0 > qs * BQ + BQ - 1 + offset) ++qs;
  const int per = nq - qs, total = rep * per;
  auto issue = [&](int it, int st) {
    const int h = hk * rep + it / per, q0 = (qs + it % per) * BQ;
    const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
    load_tile_swz<DP>(Qs + st * TILE, q + qoff, qstride, q0, dm.Sq, dm.D, vec);
    load_tile_swz<DP>(dOs + st * TILE, dout + qoff, qstride, q0, dm.Sq, dm.D,
                      vec);
    const size_t row0 = static_cast<size_t>(b * dm.Hq + h) * dm.Sq;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool ok = q0 + r < dm.Sq;
      cp_async4(lse_s + st * BQ + r, ok ? lse + row0 + q0 + r : lse, ok ? 4 : 0);
      cp_async4(dl_s + st * BQ + r, ok ? delta + row0 + q0 + r : delta,
                ok ? 4 : 0);
    }
  };

  load_tile_swz<DP>(Ks, k + koff, kstride, k0, dm.Sk, dm.D, vec);
  load_tile_swz<DP>(Vs, v + koff, kstride, k0, dm.Sk, dm.D, vec);
  if (total > 0) issue(0, 0);
  cp_async_commit();

  float acck[NT][4] = {}, accv[NT][4] = {};
  for (int it = 0; it < total; ++it) {
    const int h = hk * rep + it / per, q0 = (qs + it % per) * BQ;
    const int bh = b * dm.Hq + h;
    const uint32_t seed_bh =
        dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
    if (it + 1 < total) {
      issue(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + (it & 1) * TILE;
    const float* dOt = dOs + (it & 1) * TILE;
    const float* ls = lse_s + (it & 1) * BQ;
    const float* dl = dl_s + (it & 1) * BQ;

    float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      const Split<4> ak = frag_a<DP>(Ks, wr, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3(st[j], ak, frag_b_rows<DP>(Qt, wc + 8 * j, kk, g, t));
      const Split<4> av = frag_a<DP>(Vs, wr, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3(dpt[j], av, frag_b_rows<DP>(dOt, wc + 8 * j, kk, g, t));
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + wr + g + 8 * (e >> 1);
        const int rl = wc + 8 * j + 2 * t + (e & 1), r = q0 + rl;
        const float raw = ls[rl];
        const float lsv = r < dm.Sq ? (raw == -INFINITY ? 0.f : raw) : INFINITY;
        float p;
        if constexpr (MASK) {
          p = 0.f;
          if (visible(mk, dm, b, r, c, causal, offset))
            p = mk.bias ? expf(biased(st[j][e], scale, mk, dm, b, h, r, c) - lsv)
                        : expf(st[j][e] * scale - lsv);
        } else {
          const bool ok = c < dm.Sk && (!causal || c <= r + offset);
          p = ok ? expf(st[j][e] * scale - lsv) : 0.f;
        }
        float pv = p, dpv = dpt[j][e];
        if (dr.on) {
          const bool kp = keep(seed_bh, r, c, dm.Sk, dr.thresh);
          pv = kp ? p * dr.keep_scale : 0.f;
          dpv = kp ? dpv * dr.keep_scale : 0.f;
        }
        st[j][e] = pv;
        dpt[j][e] = p * (dpv - dl[rl]);
      }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Split<4> ap = frag_a_acc(st[j]);
      const Split<4> ad = frag_a_acc(dpt[j]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(accv[n], ap, frag_b_cols<DP>(dOt, wc + 8 * j, 8 * n, g, t));
        mma3(acck[n], ad, frag_b_cols<DP>(Qt, wc + 8 * j, 8 * n, g, t));
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  meet_halves<DP, NT>(Qs, acck, wr, wc == 0, g, t);
  meet_halves<DP, NT>(Qs + TILE, accv, wr, wc == 0, g, t);
  store_tile<DP>(dk + koff, kstride, Qs, scale, k0, dm.Sk, dm.D);
  store_tile<DP>(dv + koff, kstride, Qs + TILE, 1.f, k0, dm.Sk, dm.D);
}

"""
_FA_3XTF32_SMEM = (
    "  return sizeof(float) * (pass == Pass::kDq\n"
    "                              ? 2 * 64 * DP + 4 * 64 * (DP + 4) + 2 * 64\n"
    "                              : 2 * 64 * DP + 4 * kDkvRows<DP> * (DP + 4) +\n"
    "                                    2 * 64 * (kDkvRows<DP> + 4) + "
    "4 * kDkvRows<DP>);",
    "  return sizeof(float) * (6 * 64 * DP + (pass == Pass::kDq ? 2 : 4) * 64);")
# the fp32 forward: the one-tile kernel (the design fwd_fp32_kernel
# replaced); P in the consumed K stage (a third barrier a tile, 17 KB less
# shared memory); two blocks an SM at DP = 64 (128 registers); the bias
# read as fwd_kernel reads it, after the products (its address from four
# strides at every key); blocks in the grid's own order rather than longest
# q tile first; the products as 3xTF32, two key halves per row, each with
# its own online softmax, merged at the end
_FA_FWD_ONE_TILE = ("    if (pass == Pass::kFwd) {\n"
                    "      if constexpr (kRing<T, DP>) {",
                    "    if (pass == Pass::kFwd) {\n"
                    "      if constexpr (kRing<T, DP> && false) {")
_FA_FWD_P_IN_K = (
    ("  float* Ps = Vs + 2 * KT;           // [BQ][PLD]\n", ""),
    ("    score_product<DP, DP, LK, 4>(Qs, Kt, s, tx, ty);\n",
     "    score_product<DP, DP, LK, 4>(Qs, Kt, s, tx, ty);\n"
     "    __syncthreads();  // K is consumed: P takes its place\n"
     "    float* Ps = Ks + (kt & 1) * KT;\n"),
    ("  return sizeof(float) * (64 * DP + 4 * 64 * (DP + 4) + 64 * (64 + 4));",
     "  return sizeof(float) * (64 * DP + 4 * 64 * (DP + 4));"))
_FA_FWD_TWO_BLOCKS = (
    "__global__ void __launch_bounds__(kThreads)\nfwd_fp32_kernel",
    "__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)\n"
    "fwd_fp32_kernel")
_FA_FWD_BIAS_PER_KEY = (
    "          const float x = mk.bias ? __fadd_rn(__fmul_rn(s[i][j], scale), "
    "bv[i][j])\n",
    "          const float x = mk.bias ? biased(s[i][j], scale, mk, dm, b, h, "
    "r, c)\n")
_FA_FWD_GRID_ORDER = (
    "  const int n = blockIdx.y * gridDim.x + blockIdx.x;\n"
    "  const int qi = nq - 1 - n / static_cast<int>(gridDim.y);\n"
    "  const int bh = n % static_cast<int>(gridDim.y);\n",
    "  const int qi = nq - 1 - static_cast<int>(blockIdx.x);\n"
    "  const int bh = blockIdx.y;\n")
_FA_FWD_SECTION = ("// forward: grid (nq, B*Hq), as fwd_kernel\n",
                   "// dq: grid (nq, B*Hq), as dq_kernel\n")
_FA_FWD_3XTF32 = r"""template <int DP, bool MASK>
__global__ void __launch_bounds__(kThreads)
fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, Dims dm, float scale, int causal,
                Dropout dr, Mask mk) {
  constexpr int BQ = 64, BK = 64, TILE = 64 * DP, NT = DP / 8;
  extern __shared__ __align__(16) float smem16[];
  float* Qs = smem16;
  float* Ks = Qs + TILE;
  float* Vs = Ks + 2 * TILE;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  const int nq = gridDim.x;
  const int n = blockIdx.y * gridDim.x + blockIdx.x;
  const int qi = nq - 1 - n / static_cast<int>(gridDim.y);
  const int bh = n % static_cast<int>(gridDim.y);
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int q0 = qi * BQ;
  const int offset = dm.Sk - dm.Sq;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
  const float* kb = k + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const float* vb = v + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const uint32_t seed_bh =
      dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
  const bool vec = rows16(q, k, v, out, dm.D);

  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) nk = causal_k_tiles<BQ, BK>(q0, offset, nk);
  load_tile_swz<DP>(Qs, q + qoff, qstride, q0, dm.Sq, dm.D, vec);
  if (nk > 0) {
    load_tile_swz<DP>(Ks, kb, kstride, 0, dm.Sk, dm.D, vec);
    load_tile_swz<DP>(Vs, vb, kstride, 0, dm.Sk, dm.D, vec);
  }
  cp_async_commit();

  // rows wr + g (accumulator entries 0, 1) and wr + g + 8 (2, 3) over this
  // warp's 32 keys of every tile
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[NT][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_tile_swz<DP>(Ks + nxt * TILE, kb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      load_tile_swz<DP>(Vs + nxt * TILE, vb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      cp_async_commit();
    }
    const float* Kt = Ks + (kt & 1) * TILE;
    const float* Vt = Vs + (kt & 1) * TILE;

    float s[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      const Split<4> aq = frag_a<DP>(Qs, wr, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3(s[j], aq, frag_b_rows<DP>(Kt, wc + 8 * j, kk, g, t));
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + wr + g + 8 * hr;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const int c = k0 + wc + 8 * j + 2 * t + (e & 1);
          if constexpr (MASK) {
            float x = -INFINITY;
            if (visible(mk, dm, b, r, c, causal, offset))
              x = mk.bias ? biased(s[j][e], scale, mk, dm, b, h, r, c)
                          : s[j][e] * scale;
            s[j][e] = x;
          } else {
            const bool ok = c < dm.Sk && (!causal || c <= r + offset);
            s[j][e] = ok ? s[j][e] * scale : -INFINITY;
          }
          mx = fmaxf(mx, s[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[hr] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const int c = k0 + wc + 8 * j + 2 * t + (e & 1);
          const float p = expf(s[j][e] - m_safe);
          rs += p;
          float pv = p;
          if (dr.on) pv = keep(seed_bh, r, c, dm.Sk, dr.thresh) ? p * dr.keep_scale : 0.f;
          s[j][e] = pv;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hr] = alpha * l[hr] + rs;
      m[hr] = m_new;
#pragma unroll
      for (int n2 = 0; n2 < NT; ++n2) {
        acc[n2][2 * hr] *= alpha;
        acc[n2][2 * hr + 1] *= alpha;
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Split<4> ap = frag_a_acc(s[j]);
#pragma unroll
      for (int n2 = 0; n2 < NT; ++n2)
        mma3(acc[n2], ap, frag_b_cols<DP>(Vt, wc + 8 * j, 8 * n2, g, t));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the key halves meet: the second leaves m, l and acc in shared memory,
  // the first merges them into its own and stores
  float* R = Ks;
  float* Rm = Ks + TILE;
  float* Rl = Rm + BQ;
  if (wc != 0) {
#pragma unroll
    for (int n2 = 0; n2 < NT; ++n2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        R[swz<DP>(wr + g + 8 * (e >> 1), 8 * n2 + 2 * t + (e & 1))] = acc[n2][e];
    if (t == 0)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        Rm[wr + g + 8 * hr] = m[hr];
        Rl[wr + g + 8 * hr] = l[hr];
      }
  }
  __syncthreads();
  if (wc != 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = wr + g + 8 * hr, r = q0 + rl;
    const float m2 = Rm[rl], mm = fmaxf(m[hr], m2);
    const float ms = mm == -INFINITY ? 0.f : mm;
    const float a1 = expf(m[hr] - ms), a2 = expf(m2 - ms);
    const float lt = l[hr] * a1 + Rl[rl] * a2;
    if (r >= dm.Sq) continue;
#pragma unroll
    for (int n2 = 0; n2 < NT; ++n2)
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        const int col = 8 * n2 + 2 * t + (e & 1);
        const float o = acc[n2][e] * a1 + R[swz<DP>(rl, col)] * a2;
        if (col < dm.D)
          out[qoff + static_cast<size_t>(r) * qstride + col] = lt > 0.f ? o / lt : 0.f;
      }
    if (t == 0)
      lse[static_cast<size_t>(bh) * dm.Sq + r] =
          lt > 0.f ? mm + logf(fmaxf(lt, 1e-38f)) : -INFINITY;
  }
}

"""
FA_TENSOR_CORES = "3xTF32 on the tensor cores"
FA_FWD_TENSOR_CORES = "forward as 3xTF32 on the tensor cores"
FA_FWD_PARENT = "one-tile forward (the parent)"
# the bf16 forward of the FMA route (fwd_mma_kernel): the one-tile
# fwd_kernel in its place (the parent of its redesign); one 16-row block a
# warp at DP <= 128 (each K and V fragment read for 16 rows, not 32); 4
# warps (64-row q tiles) at DP = 256; 32-key tiles at DP = 256, there also
# with 4 warps (two blocks an SM); 32-key tiles at DP = 128; the S
# products' d loop unrolled by two; O rescaled only when a row's max moved
# in the warp (a vote a tile)
FA_BF16_PARENT = "bf16 forward: one-tile fwd_kernel (the parent)"
BF16_FWD_VARIANTS = {
    FA_BF16_PARENT: (("constexpr bool kMma = std::is_same<T, __nv_bfloat16>"
                      "::value;", "constexpr bool kMma = false;"),),
    "bf16 forward, one row block a warp at DP <= 128": (
        ("static constexpr int MT = DP <= 128 && !MASK ? 2 : 1;",
         "static constexpr int MT = 1;"),),
    "bf16 forward, 4 warps at DP = 256": (
        ("static constexpr int WARPS = DP <= 128 ? 4 : 8;",
         "static constexpr int WARPS = 4;"),),
    "bf16 forward, 32-key tiles at DP = 256": (
        ("BQ = 16 * MT * WARPS, BK = 64;",
         "BQ = 16 * MT * WARPS, BK = DP == 256 ? 32 : 64;"),),
    "bf16 forward, 4 warps and 32-key tiles at DP = 256": (
        ("static constexpr int WARPS = DP <= 128 ? 4 : 8;",
         "static constexpr int WARPS = 4;"),
        ("BQ = 16 * MT * WARPS, BK = 64;",
         "BQ = 16 * MT * WARPS, BK = DP == 256 ? 32 : 64;")),
    "bf16 forward, 32-key tiles at DP = 128": (
        ("BQ = 16 * MT * WARPS, BK = 64;",
         "BQ = 16 * MT * WARPS, BK = DP == 128 ? 32 : 64;"),),
    "bf16 forward, S's d loop unrolled by two": (
        ("#pragma unroll\n    for (int kk = 0; kk < DP / 16; ++kk) {\n"
         "      uint32_t a[MT][4];",
         "#pragma unroll 2\n    for (int kk = 0; kk < DP / 16; ++kk) {\n"
         "      uint32_t a[MT][4];"),),
    "bf16 forward, O rescaled only when a max moved": (
        ("    // O *= alpha (1 where a row's max did not move)\n",
         "    bool moved = false;\n"
         "#pragma unroll\n"
         "    for (int r = 0; r < 2 * MT; ++r) moved |= alpha[r] != 1.f;\n"
         "    if (__any_sync(0xffffffffu, moved))\n"),),
}
# the bf16 dq and dkv of the FMA route (dq_mma_kernel, dkv_mma_kernel):
# the one-tile dq_kernel / dkv_kernel in their place (the parent of their
# redesign); the register budget's alternatives: dq with 4 warps (64-row q
# tiles) at DP = 256, there also with 64-key tiles; dq on 32-key tiles up
# to DP = 128; dq at three blocks an SM at DP = 64 (at most 168
# registers); dkv on 32-row q tiles at DP = 64, 128 and 256; dkv
# splitting D between two warps at DP = 128 as at 256; dkv at one block
# an SM at DP = 64
FA_BF16_BWD_PARENT = ("bf16 dq and dkv: one-tile dq_kernel / dkv_kernel "
                      "(the parent)")
_DQ_BK = "BQ = 16 * WARPS / NS, BK = DP <= 128 ? 64 : 32;"
_DQ_WARPS = "static constexpr int WARPS = DP == 256 ? 8 : 4;"
_DKV_BQ = "static constexpr int BQ = DP == 128 && MASK ? 16 : 64;"
BF16_BWD_VARIANTS = {
    FA_BF16_BWD_PARENT: (("constexpr bool kMmaBwd = std::is_same<T, "
                          "__nv_bfloat16>::value;",
                          "constexpr bool kMmaBwd = false;"),),
    "bf16 dq, 4 warps at DP = 256": (
        (_DQ_WARPS, "static constexpr int WARPS = 4;"),),
    "bf16 dq, 4 warps and 64-key tiles at DP = 256": (
        (_DQ_WARPS, "static constexpr int WARPS = 4;"),
        (_DQ_BK, "BQ = 16 * WARPS / NS, BK = DP <= 128 || !MASK ? 64 : 32;")),
    "bf16 dq, 32-key tiles at DP <= 128": (
        (_DQ_BK, "BQ = 16 * WARPS / NS, BK = 32;"),),
    "bf16 dq at three blocks an SM at DP = 64": (
        ("__launch_bounds__(DqTile<DP, MASK>::THREADS, 1)",
         "__launch_bounds__(DqTile<DP, MASK>::THREADS, DP == 64 ? 3 : 1)"),),
    "bf16 dkv, 32-row q tiles at DP = 64": (
        (_DKV_BQ, "static constexpr int BQ = DP == 128 && MASK ? 16 : "
                  "DP == 64 ? 32 : 64;"),),
    "bf16 dkv, 32-row q tiles at DP = 128": (
        (_DKV_BQ, "static constexpr int BQ = DP == 128 ? (MASK ? 16 : 32) "
                  ": 64;"),),
    "bf16 dkv, 32-row q tiles at DP = 256": (
        (_DKV_BQ, "static constexpr int BQ = DP == 128 && MASK ? 16 : "
                  "DP == 256 ? 32 : 64;"),),
    "bf16 dkv, D split at DP = 128": (
        ("static constexpr int NS = DP == 256 ? 2 : 1;",
         "static constexpr int NS = DP >= 128 ? 2 : 1;"),
        (_DKV_BQ, "static constexpr int BQ = 64;")),
    "bf16 dkv at one block an SM at DP = 64": (
        ("static constexpr int BLOCKS = DP == 64 && !MASK ? 3 : 1;",
         "static constexpr int BLOCKS = 1;"),),
}
FLASH_VARIANTS = {
    "committed": (),
    FA_FWD_PARENT: (_FA_FWD_ONE_TILE,),
    "forward, P in the consumed K stage": _FA_FWD_P_IN_K,
    "forward at two blocks an SM": (_FA_FWD_TWO_BLOCKS,),
    "forward, bias read after the products": (_FA_FWD_BIAS_PER_KEY,),
    "forward in the grid's own order": (_FA_FWD_GRID_ORDER,),
    FA_FWD_TENSOR_CORES: ((_FA_FWD_SECTION,
                           _FA_TF32_HELPERS + _FA_FWD_3XTF32),),
    "one-tile FFMA kernels": (_FA_ONE_TILE,),
    "dq at two blocks an SM": (_FA_DQ_TWO_BLOCKS,),
    "dkv on 32-row q tiles": (_FA_DKV_32_ROWS,),
    "dkv on 32-row q tiles, two blocks an SM": (_FA_DKV_32_ROWS,
                                                 _FA_DKV_TWO_BLOCKS),
    FA_TENSOR_CORES: ((_FA_SECTION, _FA_3XTF32),
                      (_FA_3XTF32_SMEM[0], _FA_3XTF32_SMEM[1])),
    **BF16_FWD_VARIANTS,
    **BF16_BWD_VARIANTS,
}
# the flash copies each part of the A/B runs (``--flash-parts``)
FLASH_PARTS = {
    "fp32": [n for n in FLASH_VARIANTS
             if n not in BF16_FWD_VARIANTS and n not in BF16_BWD_VARIANTS],
    "bf16_fwd": ["committed", *BF16_FWD_VARIANTS],
    "bf16_bwd": ["committed", *BF16_BWD_VARIANTS],
}
# (B, S, H, D, causal, BERT's key mask) of the three fp32 oracles' attention
FLASH_SHAPES = {"BERT oracle": (2, 512, 16, 64, False, True),
                "GPT-2 oracle": (1, 1024, 12, 64, True, False),
                "Llama oracle": (1, 1024, 16, 128, True, False)}
# (B, S, H, D, causal) of the bf16 forward's: GPT-2's and Llama-2 7B's
# training attention forced onto the FMA route, Gemma-7B's (16 heads of
# 256) and an odd head dim at GPT-2's width
BF16_SHAPES = {"GPT-2": (8, 1024, 12, 64, True),
               "Llama-2 7B": (1, 2048, 32, 128, True),
               "Gemma-7B D256": (1, 4096, 16, 256, True),
               "D45": (8, 1024, 12, 45, True)}
# (B, S, H, D, causal, dropout rate, BERT's key mask) of the bf16 dq and
# dkv's: BF16_SHAPES, and BERT-large's attention with its key mask and
# dropout 0.1 forced onto the FMA route (the Mask instantiations)
BF16_BWD_SHAPES = {**{label: (*shape, 0.0, False)
                      for label, shape in BF16_SHAPES.items()},
                   "BERT key mask, dropout 0.1": (16, 512, 16, 64, False,
                                                  0.1, True)}
SOURCES = {"rms_norm": RMS_VARIANTS, "cross_entropy": CE_VARIANTS,
           "flash_attention": FLASH_VARIANTS}


def tile_chain_units(b, s, h, causal, longest_first=True, sms=132,
                     tile=64):
    """The fp32 forward's grid as a model: one block an SM, each block
    as long as its q tile's key tiles (tile rows of queries against tile
    keys, Sq = Sk), blocks dispatched in order to the first SM free.
    Returns (the model's time in key tiles, the key tiles an SM would
    take spread evenly). ``longest_first`` orders blocks as
    fwd_fp32_kernel takes them (every head's last q tile, then every
    head's next), else as the grid runs (q tiles of one head in turn,
    longest first)."""
    nq = (s + tile - 1) // tile
    work = [(qi + 1 if causal else nq) for qi in range(nq)][::-1]
    heads = b * h
    order = ([work[n // heads] for n in range(heads * nq)] if longest_first
             else [w for _ in range(heads) for w in work])
    free = [0] * sms
    for w in order:
        i = min(range(sms), key=free.__getitem__)
        free[i] += w
    return max(free), sum(order) / sms
RMS_SHAPES = [(1, 4096, torch.float32), (8, 4096, torch.float32),
              (13, 4096, torch.float32), (32, 4096, torch.float32),
              (128, 4096, torch.float32), (256, 4096, torch.float32),
              (512, 4096, torch.float32), (8, 4096, torch.bfloat16),
              (16384, 2048, torch.bfloat16)]
CE_SHAPES = [(8192, 50304), (8192, 30522)]


def variant_sources(names=tuple(SOURCES), only=None) -> dict:
    """{(source, variant): text} for every variant of the named sources
    (``only``: {source: the variant names to keep}, default all)."""
    out = {}
    for name in names:
        table = SOURCES[name]
        base = (CSRC / f"{name}.cu").read_text()
        keep = (only or {}).get(name)
        for variant, edits in table.items():
            if keep is not None and variant not in keep:
                continue
            text = base
            for old, new in edits:
                text = _edit(text, old, new)
            out[(name, variant)] = text
    return out


# nvcc's output (ptxas -v) of each copy built, by (source, variant)
BUILD_LOGS = {}


def _build_all(out_dir: Path, names, only=None) -> dict:
    sys.path.insert(0, str(REPO))
    from paddle_tpu_torch.ops.kernels import _build
    work = REPO / "build" / "chip_ab"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, text) in enumerate(variant_sources(names, only).items()):
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
        BUILD_LOGS[key] = log
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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ab_flash(libs, gen) -> dict:
    """fp32 forward, dq and dkv of every flash variant at FLASH_SHAPES: bit
    for bit the committed build's, but for the pass a 3xTF32 copy moves to
    the tensor cores, whose share of chip_smoke.py's FLASH_RTOL (and
    LSE_RTOL) against the plain version is reported; then timed in
    turns."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    cs = _chip_smoke()
    bwd = cs.FLASH_RTOL["bwd"][torch.float32]
    rtol = {"out": cs.FLASH_RTOL["fwd"][torch.float32], "lse": cs.LSE_RTOL,
            "dq": bwd, "dk": bwd, "dv": bwd}
    # the outputs a copy may change: those of the pass on the tensor cores
    free = {FA_FWD_TENSOR_CORES: ("out", "lse"),
            FA_TENSOR_CORES: ("dq", "dk", "dv")}
    names = FLASH_PARTS["fp32"]
    load = _build.load
    res = {}
    try:
        for label, (b, s, h, d, causal, keymask) in FLASH_SHAPES.items():
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                                       generator=gen) for _ in range(4))
            bias = None
            if keymask:
                lens = torch.randint(128, s + 1, (b,), device="cuda",
                                     generator=gen)
                keys = torch.arange(s, device="cuda")[None, :]
                bias = torch.where(keys < lens[:, None], 0.0,
                                   -1e9)[:, None, None]
            scale = 1.0 / math.sqrt(d)
            out, lse = fa.flash_fwd_plain(q, k, v, causal, scale, bias=bias)
            delta = (do * out).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, do, lse, delta, causal, scale, 0.0, None, bias)
            plain = dict(zip(("out", "lse", "dq", "dk", "dv"),
                             (out, lse, fa.flash_dq_plain(*args),
                              *fa.flash_dkv_plain(*args))))

            def run(name, kind="all"):
                _build.load = lambda _, n=name: libs[("flash_attention", n)]
                got = {}
                if kind in ("all", "fwd"):
                    got["out"], got["lse"] = fa._fwd_launch(
                        q, k, v, causal, scale, 0.0, None, bias, route="fma")
                if kind in ("all", "dq"):
                    got["dq"] = fa._dq_launch(*args, route="fma")
                if kind in ("all", "dkv"):
                    got["dk"], got["dv"] = fa._dkv_launch(*args, route="fma")
                return got
            want = run("committed")
            shares = {}
            for name in names:
                got = run(name)
                torch.cuda.synchronize()
                shares[name] = {
                    o: max(0.0, float(((g - plain[o]).abs() / (rtol[o] * (
                        plain[o].abs() + plain[o].pow(2).mean().sqrt()))
                    ).max())) for o, g in got.items()}
                differ = [o for o, g in got.items()
                          if o not in free.get(name, ())
                          and not torch.equal(g, want[o])]
                if differ:
                    raise AssertionError(f"flash {name} at {label}: "
                                         f"{differ} differ from the "
                                         "committed build")
            entry = {"share_of_rtol": shares}
            for kind in ("fwd", "dq", "dkv"):
                entry[kind] = _in_turns(
                    names, lambda n, kind=kind: run(n, kind), reps=10,
                    iters=5)
                print(f"  flash_{kind} fp32 {label}: " + ", ".join(
                    f"{n} {t[0]:.4f}/{t[1]:.4f}"
                    for n, t in entry[kind].items()) + " ms", flush=True)
            print(f"  flash fp32 {label}, share of FLASH_RTOL / LSE_RTOL "
                  "(out, lse, dq, dk, dv): " + ", ".join(
                      f"{n} " + "/".join(f"{x:.3f}" for x in sh.values())
                      for n, sh in shares.items()), flush=True)
            res[label] = entry
    finally:
        _build.load = load
    return res


def ab_flash_bf16(libs, gen) -> dict:
    """The bf16 forward of the FMA route in every BF16_FWD_VARIANTS copy
    at BF16_SHAPES: ptxas's registers and spills of each copy's
    fwd_mma_kernel, out and lse held to the plain version within
    chip_smoke.py's FLASH_RTOL and LSE_RTOL (the copies round p against
    other running maxima, so not to the committed bits), then timed in
    turns beside sdpa."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    cs = _chip_smoke()
    names = FLASH_PARTS["bf16_fwd"]
    for name in names:
        rep = cs.ptxas_report(BUILD_LOGS[("flash_attention", name)])
        print(f"  ptxas {name}: " + ", ".join(
            f"{r['kernel']} {r.get('registers')} registers, spills "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} B"
            for r in rep["kernels"] if "fwd_mma_kernel" in r["kernel"]),
            flush=True)
    load = _build.load
    res = {}
    try:
        for label, (b, s, h, d, causal) in BF16_SHAPES.items():
            q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .bfloat16() for _ in range(3))
            scale = 1.0 / math.sqrt(d)
            out, lse = fa.flash_fwd_plain(q, k, v, causal, scale)

            def run(name):
                _build.load = lambda _, n=name: libs[("flash_attention", n)]
                return fa._fwd_launch(q, k, v, causal, scale, 0.0, None,
                                      route="fma")
            shares = {}
            for name in names:
                got = run(name)
                torch.cuda.synchronize()
                shares[name] = [
                    cs._tolerance_share(o, g, want, tol)[1]
                    for o, g, want, tol in (
                        ("out", got[0], out,
                         cs.FLASH_RTOL["fwd"][torch.bfloat16]),
                        ("lse", got[1], lse, cs.LSE_RTOL))]
                if max(shares[name]) > 1.0:
                    raise AssertionError(f"bf16 forward {name} at {label}: "
                                         f"share {shares[name]} of the "
                                         "tolerance")
            del out, lse
            torch.cuda.empty_cache()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            entry = {"share_of_rtol": shares, "fwd": _in_turns(
                names, run, reps=10, iters=5)}
            entry["sdpa_ms"] = [_time_graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 10, 5) for _ in range(2)]
            print(f"  flash_fwd bf16 {label}: " + ", ".join(
                f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in entry["fwd"].items())
                + f" ms; sdpa {entry['sdpa_ms'][0]:.4f}/"
                f"{entry['sdpa_ms'][1]:.4f} ms", flush=True)
            res[label] = entry
    finally:
        _build.load = load
    return res


def ab_flash_bf16_bwd(libs, gen) -> dict:
    """The bf16 dq and dkv of the FMA route in every BF16_BWD_VARIANTS copy
    at BF16_BWD_SHAPES: ptxas's registers and spills of each copy's bf16 dq
    and dkv kernels; dq, dk and dv held by chip_smoke.py's check_exact (no
    further from the fp64 backward than BWD_EXACT_RATIO times the plain
    version's own distance: the copies sum in other tile orders, so not
    to the committed bits, and the entry-wise distance to the plain
    version depends on the draw at these lengths, on both routes), their
    share of FLASH_RTOL["bwd"] reported; then timed in turns beside
    sdpa's backward (its forward plus backward less its forward)."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    cs = _chip_smoke()
    names = FLASH_PARTS["bf16_bwd"]
    tol = cs.FLASH_RTOL["bwd"][torch.bfloat16]
    for name in names:
        rep = cs.ptxas_report(BUILD_LOGS[("flash_attention", name)])
        print(f"  ptxas {name}: " + ", ".join(
            f"{r['kernel'][-60:]} {r.get('registers')} registers, spills "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} B"
            for r in rep["kernels"]
            if r["kernel"].startswith(("dq_mma_kernel<", "dkv_mma_kernel<"))
            or "dq_kernelI13__nv_bfloat16" in r["kernel"]
            or "dkv_kernelI13__nv_bfloat16" in r["kernel"]), flush=True)
    load = _build.load
    res = {}
    try:
        for label, (b, s, h, d, causal, rate, keymask) in \
                BF16_BWD_SHAPES.items():
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                                       generator=gen).bfloat16()
                           for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            seed = torch.tensor([987654321], dtype=torch.int32,
                                device="cuda")
            bias = None
            if keymask:
                lens = torch.randint(128, s + 1, (b,), device="cuda",
                                     generator=gen)
                keys = torch.arange(s, device="cuda")[None, :]
                bias = torch.where(keys < lens[:, None], 0.0,
                                   -1e9)[:, None, None]
            drop = (rate, seed, bias)
            out, lse = fa.flash_fwd_plain(q, k, v, causal, scale, *drop)
            delta = (do.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            args = (q, k, v, do, lse, delta, causal, scale, *drop)
            want = dict(zip(("dq", "dk", "dv"), (fa.flash_dq_plain(*args),
                                                 *fa.flash_dkv_plain(*args))))
            exact = dict(zip(("dq", "dk", "dv"), cs.exact_bwd(*args)))

            def run(name, kind):
                _build.load = lambda _, n=name: libs[("flash_attention", n)]
                if kind == "dq":
                    return {"dq": fa._dq_launch(*args, route="fma")}
                return dict(zip(("dk", "dv"),
                                fa._dkv_launch(*args, route="fma")))
            shares, ratios = {}, {}
            for name in names:
                got = {**run(name, "dq"), **run(name, "dkv")}
                torch.cuda.synchronize()
                shares[name] = [cs._tolerance_share(o, got[o], want[o], tol)[1]
                                for o in ("dq", "dk", "dv")]
                ratios[name] = [cs.check_exact(
                    f"bf16 {o} {name} at {label}", got[o], want[o], exact[o],
                    cs.BWD_EXACT_RATIO, quiet=True)[1]
                    for o in ("dq", "dk", "dv")]
            del out, want, exact, got
            torch.cuda.empty_cache()
            entry = {"share_of_rtol": shares, "share_of_exact_limit": ratios}
            for kind in ("dq", "dkv"):
                entry[kind] = _in_turns(
                    names, lambda n, kind=kind: run(n, kind), reps=10,
                    iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            mask = None if bias is None else bias.to(torch.bfloat16)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, dropout_p=rate,
                    is_causal=causal)
            entry["sdpa_bwd_ms"] = [
                _time_graph_ms(lambda: torch.autograd.grad(
                    sdpa(), (qt, kt, vt), dot), 10, 5)
                - _time_graph_ms(sdpa, 10, 5) for _ in range(2)]
            for kind in ("dq", "dkv"):
                print(f"  flash_{kind} bf16 {label}: " + ", ".join(
                    f"{n} {t[0]:.4f}/{t[1]:.4f}"
                    for n, t in entry[kind].items()) + " ms", flush=True)
            print(f"  sdpa backward bf16 {label}: "
                  f"{entry['sdpa_bwd_ms'][0]:.4f}/"
                  f"{entry['sdpa_bwd_ms'][1]:.4f} ms; share of FLASH_RTOL "
                  "/ of check_exact's limit (dq, dk, dv): " + ", ".join(
                      f"{n} " + "/".join(f"{x:.3f}" for x in sh) + " / "
                      + "/".join(f"{x:.3f}" for x in ratios[n])
                      for n, sh in shares.items()), flush=True)
            res[label] = entry
            del qt, kt, vt, dot
            torch.cuda.empty_cache()
    finally:
        _build.load = load
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "chip_ab"))
    ap.add_argument("--kernels", default=",".join(SOURCES),
                    help="comma-separated subset of " + ",".join(SOURCES))
    ap.add_argument("--flash-parts", default=",".join(FLASH_PARTS),
                    help="the flash A/Bs to build and run: comma-separated "
                         "subset of " + ",".join(FLASH_PARTS))
    args = ap.parse_args(argv)
    names = tuple(args.kernels.split(","))
    if not set(names) <= set(SOURCES):
        ap.error(f"--kernels: unknown {sorted(set(names) - set(SOURCES))}")
    parts = tuple(args.flash_parts.split(","))
    if not set(parts) <= set(FLASH_PARTS):
        ap.error(f"--flash-parts: unknown "
                 f"{sorted(set(parts) - set(FLASH_PARTS))}")
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
    only = {"flash_attention": {n for p in parts for n in FLASH_PARTS[p]}}
    libs = _build_all(out_dir, names, only)
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {"rms_norm": ab_rms_norm, "cross_entropy": ab_cross_entropy}
    flash = {"fp32": ("flash_attention", ab_flash),
             "bf16_fwd": ("flash_attention_bf16", ab_flash_bf16),
             "bf16_bwd": ("flash_attention_bf16_bwd", ab_flash_bf16_bwd)}
    report = {"card": card}
    for name in names:
        if name in runs:
            report[name] = runs[name](libs, gen)
    if "flash_attention" in names:
        for part in parts:
            key, fn = flash[part]
            report[key] = fn(libs, gen)
    (out_dir / "chip_ab.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
