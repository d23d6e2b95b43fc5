// Flash attention forward, dq and dkv for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_fwd`), `_dq_kernel` and `_dkv_kernel` (launched by
// `_bwd_impl`), behind `flash_attention_ext`'s custom VJP. Contract, as
// there:
//   q, dO, out, dq: [B, Sq, Hq, D];  k, v, dk, dv: [B, Sk, Hk, D]
//   (the public layout, read in place: no transposes around the call);
//   lse, delta: [B*Hq, Sq] fp32. q head h of batch b reads kv head
//   h / (Hq/Hk) (GQA, `_kv_index`). Causal keeps key j for query i iff
//   j <= i + (Sk - Sq). s = scale * (q . k) in fp32; p is rounded to v's
//   dtype before P.V (and to dO's before P^T.dO), ds to k's / q's before
//   its products; every sum is fp32. Rows that see no key give out = 0
//   and lse = -inf. Dropout keeps an element by the murmur3 hash of
//   `_keep_block` / `_mix_seed` (bit for bit); lse comes from the
//   undropped p. fp32 and bf16; head_dim D <= 256.
//   An additive fp32 bias (any broadcast of [B, Hq, Sq, Sk], by strides)
//   is added to scale * (q . k) before the masks, and segment words hide
//   keys of other segments (flash_common.cuh, Mask); the dq pass can write
//   ds as dbias. Segments make the global diagonal the caller's choice:
//   under per-segment causal it passes causal = 0. Each kernel takes them
//   only in its MASK instantiation, so the one without them keeps its
//   code and time.
//
// Grid split, as on the TPU:
//   fwd: one block per (q tile, b*Hq + h): online softmax over k tiles;
//   dq:  one block per (q tile, b*Hq + h): loops over k tiles;
//   dkv: one block per (k tile, b*Hk + hk): loops over the group's rep q
//        heads and their q tiles, so dk/dv need no atomics and K/V are
//        never expanded.
// Tiles that the causal diagonal hides entirely are skipped.
//
// What bounds it: at GPT-2's training shape (B*H = 96, S = 1024, D = 64,
// bf16, causal) the forward does 4 D flops per visible (query, key) pair,
// 12.9 GFLOP, on 50 MB of operands: 13 us at the bf16 tensor-core peak,
// 15 us to move the bytes. dq and dkv do 1.5x and 2x the forward's flops
// on about the same bytes, so they are bound by operations.
//
// Design of the one-tile kernels (simple and right, not yet fast; fp32
// above D = 128): 256 threads as a 16 x 16 grid;
// each thread owns a (BQ/16) x (BK/16) patch of the score tile and a
// (rows/16) x (D/16) patch of the output or gradient tile. Tiles of Q, K,
// V, dO and of P / dS live in shared memory as fp32 (bf16 converted on
// load, exact), padded by one word per row so the strided reads do not
// collide on banks; the products are FMA loops over shared memory
// (CUDA cores, not tensor cores). D is zero-padded to DP = 64, 128 or 256.
// Row max and row sums are shuffles across the 16 threads of a row.
// bf16 calls with head dims that are multiples of 8 up to 128 and 16-byte
// aligned operands take the tensor-core forward, dq and dkv of
// flash_attention_sm90.cu instead (`flash_route`); this file serves fp32,
// wider heads and strides TMA cannot take. Here:
// - the bf16 forward, dq and dkv at every head dim (1 .. 256) and
//   alignment are fwd_mma_kernel, dq_mma_kernel and dkv_mma_kernel:
//   mma.sync m16n8k16 on the tensor cores behind a cp.async ring (their
//   sections below; dkv splits D between two warps at DP = 256);
// - fp32 up to D = 128 takes fwd_fp32_kernel, dq_fp32_kernel and
//   dkv_fp32_kernel: the one-tile kernels' sums in the same order (so the
//   same bits), with operands blocked in registers and fed by a cp.async
//   ring; fp32 above D = 128 the one-tile fwd_kernel, dq_kernel and
//   dkv_kernel. Tensor-core products (3xTF32) cannot hold the fp32
//   contract's tolerance, so fp32 stays on FFMA.
// Both sources share the dropout hash of flash_common.cuh.
#include "common.cuh"
#include "flash_common.cuh"

#include <math.h>

#include <type_traits>

namespace {

using namespace ptk;

constexpr int kThreads = 256;

// fp32 value rounded to T (the operand cast before a product), in fp32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ptk::to_float(ptk::from_float<T>(v));
}

// max / sum over the 16 threads of a row (lanes l ^ 1..8 share tid >> 4)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy rows [s0, s0 + ROWS) of one head of a [batch, S, H, D] tensor
// (base = &t[b, 0, h, 0], row stride = H * D) into shared memory as fp32,
// zero past S and past D. Natural layout dst[r * LD + d], or transposed
// dst[d * LD + r].
template <typename T, int ROWS, int DP, bool TRANSPOSED, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          size_t stride, int s0, int S,
                                          int D) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    const int s = s0 + r;
    float val = 0.f;
    if (s < S && d < D) val = ptk::to_float(base[static_cast<size_t>(s) * stride + d]);
    if constexpr (TRANSPOSED)
      dst[d * LD + r] = val;
    else
      dst[r * LD + d] = val;
  }
}

// Index of the first k tile past the causal horizon of q rows
// [q0, q0 + BQ): tiles with k0 <= q0 + BQ - 1 + offset run.
template <int BQ, int BK>
__device__ __forceinline__ int causal_k_tiles(int q0, int offset, int nk) {
  const int last = q0 + BQ - 1 + offset;
  if (last < 0) return 0;
  return min(nk, last / BK + 1);
}

// Whether row r sees key c: the key edge, the causal diagonal and the
// segment words (a row past Sq sees nothing once segments are on).
__device__ __forceinline__ bool visible(const Mask& mk, const Dims& dm, int b,
                                        int r, int c, int causal,
                                        int offset) {
  if (c >= dm.Sk || (causal && c > r + offset)) return false;
  if (mk.qseg == nullptr) return true;
  return r < dm.Sq &&
         seg_sees(mk.qseg[static_cast<size_t>(b) * dm.Sq + r],
                  mk.kseg[static_cast<size_t>(b) * dm.Sk + c], mk.seg_causal);
}

// scale * s plus the bias of (r, c) for a visible c (< Sk), in the plain
// version's order: the product, then the sum
__device__ __forceinline__ float biased(float s, float scale, const Mask& mk,
                                        const Dims& dm, int b, int h, int r,
                                        int c) {
  const float bv = r < dm.Sq ? bias_at(mk, b, h, r, c) : 0.f;
  return __fadd_rn(__fmul_rn(s, scale), bv);
}

// ---------------------------------------------------------------------------
// forward: grid (nq, B*Hq)
// ---------------------------------------------------------------------------

template <typename T, int DP, int BQ, int BK, bool MASK>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, Dims dm, float scale, int causal,
           Dropout dr, Mask mk) {
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = DP / 16;
  constexpr int QLD = DP + 1, KLD = BK + 1, VLD = DP, PLD = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][QLD]
  float* Kt = Qs + BQ * QLD;      // [DP][KLD]  (transposed)
  float* Vs = Kt + DP * KLD;      // [BK][VLD]
  float* Ps = Vs + BK * VLD;      // [BQ][PLD]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (dm.Sq + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);  // long rows first
  const int bh = blockIdx.y;
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int q0 = qi * BQ;
  const int offset = dm.Sk - dm.Sq;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const T* qb = q + (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
  const T* kb = k + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const T* vb = v + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const uint32_t seed_bh =
      dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;

  load_tile<T, BQ, DP, false, QLD>(Qs, qb, qstride, q0, dm.Sq, dm.D);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) nk = causal_k_tiles<BQ, BK>(q0, offset, nk);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Kt / Vs / Ps are consumed
    load_tile<T, BK, DP, true, KLD>(Kt, kb, kstride, k0, dm.Sk, dm.D);
    load_tile<T, BK, DP, false, VLD>(Vs, vb, kstride, k0, dm.Sk, dm.D);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Kt[d * KLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int rl = ty * RQ + i, r = q0 + rl;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = k0 + tx + 16 * j;
        if constexpr (MASK) {
          const bool ok = visible(mk, dm, b, r, c, causal, offset);
          const float x = mk.bias ? biased(s[i][j], scale, mk, dm, b, h, r, c)
                                  : s[i][j] * scale;
          s[i][j] = ok ? x : -INFINITY;
        } else {
          const bool ok = c < dm.Sk && (!causal || c <= r + offset);
          s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        float pv = p;
        if (dr.on) pv = keep(seed_bh, r, c, dm.Sk, dr.thresh) ? p * dr.keep_scale : 0.f;
        Ps[rl * PLD + tx + 16 * j] = round_to<T>(pv);
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty * RQ + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = Vs[c * VLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= dm.Sq) continue;
    const float li = l[i];
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int d = tx + 16 * j;
      if (d < dm.D)
        ob[static_cast<size_t>(r) * qstride + d] =
            ptk::from_float<T>(li > 0.f ? acc[i][j] / li : 0.f);
    }
    if (tx == 0)
      lse[static_cast<size_t>(bh) * dm.Sq + r] =
          li > 0.f ? m[i] + logf(fmaxf(li, 1e-38f)) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// dq: grid (nq, B*Hq)
// ---------------------------------------------------------------------------

template <typename T, int DP, int BQ, int BK, bool MASK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Dims dm, float scale, int causal, Dropout dr,
          Mask mk) {
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = DP / 16;
  constexpr int QLD = DP + 1, KLD = BK + 1, SLD = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][QLD]
  float* dOs = Qs + BQ * QLD;      // [BQ][QLD]
  float* Kt = dOs + BQ * QLD;      // [DP][KLD]
  float* Vt = Kt + DP * KLD;       // [DP][KLD]
  float* dSs = Vt + DP * KLD;      // [BQ][SLD]
  float* lse_s = dSs + BQ * SLD;   // [BQ]
  float* dl_s = lse_s + BQ;        // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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
  const T* kb = k + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const T* vb = v + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const uint32_t seed_bh =
      dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;

  load_tile<T, BQ, DP, false, QLD>(Qs, q + qoff, qstride, q0, dm.Sq, dm.D);
  load_tile<T, BQ, DP, false, QLD>(dOs, dout + qoff, qstride, q0, dm.Sq, dm.D);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int s = q0 + r;
    const size_t idx = static_cast<size_t>(bh) * dm.Sq + s;
    // a row that sees no key (lse = -inf) reads 0; a padded row +inf
    // (p = 0, as the reference pads lse)
    const float ls = s < dm.Sq ? lse[idx] : INFINITY;
    lse_s[r] = ls == -INFINITY ? 0.f : ls;
    dl_s[r] = s < dm.Sq ? delta[idx] : 0.f;
  }

  float dqa[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dqa[i][j] = 0.f;

  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) nk = causal_k_tiles<BQ, BK>(q0, offset, nk);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, BK, DP, true, KLD>(Kt, kb, kstride, k0, dm.Sk, dm.D);
    load_tile<T, BK, DP, true, KLD>(Vt, vb, kstride, k0, dm.Sk, dm.D);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = Qs[(ty * RQ + i) * QLD + d];
        ov[i] = dOs[(ty * RQ + i) * QLD + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = Kt[d * KLD + tx + 16 * j];
        vv[j] = Vt[d * KLD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int rl = ty * RQ + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = k0 + tx + 16 * j;
        float p;
        if constexpr (MASK) {
          p = 0.f;
          if (visible(mk, dm, b, r, c, causal, offset))
            p = mk.bias ? expf(biased(s[i][j], scale, mk, dm, b, h, r, c) - lse_s[rl])
                        : expf(s[i][j] * scale - lse_s[rl]);
        } else {
          const bool ok = c < dm.Sk && (!causal || c <= r + offset);
          p = ok ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        }
        float dpv = dp[i][j];
        if (dr.on) dpv = keep(seed_bh, r, c, dm.Sk, dr.thresh) ? dpv * dr.keep_scale : 0.f;
        const float ds = p * (dpv - dl_s[rl]);
        if constexpr (MASK)
          if (mk.dbias && r < dm.Sq && c < dm.Sk)
            mk.dbias[(static_cast<size_t>(bh) * dm.Sq + r) * dm.Sk + c] = ds;
        dSs[rl * SLD + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = dSs[(ty * RQ + i) * SLD + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kv[j] = Kt[(tx + 16 * j) * KLD + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) dqa[i][j] = fmaf(ds[i], kv[j], dqa[i][j]);
    }
  }

  T* db = dq + qoff;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= dm.Sq) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int d = tx + 16 * j;
      if (d < dm.D)
        db[static_cast<size_t>(r) * qstride + d] =
            ptk::from_float<T>(dqa[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dkv: grid (nk, B*Hk)
// ---------------------------------------------------------------------------

template <typename T, int DP, int BQ, int BK, bool MASK>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, Dims dm, float scale,
           int causal, Dropout dr, Mask mk) {
  constexpr int RK = BK / 16, CQ = BQ / 16, CD = DP / 16;
  constexpr int KLD = DP + 1, QLD = BQ + 1, PLD = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                // [BK][KLD]
  float* Vs = Ks + BK * KLD;       // [BK][KLD]
  float* Qt = Vs + BK * KLD;       // [DP][QLD]  (transposed)
  float* dOt = Qt + DP * QLD;      // [DP][QLD]  (transposed)
  float* Pt = dOt + DP * QLD;      // [BK][PLD]  (p_v^T)
  float* dSt = Pt + BK * PLD;      // [BK][PLD]  (ds^T)
  float* lse_s = dSt + BK * PLD;   // [BQ]
  float* dl_s = lse_s + BQ;        // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x;       // low k tiles see the most q tiles
  const int bhk = blockIdx.y;
  const int b = bhk / dm.Hk, hk = bhk % dm.Hk;
  const int rep = dm.Hq / dm.Hk;
  const int k0 = kt * BK;
  const int offset = dm.Sk - dm.Sq;
  const int nq = (dm.Sq + BQ - 1) / BQ;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t koff = (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;

  load_tile<T, BK, DP, false, KLD>(Ks, k + koff, kstride, k0, dm.Sk, dm.D);
  load_tile<T, BK, DP, false, KLD>(Vs, v + koff, kstride, k0, dm.Sk, dm.D);

  float dka[RK][CD], dva[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const int bh = b * dm.Hq + h;
    const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
    const uint32_t seed_bh =
        dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      if (causal && k0 > q0 + BQ - 1 + offset) continue;  // block-uniform
      __syncthreads();  // the previous q tile's Qt / dOt / Pt / dSt are consumed
      load_tile<T, BQ, DP, true, QLD>(Qt, q + qoff, qstride, q0, dm.Sq, dm.D);
      load_tile<T, BQ, DP, true, QLD>(dOt, dout + qoff, qstride, q0, dm.Sq, dm.D);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int s = q0 + r;
        const size_t idx = static_cast<size_t>(bh) * dm.Sq + s;
        const float ls = s < dm.Sq ? lse[idx] : INFINITY;
        lse_s[r] = ls == -INFINITY ? 0.f : ls;
        dl_s[r] = s < dm.Sq ? delta[idx] : 0.f;
      }
      __syncthreads();

      // transposed score tile: st[i][j] = s(q row j, k row i)
      float st[RK][CQ], dpt[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        float kv[RK], vv[RK], qv[CQ], ov[CQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = Ks[(ty * RK + i) * KLD + d];
          vv[i] = Vs[(ty * RK + i) * KLD + d];
        }
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          qv[j] = Qt[d * QLD + tx + 16 * j];
          ov[j] = dOt[d * QLD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int cl = ty * RK + i, c = k0 + cl;
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int rl = tx + 16 * j, r = q0 + rl;
          float p;
          if constexpr (MASK) {
            p = 0.f;
            if (visible(mk, dm, b, r, c, causal, offset))
              p = mk.bias ? expf(biased(st[i][j], scale, mk, dm, b, h, r, c) - lse_s[rl])
                          : expf(st[i][j] * scale - lse_s[rl]);
          } else {
            const bool ok = c < dm.Sk && (!causal || c <= r + offset);
            p = ok ? expf(st[i][j] * scale - lse_s[rl]) : 0.f;
          }
          float pv = p, dpv = dpt[i][j];
          if (dr.on) {
            const bool kp = keep(seed_bh, r, c, dm.Sk, dr.thresh);
            pv = kp ? p * dr.keep_scale : 0.f;
            dpv = kp ? dpv * dr.keep_scale : 0.f;
          }
          Pt[cl * PLD + rl] = round_to<T>(pv);
          dSt[cl * PLD + rl] = round_to<T>(p * (dpv - dl_s[rl]));
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], ds[RK], ov[CD], qv[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Pt[(ty * RK + i) * PLD + r];
          ds[i] = dSt[(ty * RK + i) * PLD + r];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          ov[j] = dOt[(tx + 16 * j) * QLD + r];
          qv[j] = Qt[(tx + 16 * j) * QLD + r];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CD; ++j) {
            dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
            dka[i][j] = fmaf(ds[i], qv[j], dka[i][j]);
          }
      }
    }
  }

  T* dkb = dk + koff;
  T* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = k0 + ty * RK + i;
    if (c >= dm.Sk) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int d = tx + 16 * j;
      if (d < dm.D) {
        dkb[static_cast<size_t>(c) * kstride + d] = ptk::from_float<T>(dka[i][j] * scale);
        dvb[static_cast<size_t>(c) * kstride + d] = ptk::from_float<T>(dva[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 dq and dkv, head dims up to 128: FFMA blocked in registers, fed by a
// cp.async ring
// ---------------------------------------------------------------------------
//
// Every output entry is the same chain of fmaf as in dq_kernel / dkv_kernel
// (and as cuBLAS's fp32 GEMM in the plain version): s and dP over d = 0 ..
// DP - 1, dQ over the keys, dK and dV over the group's q rows, each in
// ascending order from 0. So the results are those kernels' bits; only
// who computes what, and how operands reach the registers, change.
// Products on the tensor cores, even split into 3xTF32, round otherwise:
// on an H100 they read several times FLASH_RTOL["bwd"][fp32] against the
// plain version, where these chains read at most half of it
// (`chip_ab.py`).
//
// - 256 threads as a 16 x 16 grid (tx, ty). Score products: rows
//   4 ty .. + 3 (the same for the 16 threads of a half-warp: broadcast
//   reads) by columns tx + 16 j (as the FFMA kernels), four d at a time:
//   one LDS.128 per row and per column, 8 FFMA per shared load. Second
//   products (dQ = dS K; dV = P^T dO, dK = dS^T Q): rows 4 ty .. + 3 by
//   columns 4 tx .. + 3 (and + 64 at DP = 128), four keys or q rows at a
//   time: 8 FFMA per shared load (10.7 at DP = 128). dq_kernel and
//   dkv_kernel issue one shared load per 2 FFMA.
// - Tiles are fp32 [rows][D zero-padded to DP = 64 or 128]. Those read
//   along 16 rows at once (K and V in dq; Q and dO in dkv) are padded to
//   DP + 4 floats a row, so the 16 reads fall on distinct banks; the
//   others are read by broadcast and stay unpadded. cp.async copies 16
//   bytes at a time where every row starts on a 16-byte boundary, else 4,
//   into a ring of two stages: the next K/V tile (dq) or Q/dO tile (dkv)
//   loads while the current one's products run. Loops step through the
//   tiles with fixed offsets, so shared loads take immediate addresses.
// - dq: 64-row tiles; dS takes the place of the consumed V stage. dkv: 64
//   keys against q tiles of kDkvRows<DP> rows (64, and 32 at DP = 128,
//   where two stages of 64 would not fit 227 KB). One block an SM: at two,
//   128 registers a thread spill (`chip_ab.py` times both).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (16 or 0: zero-fill) from global src to shared dst
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// copy `bytes` (4 or 0: zero-fill)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [s0, s0 + ROWS) of one head of a [batch, S, H, D] fp32 tensor (base =
// &t[b, 0, h, 0], row stride `stride`) into a [ROWS][LD] tile by cp.async,
// zero past S and past D (up to DP); 16-byte copies when `vec`.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile_async(float* dst, const float* base,
                                                size_t stride, int s0, int S,
                                                int D, bool vec) {
  if (vec) {
    constexpr int CH = DP / 4;
#pragma unroll
    for (int it = 0; it < ROWS * CH / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / CH, c = (i % CH) * 4, s = s0 + r;
      const bool ok = s < S && c < D;
      cp_async16(dst + r * LD + c,
                 ok ? base + static_cast<size_t>(s) * stride + c : base,
                 ok ? 16 : 0);
    }
  } else {
    for (int it = 0; it < ROWS * DP / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / DP, c = i % DP, s = s0 + r;
      const bool ok = s < S && c < D;
      cp_async4(dst + r * LD + c,
                ok ? base + static_cast<size_t>(s) * stride + c : base,
                ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Every row of the operands starts on a 16-byte boundary.
__device__ __forceinline__ bool rows16(const void* a, const void* b,
                                       const void* c, const void* d, int D) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(d);
  return D % 4 == 0 && (bits & 15) == 0;
}

// The score products of a pass, two at once: acc0[i][j] += A0(row 4 ty + i,
// d) * B0(row tx + 16 j, d) over d = 0 .. DP - 1 ascending (acc1 from A1,
// B1 likewise); A tiles [.][LDA], B tiles [.][LDB].
template <int DP, int LDA, int LDB, int NJ>
__device__ __forceinline__ void score_products(
    const float* A0, const float* B0, const float* A1, const float* B1,
    float (&acc0)[4][NJ], float (&acc1)[4][NJ], int tx, int ty) {
  const float* a0 = A0 + 4 * ty * LDA;
  const float* a1 = A1 + 4 * ty * LDA;
  const float* b0 = B0 + tx * LDB;
  const float* b1 = B1 + tx * LDB;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 x0[4], x1[4], y0[NJ], y1[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0[i] = ld4(a0 + i * LDA + d);
      x1[i] = ld4(a1 + i * LDA + d);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      y0[j] = ld4(b0 + 16 * j * LDB + d);
      y1[j] = ld4(b1 + 16 * j * LDB + d);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc0[i][j] = fmaf(at(x0[i], e), at(y0[j], e), acc0[i][j]);
          acc1[i][j] = fmaf(at(x1[i], e), at(y1[j], e), acc1[i][j]);
        }
  }
}

// A second product: acc[i][4 h + e] += W(row 4 ty + i, c) * X(row c,
// 64 h + 4 tx + e) over c = 0 .. NC - 1 ascending; W [.][LDW], X [NC][LDX].
template <int DP, int NC, int LDW, int LDX>
__device__ __forceinline__ void second_product(const float* W, const float* X,
                                               float (&acc)[4][DP / 16],
                                               int tx, int ty) {
  constexpr int H = DP / 64;
  const float* w = W + 4 * ty * LDW;
  const float* x = X + 4 * tx;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = ld4(w + i * LDW + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float4 xv[H];
#pragma unroll
      for (int h = 0; h < H; ++h) xv[h] = ld4(x + (c + cc) * LDX + 64 * h);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * h + e] = fmaf(at(wv[i], cc), at(xv[h], e), acc[i][4 * h + e]);
    }
  }
}

// acc (rows 4 ty + i, columns 64 h + 4 tx + e) times `mul` into rows
// [s0, s0 + 64) of one head, rows below S and columns below D
template <int DP>
__device__ __forceinline__ void store_rows(float* base, size_t stride,
                                           const float (&acc)[4][DP / 16],
                                           float mul, int s0, int S, int D,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = s0 + 4 * ty + i;
    if (r >= S) continue;
#pragma unroll
    for (int h = 0; h < DP / 64; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * h + 4 * tx + e;
        if (d < D) base[static_cast<size_t>(r) * stride + d] = acc[i][4 * h + e] * mul;
      }
  }
}

// ---------------------------------------------------------------------------
// fp32 forward, head dims up to 128: FFMA blocked in registers, fed by a
// cp.async ring
// ---------------------------------------------------------------------------
//
// fwd_kernel's sums in fwd_kernel's order, so its bits: s over d = 0 ..
// DP - 1 ascending (rows 4 ty + i by columns tx + 16 j, as fwd_kernel maps
// them), the row max and sum over the same 16 lanes, acc *= alpha, then
// P.V over the tile's keys ascending (second_product), out = acc / l.
// - Q [64][DP] unpadded, read by broadcast; K and V in a two-stage ring of
//   [64][DP + 4] rows, the next tile copied while this one's products run;
//   P [64][64 + 4] in a buffer of its own. A tile takes two barriers: one
//   after its stage lands (every thread is then past the previous tile, so
//   the other stage and P are free), one after P is written.
// - One block of 8 warps an SM: at two (DP = 64, 101 KB of shared memory
//   each) the loops spill at 128 registers and the causal shapes ran
//   slower (`chip_ab.py`).
// - Blocks take q tiles longest first across the whole grid (every head's
//   last tile, then every head's next), so under causal the longest
//   chains of key tiles start first.

// One score product: acc[i][j] += A(row 4 ty + i, d) * B(row tx + 16 j, d)
// over d = 0 .. DP - 1 ascending (score_products' mapping and order)
template <int DP, int LDA, int LDB, int NJ>
__device__ __forceinline__ void score_product(const float* A, const float* B,
                                              float (&acc)[4][NJ], int tx,
                                              int ty) {
  const float* a = A + 4 * ty * LDA;
  const float* bb = B + tx * LDB;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 x[4], y[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(a + i * LDA + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = ld4(bb + 16 * j * LDB + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = fmaf(at(x[i], e), at(y[j], e), acc[i][j]);
  }
}

// forward: grid (nq, B*Hq), as fwd_kernel
template <int DP, bool MASK>
__global__ void __launch_bounds__(kThreads)
fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, Dims dm, float scale, int causal,
                Dropout dr, Mask mk) {
  constexpr int BQ = 64, BK = 64, LK = DP + 4, PLD = BK + 4;
  constexpr int KT = BK * LK;        // one K or V stage
  extern __shared__ __align__(16) float smem16[];
  float* Qs = smem16;                // [BQ][DP]
  float* Ks = Qs + BQ * DP;          // [2][BK][LK]: the ring
  float* Vs = Ks + 2 * KT;           // [2][BK][LK]
  float* Ps = Vs + 2 * KT;           // [BQ][PLD]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // block n of the grid (x fastest) takes q tile nq - 1 - n / (B*Hq) of
  // head n % (B*Hq)
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
  load_tile_async<BQ, DP, DP>(Qs, q + qoff, qstride, q0, dm.Sq, dm.D, vec);
  if (nk > 0) {
    load_tile_async<BK, DP, LK>(Ks, kb, kstride, 0, dm.Sk, dm.D, vec);
    load_tile_async<BK, DP, LK>(Vs, vb, kstride, 0, dm.Sk, dm.D, vec);
  }
  cp_async_commit();

  // the bias row of each of this thread's q rows (bias_at less the key
  // term); a row past Sq reads row Sq - 1, and is never stored
  float m[4], l[4], acc[4][DP / 16] = {};
  const float* brow[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    if (MASK && mk.bias)
      brow[i] = mk.bias + b * mk.sb + h * mk.sh +
                static_cast<long long>(min(q0 + 4 * ty + i, dm.Sq - 1)) * mk.sq;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other stage and P are consumed
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_tile_async<BK, DP, LK>(Ks + nxt * KT, kb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      load_tile_async<BK, DP, LK>(Vs + nxt * KT, vb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      cp_async_commit();
    }
    const float* Kt = Ks + (kt & 1) * KT;
    const float* Vt = Vs + (kt & 1) * KT;

    // this tile's bias, loaded ahead of the products (a key past Sk reads
    // key Sk - 1, and is hidden)
    float bv[4][4] = {};
    if (MASK && mk.bias)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[i][j] = brow[i][min(k0 + tx + 16 * j, dm.Sk - 1) * mk.sk];

    float s[4][4] = {};
    score_product<DP, DP, LK, 4>(Qs, Kt, s, tx, ty);

    // the online softmax, as fwd_kernel (the bias added in biased()'s
    // order)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = 4 * ty + i, r = q0 + rl;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        if constexpr (MASK) {
          const bool ok = visible(mk, dm, b, r, c, causal, offset);
          const float x = mk.bias ? __fadd_rn(__fmul_rn(s[i][j], scale), bv[i][j])
                                  : s[i][j] * scale;
          s[i][j] = ok ? x : -INFINITY;
        } else {
          const bool ok = c < dm.Sk && (!causal || c <= r + offset);
          s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        float pv = p;
        if (dr.on) pv = keep(seed_bh, r, c, dm.Sk, dr.thresh) ? p * dr.keep_scale : 0.f;
        Ps[rl * PLD + tx + 16 * j] = pv;
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P is whole

    second_product<DP, BK, PLD, LK>(Ps, Vt, acc, tx, ty);
  }
  cp_async_wait<0>();

  // as fwd_kernel: a division, out = 0 and lse = -inf where no key is seen
  float* ob = out + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= dm.Sq) continue;
    const float li = l[i];
#pragma unroll
    for (int hh = 0; hh < DP / 64; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * hh + 4 * tx + e;
        if (d < dm.D)
          ob[static_cast<size_t>(r) * qstride + d] =
              li > 0.f ? acc[i][4 * hh + e] / li : 0.f;
      }
    if (tx == 0)
      lse[static_cast<size_t>(bh) * dm.Sq + r] =
          li > 0.f ? m[i] + logf(fmaxf(li, 1e-38f)) : -INFINITY;
  }
}

// dq: grid (nq, B*Hq), as dq_kernel
template <int DP, bool MASK>
__global__ void __launch_bounds__(kThreads)
dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, Dims dm, float scale, int causal,
               Dropout dr, Mask mk) {
  constexpr int BQ = 64, BK = 64, LK = DP + 4, SLD = BK + 4;
  constexpr int KT = BK * LK;        // one K or V stage
  extern __shared__ __align__(16) float smem16[];
  float* Qs = smem16;                // [BQ][DP]
  float* dOs = Qs + BQ * DP;         // [BQ][DP]
  float* Ks = dOs + BQ * DP;         // [2][BK][LK]: the ring
  float* Vs = Ks + 2 * KT;           // [2][BK][LK]; dS [BQ][SLD] once consumed
  float* lse_s = Vs + 2 * KT;        // [BQ]
  float* dl_s = lse_s + BQ;          // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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
  load_tile_async<BQ, DP, DP>(Qs, q + qoff, qstride, q0, dm.Sq, dm.D, vec);
  load_tile_async<BQ, DP, DP>(dOs, dout + qoff, qstride, q0, dm.Sq, dm.D, vec);
  if (nk > 0) {
    load_tile_async<BK, DP, LK>(Ks, kb, kstride, 0, dm.Sk, dm.D, vec);
    load_tile_async<BK, DP, LK>(Vs, vb, kstride, 0, dm.Sk, dm.D, vec);
  }
  cp_async_commit();
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int s = q0 + r;
    const size_t idx = static_cast<size_t>(bh) * dm.Sq + s;
    // as dq_kernel: a row that sees no key reads 0, a padded row +inf
    const float ls = s < dm.Sq ? lse[idx] : INFINITY;
    lse_s[r] = ls == -INFINITY ? 0.f : ls;
    dl_s[r] = s < dm.Sq ? delta[idx] : 0.f;
  }

  float dqa[4][DP / 16] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_tile_async<BK, DP, LK>(Ks + nxt * KT, kb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      load_tile_async<BK, DP, LK>(Vs + nxt * KT, vb, kstride, k0 + BK, dm.Sk, dm.D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed
    const float* Kt = Ks + (kt & 1) * KT;
    float* Vt = Vs + (kt & 1) * KT;

    float s[4][4] = {}, dp[4][4] = {};
    score_products<DP, DP, LK, 4>(Qs, Kt, dOs, Vt, s, dp, tx, ty);

    // ds in place of s, element by element as dq_kernel
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = 4 * ty + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float p;
        if constexpr (MASK) {
          p = 0.f;
          if (visible(mk, dm, b, r, c, causal, offset))
            p = mk.bias ? expf(biased(s[i][j], scale, mk, dm, b, h, r, c) - lse_s[rl])
                        : expf(s[i][j] * scale - lse_s[rl]);
        } else {
          const bool ok = c < dm.Sk && (!causal || c <= r + offset);
          p = ok ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        }
        float dpv = dp[i][j];
        if (dr.on) dpv = keep(seed_bh, r, c, dm.Sk, dr.thresh) ? dpv * dr.keep_scale : 0.f;
        const float ds = p * (dpv - dl_s[rl]);
        if constexpr (MASK)
          if (mk.dbias && r < dm.Sq && c < dm.Sk)
            mk.dbias[(static_cast<size_t>(bh) * dm.Sq + r) * dm.Sk + c] = ds;
        s[i][j] = ds;
      }
    }
    __syncthreads();  // V of this stage is consumed: dS takes its place
    float* dSs = Vt;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(4 * ty + i) * SLD + tx + 16 * j] = s[i][j];
    __syncthreads();

    second_product<DP, BK, SLD, LK>(dSs, Kt, dqa, tx, ty);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  store_rows<DP>(dq + qoff, qstride, dqa, scale, q0, dm.Sq, dm.D, tx, ty);
}

// the q rows of a dkv_fp32_kernel tile
template <int DP>
constexpr int kDkvRows = DP == 64 ? 64 : 32;

// dkv: grid (nk, B*Hk), as dkv_kernel, over q tiles of kDkvRows<DP> rows
template <int DP, bool MASK>
__global__ void __launch_bounds__(kThreads)
dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Dims dm,
                float scale, int causal, Dropout dr, Mask mk) {
  constexpr int BQ = kDkvRows<DP>, BK = 64, LQ = DP + 4, PLD = BQ + 4, NJ = BQ / 16;
  constexpr int QT = BQ * LQ;        // one Q or dO stage
  extern __shared__ __align__(16) float smem16[];
  float* Ks = smem16;                // [BK][DP]
  float* Vs = Ks + BK * DP;          // [BK][DP]
  float* Qs = Vs + BK * DP;          // [2][BQ][LQ]: the ring
  float* dOs = Qs + 2 * QT;          // [2][BQ][LQ]
  float* Pt = dOs + 2 * QT;          // [BK][PLD]: p_v^T
  float* dSt = Pt + BK * PLD;        // [BK][PLD]: ds^T
  float* lse_s = dSt + BK * PLD;     // [2][BQ], as stored (0 past Sq)
  float* dl_s = lse_s + 2 * BQ;      // [2][BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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

  // the q tiles qs .. nq - 1 of each of the group's rep heads see this k
  // tile (causal: tile qi runs iff k0 <= q0 + BQ - 1 + offset), in
  // dkv_kernel's order: heads outer, q tiles inner
  int qs = 0;
  if (causal)
    while (qs < nq && k0 > qs * BQ + BQ - 1 + offset) ++qs;
  const int per = nq - qs, total = rep * per;
  // copy work item `it` (the group's q head it / per, q tile qs + it % per)
  // into ring stage `st`
  auto issue = [&](int it, int st) {
    const int h = hk * rep + it / per, q0 = (qs + it % per) * BQ;
    const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
    load_tile_async<BQ, DP, LQ>(Qs + st * QT, q + qoff, qstride, q0, dm.Sq, dm.D,
                                vec);
    load_tile_async<BQ, DP, LQ>(dOs + st * QT, dout + qoff, qstride, q0, dm.Sq,
                                dm.D, vec);
    const size_t row0 = static_cast<size_t>(b * dm.Hq + h) * dm.Sq;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool ok = q0 + r < dm.Sq;
      cp_async4(lse_s + st * BQ + r, ok ? lse + row0 + q0 + r : lse, ok ? 4 : 0);
      cp_async4(dl_s + st * BQ + r, ok ? delta + row0 + q0 + r : delta,
                ok ? 4 : 0);
    }
  };

  load_tile_async<BK, DP, DP>(Ks, k + koff, kstride, k0, dm.Sk, dm.D, vec);
  load_tile_async<BK, DP, DP>(Vs, v + koff, kstride, k0, dm.Sk, dm.D, vec);
  if (total > 0) issue(0, 0);
  cp_async_commit();

  float dka[4][DP / 16] = {}, dva[4][DP / 16] = {};
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
    __syncthreads();  // this item has landed, and the previous Pt / dSt are consumed
    const float* Qt = Qs + (it & 1) * QT;
    const float* dOt = dOs + (it & 1) * QT;
    const float* ls = lse_s + (it & 1) * BQ;
    const float* dl = dl_s + (it & 1) * BQ;

    // transposed score tile: st[i][j] = s(q row tx + 16 j, k row 4 ty + i)
    float st[4][NJ] = {}, dpt[4][NJ] = {};
    score_products<DP, DP, LQ, NJ>(Ks, Qt, Vs, dOt, st, dpt, tx, ty);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cl = 4 * ty + i, c = k0 + cl;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int rl = tx + 16 * j, r = q0 + rl;
        // as dkv_kernel: a row that sees no key reads 0, a padded row +inf
        const float lsv = r < dm.Sq ? (ls[rl] == -INFINITY ? 0.f : ls[rl]) : INFINITY;
        float p;
        if constexpr (MASK) {
          p = 0.f;
          if (visible(mk, dm, b, r, c, causal, offset))
            p = mk.bias ? expf(biased(st[i][j], scale, mk, dm, b, h, r, c) - lsv)
                        : expf(st[i][j] * scale - lsv);
        } else {
          const bool ok = c < dm.Sk && (!causal || c <= r + offset);
          p = ok ? expf(st[i][j] * scale - lsv) : 0.f;
        }
        float pv = p, dpv = dpt[i][j];
        if (dr.on) {
          const bool kp = keep(seed_bh, r, c, dm.Sk, dr.thresh);
          pv = kp ? p * dr.keep_scale : 0.f;
          dpv = kp ? dpv * dr.keep_scale : 0.f;
        }
        Pt[cl * PLD + rl] = pv;
        dSt[cl * PLD + rl] = p * (dpv - dl[rl]);
      }
    }
    __syncthreads();

    second_product<DP, BQ, PLD, LQ>(Pt, dOt, dva, tx, ty);
    second_product<DP, BQ, PLD, LQ>(dSt, Qt, dka, tx, ty);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  store_rows<DP>(dk + koff, kstride, dka, scale, k0, dm.Sk, dm.D, tx, ty);
  store_rows<DP>(dv + koff, kstride, dva, 1.f, k0, dm.Sk, dm.D, tx, ty);
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: mma.sync behind a cp.async ring
// ---------------------------------------------------------------------------
//
// Every bf16 forward of the FMA route (head dims 1 .. 256, any alignment,
// bias, segments, dropout, GQA, causal): what TMA and wgmma cannot take.
// - Products: mma.sync m16n8k16 (bf16 operands, fp32 sums), operands
//   from shared memory by ldmatrix (ldmatrix.trans for V, whose rows are
//   keys). Each warp owns MT blocks of 16 query rows and keeps their S
//   (16 x BK) and O (16 x DP) accumulators in registers; each K and V
//   fragment it reads serves its MT row blocks. The online softmax runs
//   in registers in the exp2 domain (fwd_sm90_kernel's arithmetic: the
//   bias added in natural units, then log2(e); without the Mask the max
//   is taken on the raw products and the scale joins in the exponent's
//   FFMA), row max and sum over the quad of lanes sharing a row. P is
//   rounded to bf16 in
//   registers and fed to O += P.V as the A fragment (FlashAttention-2),
//   the contract's "p rounded to v's dtype"; dropout is applied to each
//   accumulator element at its (row, key) from the fragment layout.
// - Tiles stay bf16: Q [BQ][DP + 8] and a ring of two K and V stages
//   [BK][DP + 8], D zero-padded to DP = 64, 128 or 256; the 16 bytes
//   past each row put the eight rows of an ldmatrix on distinct banks.
//   Each copy is the widest of 16, 8 or 4 bytes that every row start
//   allows (mma_copy_width); rows only 2-byte aligned (odd D) are loaded
//   and stored element by element. The next K/V tile is copied while this
//   one's products run: one barrier a tile.
// - MmaTile: 64-key tiles; at DP <= 128, 4 warps of two row blocks (q
//   tiles of 128 rows), of one under the Mask (its bias rows and segment
//   words spilled beside two); at DP = 256, 8 warps of one row block (O
//   alone takes 128 registers a thread), 198 KB of shared memory. Q
//   fragments are read again for every tile. The alternatives
//   `chip_ab.py` times were slower on an H100 (PERF.md).
// - A warp skips a key tile its rows cannot see (causal); q tiles run
//   longest first across the grid, as fwd_fp32_kernel's.

template <int DP, bool MASK>
struct MmaTile {
  static constexpr int WARPS = DP <= 128 ? 4 : 8;
  static constexpr int MT = DP <= 128 && !MASK ? 2 : 1;   // 16-row blocks a warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS, BK = 64;
  static constexpr int LD = DP + 8;                 // bf16 a shared row
  static constexpr int Q_ELEMS = BQ * LD, KV_ELEMS = BK * LD;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * (Q_ELEMS + 4 * KV_ELEMS);
};

// The widest copy, in bytes, that every row of the three operands starts
// on: rows lie 2 D bytes apart from their tensor's base.
__device__ __forceinline__ int mma_copy_width(const void* a, const void* b,
                                              const void* c, int D) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         static_cast<uintptr_t>(2 * D);
  return (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8 : (bits & 3) == 0 ? 4 : 2;
}

// copy W bytes (or 0: zero-fill) from global src to shared dst
template <int W>
__device__ __forceinline__ void cp_async_w(void* dst, const void* src,
                                           int bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(W), "r"(bytes)
                 : "memory");
}

template <int ROWS, int DP, int LD, int NT, int W>
__device__ __forceinline__ void copy_bf16_rows(uint16_t* dst,
                                               const uint16_t* base,
                                               size_t stride, int s0, int S,
                                               int D) {
  constexpr int E = W / 2, CH = DP / E;             // elements a copy, copies a row
#pragma unroll 4
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / CH, c = (i % CH) * E, s = s0 + r;
    const bool ok = s < S && c < D;
    cp_async_w<W>(dst + r * LD + c,
                  ok ? base + static_cast<size_t>(s) * stride + c : base,
                  ok ? W : 0);
  }
}

// Rows [s0, s0 + ROWS) of one head of a [batch, S, H, D] bf16 tensor (base
// = &t[b, 0, h, 0], row stride `stride` elements) into a [ROWS][LD] tile,
// zero past S and past D (up to DP): cp.async copies of W = 16, 8 or 4
// bytes, or at W = 2 plain loads and shared stores.
template <int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void load_bf16_tile(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               size_t stride, int s0, int S,
                                               int D, int W) {
  uint16_t* d = reinterpret_cast<uint16_t*>(dst);
  const uint16_t* base = reinterpret_cast<const uint16_t*>(src);
  if (W == 16) {
    copy_bf16_rows<ROWS, DP, LD, NT, 16>(d, base, stride, s0, S, D);
  } else if (W == 8) {
    copy_bf16_rows<ROWS, DP, LD, NT, 8>(d, base, stride, s0, S, D);
  } else if (W == 4) {
    copy_bf16_rows<ROWS, DP, LD, NT, 4>(d, base, stride, s0, S, D);
  } else {
#pragma unroll 8
    for (int it = 0; it < ROWS * DP / NT; ++it) {
      const int i = it * NT + threadIdx.x;
      const int r = i / DP, c = i % DP, s = s0 + r;
      d[r * LD + c] = s < S && c < D ? base[static_cast<size_t>(s) * stride + c] : 0;
    }
  }
}

// four 8 x 8 bf16 matrices from shared memory, lanes 8 i .. 8 i + 7 giving
// the row addresses of matrix i (.trans: each lane gets a column pair)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[0..3] += A (16 x 16, row) . B (16 x 8, col), bf16 operands, fp32 sums.
// Lane l (g = l / 4, t = l % 4) holds d at rows g and g + 8 (d[0], d[1] and
// d[2], d[3]), columns 2 t and 2 t + 1.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// forward: grid (nq, B*Hq), q tiles of MmaTile<DP, MASK>::BQ rows
template <int DP, bool MASK>
__global__ void __launch_bounds__(MmaTile<DP, MASK>::THREADS, 1)
fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               Dims dm, float scale, int causal, Dropout dr, Mask mk) {
  using TL = MmaTile<DP, MASK>;
  constexpr int BQ = TL::BQ, BK = TL::BK, LD = TL::LD, NT = TL::THREADS;
  constexpr int MT = TL::MT, NB = BK / 8;           // key blocks of 8 in a tile
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + TL::Q_ELEMS;             // [2][BK][LD]: the ring
  __nv_bfloat16* Vs = Ks + 2 * TL::KV_ELEMS;        // [2][BK][LD]

  // block n of the grid (x fastest) takes head n % (B*Hq), q tile
  // nq - 1 - n / (B*Hq)
  const int n = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = n % static_cast<int>(gridDim.y);
  const int q0 = (gridDim.x - 1 - n / static_cast<int>(gridDim.y)) * BQ;
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int offset = dm.Sk - dm.Sq;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const int width = mma_copy_width(q, k, v, dm.D);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int row_base = q0 + 16 * MT * w;            // this warp's first row
  const uint32_t seed_bh =
      dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
  const float scale_log2 = scale * kLog2e;
  // Without the Mask and with a positive scale the max is taken on the
  // raw products (rounding is monotone) and the scale joins in the
  // exponent's FFMA as c_exp; else the scores are scaled first (c_exp 1).
  const bool raw = !MASK && scale_log2 > 0.f;
  const float c_exp = raw ? scale_log2 : 1.f;

  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) nk = causal_k_tiles<BQ, BK>(q0, offset, nk);
  load_bf16_tile<BQ, DP, LD, NT>(Qs, q + qoff, qstride, q0, dm.Sq, dm.D, width);
  if (nk > 0) {
    load_bf16_tile<BK, DP, LD, NT>(Ks, kb, kstride, 0, dm.Sk, dm.D, width);
    load_bf16_tile<BK, DP, LD, NT>(Vs, vb, kstride, 0, dm.Sk, dm.D, width);
  }
  cp_async_commit();

  // row r of this lane's accumulators: row_base + 16 (r / 2) + l / 4 +
  // 8 (r % 2), for r = 0 .. 2 MT - 1
  auto row_of = [&](int r) { return row_base + 16 * (r >> 1) + (l >> 2) + 8 * (r & 1); };
  // the bias rows of this lane's rows (NULL past Sq: no bias there)
  [[maybe_unused]] const float* brow[2 * MT] = {};
  if (MASK && mk.bias) {
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r)
      if (row_of(r) < dm.Sq) brow[r] = mk.bias + b * mk.sb + h * mk.sh + row_of(r) * mk.sq;
  }

  float o[MT][DP / 2];                              // DP / 8 column blocks x 4
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[mt][i] = 0.f;
  float m[2 * MT], lsum[2 * MT];                    // max in log2 units; this lane's sums
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    m[r] = -INFINITY;
    lsum[r] = 0.f;
  }
  // ldmatrix row addresses: Q (A, 16 x 16), K (B of S, two 8-key blocks)
  // and V (B of O, .trans, two 8-column blocks)
  const __nv_bfloat16* qa = Qs + (16 * MT * w + (l & 15)) * LD + (l >> 4) * 8;
  const int k_lane = ((l & 7) + ((l >> 4) << 3)) * LD + ((l >> 3) & 1) * 8;
  const int v_lane = ((l & 7) + ((l >> 3) & 1) * 8) * LD + (l >> 4) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other stage is consumed
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_bf16_tile<BK, DP, LD, NT>(Ks + nxt * TL::KV_ELEMS, kb, kstride, k0 + BK,
                                     dm.Sk, dm.D, width);
      load_bf16_tile<BK, DP, LD, NT>(Vs + nxt * TL::KV_ELEMS, vb, kstride, k0 + BK,
                                     dm.Sk, dm.D, width);
      cp_async_commit();
    }
    // a tile past this warp's last causal diagonal adds nothing
    if (causal && k0 > row_base + 16 * MT - 1 + offset) continue;
    const __nv_bfloat16* Kt = Ks + (kt & 1) * TL::KV_ELEMS;
    const __nv_bfloat16* Vt = Vs + (kt & 1) * TL::KV_ELEMS;

    // S = Q K^T: for each row block, NB key blocks x 4
    float sc[MT][BK / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[mt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], qa + 16 * mt * LD + 16 * kk);
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t bq[4];
        ldsm_x4(bq, Kt + 16 * nb * LD + k_lane + 16 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt] + 8 * nb, a[mt], bq[0], bq[1]);
          mma_bf16(sc[mt] + 8 * nb + 4, a[mt], bq[2], bq[3]);
        }
      }
    }

    // mask where the diagonal or the key edge cuts, and everywhere under
    // the Mask, which also scales (and adds the bias) into the exp2 domain
    const bool cut = MASK || k0 + BK > dm.Sk ||
                     (causal && k0 + BK - 1 > row_base + offset);
    if (!MASK && !raw) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[mt][i] *= scale_log2;
    }
    if (cut) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = k0 + 8 * i + 2 * (l & 3) + (j & 1);
            const int rr = 2 * mt + (j >> 1), r = row_of(rr);
            float& x = sc[mt][4 * i + j];
            if constexpr (MASK) {
              const float* br = brow[rr];
              x = br != nullptr
                      ? __fmul_rn(__fadd_rn(__fmul_rn(x, scale),
                                            c < dm.Sk ? br[c * mk.sk] : 0.f),
                                  kLog2e)
                      : x * scale_log2;
              if (!visible(mk, dm, b, r, c, causal, offset)) x = -INFINITY;
            } else if (c >= dm.Sk || (causal && c > r + offset)) {
              x = -INFINITY;
            }
          }
    }

    // online softmax over this lane's 2 MT rows
    float mx[2 * MT];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) mx[r] = -INFINITY;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[2 * mt + ((i >> 1) & 1)] = fmaxf(mx[2 * mt + ((i >> 1) & 1)], sc[mt][i]);
    float neg_m[2 * MT], alpha[2 * MT];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * c_exp);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2_ftz(m[r] - m_safe);            // 0 while m was -inf
      neg_m[r] = -m_safe;
      m[r] = m_new;
    }
    // p, its row sums, and P (dropped) rounded to bf16 as the A fragments
    // of O += P V
    float rs[2 * MT];
    uint32_t pa[MT][BK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      rs[2 * mt] = rs[2 * mt + 1] = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float pv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = 2 * mt + (j >> 1);
          const float p = ex2_ftz(fmaf(sc[mt][4 * i + j], c_exp, neg_m[rr]));
          rs[rr] += p;
          pv[j] = p;
          if (dr.on)
            pv[j] = keep(seed_bh, row_of(rr), k0 + 8 * i + 2 * (l & 3) + (j & 1),
                         dm.Sk, dr.thresh)
                        ? p * dr.keep_scale
                        : 0.f;
        }
        pa[mt][i >> 1][2 * (i & 1)] = pack_bf16(pv[0], pv[1]);
        pa[mt][i >> 1][2 * (i & 1) + 1] = pack_bf16(pv[2], pv[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) lsum[r] = alpha[r] * lsum[r] + rs[r];
    // O *= alpha (1 where a row's max did not move)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[mt][i] *= alpha[2 * mt + ((i >> 1) & 1)];

    // O += P V
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vt + 16 * kc * LD + v_lane + 16 * nd);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt] + 8 * nd, pa[mt][kc], bv[0], bv[1]);
          mma_bf16(o[mt] + 8 * nd + 4, pa[mt][kc], bv[2], bv[3]);
        }
      }
  }
  cp_async_wait<0>();

  // out = O / l (0 where no key is seen), lse = m ln 2 + log l (-inf there);
  // column pairs as one 4-byte store where out's rows allow
  __nv_bfloat16* ob = out + qoff;
  const bool pairs = ((reinterpret_cast<uintptr_t>(out) | (2u * dm.D)) & 3) == 0;
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const float L = quad_sum(lsum[r]);
    const float inv = L > 0.f ? 1.f / L : 0.f;
    const int row = row_of(r);
    if (row >= dm.Sq) continue;
    if ((l & 3) == 0)
      lse[static_cast<size_t>(bh) * dm.Sq + row] =
          L > 0.f ? m[r] * kLn2 + logf(L) : -INFINITY;
    __nv_bfloat16* orow = ob + static_cast<size_t>(row) * qstride;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + 2 * (l & 3);
      const float x0 = o[r >> 1][4 * i + 2 * (r & 1)] * inv;
      const float x1 = o[r >> 1][4 * i + 2 * (r & 1) + 1] * inv;
      if (pairs) {
        if (c < dm.D)
          *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(x0, x1);
      } else {
        if (c < dm.D) orow[c] = __float2bfloat16(x0);
        if (c + 1 < dm.D) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dq and dkv on the tensor cores: mma.sync behind a cp.async ring
// ---------------------------------------------------------------------------
//
// Every bf16 dq and dkv of the FMA route, as fwd_mma_kernel is its
// forward: the forward's shape with roles swapped, and its helpers
// (mma_copy_width, load_bf16_tile, ldsm_x4 / ldsm_x4_trans, mma_bf16, the
// accumulator-to-A-fragment repacking, Mask and dropout at fragment
// coordinates). p = 2^(scale log2(e) s - log2(e) lse) in the exp2 domain
// (the bias added in natural units first; an lse of -inf read as 0, a
// row past Sq p = 0); ds = p (dP dropped - delta) in fp32, rounded to
// bf16 as the A fragment of its product, as is the dropped p of dV.
// - dq: grid (nq, B*Hq), q tiles longest first. Each warp owns one 16-row
//   block of q; Q and dO stay in shared memory, a ring of two K/V stages
//   holds keys. S = Q K^T and dP = dO V^T take K and V rows by ldmatrix,
//   dQ += ds K takes K by ldmatrix.trans. dQ is scaled at the end; with
//   the Mask's dbias, ds is written in fp32 at fragment coordinates.
// - dkv: grid (nk, B*Hk), key tiles that see the most q tiles first. K
//   and V stay resident; a ring of two Q/dO stages, each with its lse and
//   delta rows, runs from the first q tile that sees the key tile through
//   every q head of the kv head's group (dK and dV sum the group in one
//   block, no atomics). Each warp owns one 16-key block: S^T = K Q^T and
//   dP^T = V dO^T read lse and delta for its columns (queries) from the
//   stage; P^T and ds^T repack into A fragments of dV += P^T dO and
//   dK += ds^T Q, dO and Q by ldmatrix.trans.
// - The register budget. dq's dQ is DP / 2 fp32 a lane (128 at DP = 256)
//   beside S and dP at BK / 2 each: BK = 64 up to DP = 128, 32 at 256.
//   Under the Mask at DP = 256 (its bias rows and masks would spill) two
//   warps share each 16-row block, both computing its scores, each
//   accumulating dQ over half of D (NS = 2). dkv's dK
//   and dV are DP fp32 a lane for a 16-key block, 256 at DP = 256, more
//   than a lane holds: there the warps split D (NS = 2,
//   FlashAttention-2's layout for wide heads): each (key block, half)
//   warp computes the scores of its keys for half of the q tile's
//   queries, stages P^T and ds^T as bf16 in shared memory, and after a
//   barrier accumulates dK and dV for its keys over its half of D. Q
//   tiles are 64 rows (16 at DP = 128 under the Mask, whose bias reads
//   would spill). At DP = 64 without the Mask dkv fits 168 registers, so
//   three blocks share an SM. `chip_ab.py` times the alternatives.
// - Tiles bf16, rows padded by 16 bytes, D zero-padded to DP; copies as
//   the forward's. A warp skips the products of a tile that the causal
//   diagonal hides from all of its rows (dq) or keys (dkv).

template <int DP, bool MASK>
struct DqTile {
  static constexpr int NS = DP == 256 && MASK ? 2 : 1;  // warps a 16-row block
  static constexpr int WARPS = DP == 256 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS / NS, BK = DP <= 128 ? 64 : 32;
  static constexpr int LD = DP + 8;
  static constexpr int Q_ELEMS = BQ * LD, KV_ELEMS = BK * LD;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * (2 * Q_ELEMS + 4 * KV_ELEMS);
};

template <int DP, bool MASK>
struct DkvTile {
  static constexpr int NS = DP == 256 ? 2 : 1;      // parts of D a key block
  static constexpr int BK = 64, WARPS = BK / 16 * NS, THREADS = 32 * WARPS;
  static constexpr int BQ = DP == 128 && MASK ? 16 : 64;
  static constexpr int BLOCKS = DP == 64 && !MASK ? 3 : 1;  // an SM: 168 registers
  static constexpr int LD = DP + 8, PLD = BQ + 8;   // bf16 a shared row
  static constexpr int KV_ELEMS = BK * LD, Q_ELEMS = BQ * LD;
  static constexpr int P_ELEMS = NS > 1 ? BK * PLD : 0;
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (2 * KV_ELEMS + 4 * Q_ELEMS + 2 * P_ELEMS) +
      sizeof(float) * 4 * BQ;
};

// the widest copy every row of q, k, v and dO starts on
__device__ __forceinline__ int bwd_copy_width(const void* q, const void* k,
                                              const void* v, const void* dout,
                                              int D) {
  return min(mma_copy_width(q, k, v, D), mma_copy_width(dout, dout, dout, D));
}

// dq: grid (nq, B*Hq), q tiles of DqTile<DP, MASK>::BQ rows
template <int DP, bool MASK>
__global__ void __launch_bounds__(DqTile<DP, MASK>::THREADS, 1)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, Dims dm, float scale, int causal,
              Dropout dr, Mask mk) {
  using TL = DqTile<DP, MASK>;
  constexpr int BQ = TL::BQ, BK = TL::BK, LD = TL::LD, NT = TL::THREADS;
  constexpr int NB = BK / 8;                        // key blocks of 8 in a tile
  constexpr int DW = DP / TL::NS;                   // a warp's columns of dQ
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [BQ][LD]
  __nv_bfloat16* dOs = Qs + TL::Q_ELEMS;            // [BQ][LD]
  __nv_bfloat16* Ks = dOs + TL::Q_ELEMS;            // [2][BK][LD]: the ring
  __nv_bfloat16* Vs = Ks + 2 * TL::KV_ELEMS;        // [2][BK][LD]

  // block n of the grid (x fastest) takes head n % (B*Hq), q tile
  // nq - 1 - n / (B*Hq), as fwd_mma_kernel
  const int n = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = n % static_cast<int>(gridDim.y);
  const int q0 = (gridDim.x - 1 - n / static_cast<int>(gridDim.y)) * BQ;
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int offset = dm.Sk - dm.Sq;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const int width = bwd_copy_width(q, k, v, dout, dm.D);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int rb = w / TL::NS, d_lo = w % TL::NS * DW;  // row block, first column
  const int row_base = q0 + 16 * rb;                // this warp's first row
  const uint32_t seed_bh =
      dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
  const float scale_log2 = scale * kLog2e;

  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) nk = causal_k_tiles<BQ, BK>(q0, offset, nk);
  load_bf16_tile<BQ, DP, LD, NT>(Qs, q + qoff, qstride, q0, dm.Sq, dm.D, width);
  load_bf16_tile<BQ, DP, LD, NT>(dOs, dout + qoff, qstride, q0, dm.Sq, dm.D, width);
  if (nk > 0) {
    load_bf16_tile<BK, DP, LD, NT>(Ks, kb, kstride, 0, dm.Sk, dm.D, width);
    load_bf16_tile<BK, DP, LD, NT>(Vs, vb, kstride, 0, dm.Sk, dm.D, width);
  }
  cp_async_commit();

  // this lane's rows row_base + l / 4 + 8 r (r = 0, 1): -log2(e) lse (a
  // row that sees no key reads lse 0; a row past Sq -inf: p = 0), delta,
  // and the bias row (NULL past Sq)
  float neg_lse[2], dl[2];
  [[maybe_unused]] const float* brow[2] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + (l >> 2) + 8 * r;
    neg_lse[r] = -INFINITY;
    dl[r] = 0.f;
    if (row < dm.Sq) {
      const size_t idx = static_cast<size_t>(bh) * dm.Sq + row;
      const float ls = lse[idx];
      neg_lse[r] = -(ls == -INFINITY ? 0.f : ls) * kLog2e;
      dl[r] = delta[idx];
      if (MASK && mk.bias) brow[r] = mk.bias + b * mk.sb + h * mk.sh + row * mk.sq;
    }
  }

  float acc[DW / 2];                                // DW / 8 column blocks x 4
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;
  // ldmatrix row addresses: Q and dO (A, 16 x 16), K and V rows (B of S
  // and dP, two 8-key blocks), K (B of dQ, .trans, two 8-column blocks)
  const __nv_bfloat16* qa = Qs + (16 * rb + (l & 15)) * LD + (l >> 4) * 8;
  const __nv_bfloat16* oa = dOs + (16 * rb + (l & 15)) * LD + (l >> 4) * 8;
  const int k_lane = ((l & 7) + ((l >> 4) << 3)) * LD + ((l >> 3) & 1) * 8;
  const int t_lane = ((l & 7) + ((l >> 3) & 1) * 8) * LD + (l >> 4) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other stage is consumed
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_bf16_tile<BK, DP, LD, NT>(Ks + nxt * TL::KV_ELEMS, kb, kstride, k0 + BK,
                                     dm.Sk, dm.D, width);
      load_bf16_tile<BK, DP, LD, NT>(Vs + nxt * TL::KV_ELEMS, vb, kstride, k0 + BK,
                                     dm.Sk, dm.D, width);
      cp_async_commit();
    }
    // a tile past this warp's last causal diagonal adds nothing
    if (causal && k0 > row_base + 15 + offset) continue;
    const __nv_bfloat16* Kt = Ks + (kt & 1) * TL::KV_ELEMS;
    const __nv_bfloat16* Vt = Vs + (kt & 1) * TL::KV_ELEMS;

    // S = Q K^T and dP = dO V^T: NB key blocks x 4 each
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, qa + 16 * kk);
      ldsm_x4(ao, oa + 16 * kk);
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Kt + 16 * nb * LD + k_lane + 16 * kk);
        ldsm_x4(bv, Vt + 16 * nb * LD + k_lane + 16 * kk);
        mma_bf16(s + 8 * nb, aq, bk[0], bk[1]);
        mma_bf16(s + 8 * nb + 4, aq, bk[2], bk[3]);
        mma_bf16(dp + 8 * nb, ao, bv[0], bv[1]);
        mma_bf16(dp + 8 * nb + 4, ao, bv[2], bv[3]);
      }
    }

    // p, ds = p (dP dropped - delta), and ds rounded to bf16 as the A
    // fragments of dQ += ds K; masks where the diagonal or the key edge
    // cuts, and everywhere under the Mask
    const bool cut = MASK || k0 + BK > dm.Sk ||
                     (causal && k0 + BK - 1 > row_base + offset);
    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + 8 * i + 2 * (l & 3) + (j & 1);
        const int rr = j >> 1, r = row_base + (l >> 2) + 8 * rr;
        float x = fmaf(s[4 * i + j], scale_log2, neg_lse[rr]);
        if constexpr (MASK) {
          if (brow[rr] != nullptr)
            x = fmaf(__fadd_rn(__fmul_rn(s[4 * i + j], scale),
                               c < dm.Sk ? brow[rr][c * mk.sk] : 0.f),
                     kLog2e, neg_lse[rr]);
        }
        float p = ex2_ftz(x);
        if (cut) {
          if constexpr (MASK) {
            if (!visible(mk, dm, b, r, c, causal, offset)) p = 0.f;
          } else if (c >= dm.Sk || (causal && c > r + offset)) {
            p = 0.f;
          }
        }
        float dpv = dp[4 * i + j];
        if (dr.on)
          dpv = keep(seed_bh, r, c, dm.Sk, dr.thresh) ? dpv * dr.keep_scale : 0.f;
        ds[j] = p * (dpv - dl[rr]);
        if constexpr (MASK)
          if (mk.dbias && d_lo == 0 && r < dm.Sq && c < dm.Sk)
            mk.dbias[(static_cast<size_t>(bh) * dm.Sq + r) * dm.Sk + c] = ds[j];
      }
      dsa[i >> 1][2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
      dsa[i >> 1][2 * (i & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += ds K, over this warp's DW columns
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int nd = 0; nd < DW / 16; ++nd) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, Kt + 16 * kc * LD + t_lane + d_lo + 16 * nd);
        mma_bf16(acc + 8 * nd, dsa[kc], bk[0], bk[1]);
        mma_bf16(acc + 8 * nd + 4, dsa[kc], bk[2], bk[3]);
      }
  }
  cp_async_wait<0>();

  // dq = scale dQ; column pairs as one 4-byte store where dq's rows allow
  __nv_bfloat16* db = dq + qoff;
  const bool pairs = ((reinterpret_cast<uintptr_t>(dq) | (2u * dm.D)) & 3) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + (l >> 2) + 8 * r;
    if (row >= dm.Sq) continue;
    __nv_bfloat16* drow = db + static_cast<size_t>(row) * qstride;
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      const int c = d_lo + 8 * i + 2 * (l & 3);
      const float x0 = acc[4 * i + 2 * r] * scale, x1 = acc[4 * i + 2 * r + 1] * scale;
      if (pairs) {
        if (c < dm.D) *reinterpret_cast<uint32_t*>(drow + c) = pack_bf16(x0, x1);
      } else {
        if (c < dm.D) drow[c] = __float2bfloat16(x0);
        if (c + 1 < dm.D) drow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// dkv: grid (nk, B*Hk), key tiles of DkvTile<DP, MASK>::BK keys
template <int DP, bool MASK>
__global__ void __launch_bounds__(DkvTile<DP, MASK>::THREADS, DkvTile<DP, MASK>::BLOCKS)
dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               Dims dm, float scale, int causal, Dropout dr, Mask mk) {
  using TL = DkvTile<DP, MASK>;
  constexpr int BQ = TL::BQ, BK = TL::BK, LD = TL::LD, PLD = TL::PLD, NT = TL::THREADS;
  constexpr int NS = TL::NS, QW = BQ / NS, DW = DP / NS;  // a warp's queries, columns
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [BK][LD]
  __nv_bfloat16* Vs = Ks + TL::KV_ELEMS;            // [BK][LD]
  __nv_bfloat16* Qs = Vs + TL::KV_ELEMS;            // [2][BQ][LD]: the ring
  __nv_bfloat16* dOs = Qs + 2 * TL::Q_ELEMS;        // [2][BQ][LD]
  [[maybe_unused]] __nv_bfloat16* Pst = dOs + 2 * TL::Q_ELEMS;  // [BK][PLD] (NS > 1)
  [[maybe_unused]] __nv_bfloat16* dSst = Pst + TL::P_ELEMS;     // [BK][PLD]
  float* lse_s = reinterpret_cast<float*>(dSst + TL::P_ELEMS);  // [2][BQ], as stored
  float* dl_s = lse_s + 2 * BQ;                     // [2][BQ]

  // block n of the grid (x fastest) takes kv head n % (B*Hk), key tile
  // n / (B*Hk): under causal the low key tiles, which see the most q
  // tiles, first
  const int n = blockIdx.y * gridDim.x + blockIdx.x;
  const int bhk = n % static_cast<int>(gridDim.y);
  const int k0 = n / static_cast<int>(gridDim.y) * BK;
  const int b = bhk / dm.Hk, hk = bhk % dm.Hk;
  const int rep = dm.Hq / dm.Hk;
  const int offset = dm.Sk - dm.Sq;
  const int nq = (dm.Sq + BQ - 1) / BQ;
  const size_t qstride = static_cast<size_t>(dm.Hq) * dm.D;
  const size_t kstride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t koff = (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  const int width = bwd_copy_width(q, k, v, dout, dm.D);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int kb = w % (BK / 16), part = w / (BK / 16);
  const int key_base = k0 + 16 * kb;                // this warp's first key
  const int q_lo = part * QW, d_lo = part * DW;     // its queries and columns
  const float scale_log2 = scale * kLog2e;

  // the q tiles qs .. nq - 1 of each of the group's rep heads see this key
  // tile (causal: tile qi runs iff k0 <= q0 + BQ - 1 + offset): heads
  // outer, q tiles inner
  int qs = 0;
  if (causal)
    while (qs < nq && k0 > qs * BQ + BQ - 1 + offset) ++qs;
  const int per = nq - qs, total = rep * per;
  // copy work item `it` (the group's q head it / per, q tile qs + it % per)
  // into ring stage `st`: Q, dO, and lse and delta as stored (0 past Sq)
  auto issue = [&](int it, int st) {
    const int h = hk * rep + it / per, q0 = (qs + it % per) * BQ;
    const size_t qoff = (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
    load_bf16_tile<BQ, DP, LD, NT>(Qs + st * TL::Q_ELEMS, q + qoff, qstride, q0, dm.Sq,
                                   dm.D, width);
    load_bf16_tile<BQ, DP, LD, NT>(dOs + st * TL::Q_ELEMS, dout + qoff, qstride, q0,
                                   dm.Sq, dm.D, width);
    const size_t row0 = static_cast<size_t>(b * dm.Hq + h) * dm.Sq;
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool ok = q0 + r < dm.Sq;
      cp_async4(lse_s + st * BQ + r, ok ? lse + row0 + q0 + r : lse, ok ? 4 : 0);
      cp_async4(dl_s + st * BQ + r, ok ? delta + row0 + q0 + r : delta, ok ? 4 : 0);
    }
  };

  load_bf16_tile<BK, DP, LD, NT>(Ks, k + koff, kstride, k0, dm.Sk, dm.D, width);
  load_bf16_tile<BK, DP, LD, NT>(Vs, v + koff, kstride, k0, dm.Sk, dm.D, width);
  if (total > 0) issue(0, 0);
  cp_async_commit();

  float dka[DW / 2], dva[DW / 2];                   // DW / 8 column blocks x 4
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;
  // ldmatrix row addresses: K and V rows of this warp's keys (A of S^T and
  // dP^T), Q and dO rows (B, two 8-query blocks), Q and dO (B of dK and
  // dV, .trans, two 8-column blocks), staged P^T and ds^T (A, NS > 1)
  const __nv_bfloat16* ka = Ks + (16 * kb + (l & 15)) * LD + (l >> 4) * 8;
  const __nv_bfloat16* va = Vs + (16 * kb + (l & 15)) * LD + (l >> 4) * 8;
  const int q_lane = ((l & 7) + ((l >> 4) << 3)) * LD + ((l >> 3) & 1) * 8;
  const int t_lane = ((l & 7) + ((l >> 3) & 1) * 8) * LD + (l >> 4) * 8;
  [[maybe_unused]] const int p_lane = (16 * kb + (l & 15)) * PLD + (l >> 4) * 8;

  for (int it = 0; it < total; ++it) {
    const int h = hk * rep + it / per, q0 = (qs + it % per) * BQ;
    const int bh = b * dm.Hq + h;
    cp_async_wait<0>();
    __syncthreads();  // this item has landed; the other stage (and P^T, ds^T) consumed
    if (it + 1 < total) {
      issue(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    // this warp's keys past the diagonal of its queries, and of all the
    // tile's
    const bool hidden = causal && key_base > q0 + q_lo + QW - 1 + offset;
    const bool hidden_all = causal && key_base > q0 + BQ - 1 + offset;
    if (NS == 1 && hidden) continue;
    const __nv_bfloat16* Qt = Qs + (it & 1) * TL::Q_ELEMS;
    const __nv_bfloat16* dOt = dOs + (it & 1) * TL::Q_ELEMS;
    const float* ls = lse_s + (it & 1) * BQ;
    const float* dls = dl_s + (it & 1) * BQ;
    const uint32_t seed_bh =
        dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;

    // P^T (dropped) and ds^T of this warp's keys and queries as bf16 A
    // fragments: 16 keys x QW queries
    uint32_t pa[QW / 16][4], sa[QW / 16][4];
    if (!hidden) {
      float st[QW / 2], dpt[QW / 2];
#pragma unroll
      for (int i = 0; i < QW / 2; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, ka + 16 * kk);
        ldsm_x4(av, va + 16 * kk);
#pragma unroll
        for (int nb = 0; nb < QW / 16; ++nb) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, Qt + (q_lo + 16 * nb) * LD + q_lane + 16 * kk);
          ldsm_x4(bo, dOt + (q_lo + 16 * nb) * LD + q_lane + 16 * kk);
          mma_bf16(st + 8 * nb, ak, bq[0], bq[1]);
          mma_bf16(st + 8 * nb + 4, ak, bq[2], bq[3]);
          mma_bf16(dpt + 8 * nb, av, bo[0], bo[1]);
          mma_bf16(dpt + 8 * nb + 4, av, bo[2], bo[3]);
        }
      }
      // masks where a key or query edge or the diagonal cuts, and
      // everywhere under the Mask
      const bool cut = MASK || key_base + 16 > dm.Sk || q0 + q_lo + QW > dm.Sq ||
                       (causal && key_base + 15 > q0 + q_lo + offset);
#pragma unroll
      for (int i = 0; i < QW / 8; ++i) {
        // this lane's queries rl, rl + 1 of the tile (columns 2 (l % 4), + 1
        // of query block i)
        const int rl = q_lo + 8 * i + 2 * (l & 3);
        const float2 lsv = *reinterpret_cast<const float2*>(ls + rl);
        const float2 dlv = *reinterpret_cast<const float2*>(dls + rl);
        float pv[4], dsv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = q0 + rl + (j & 1), c = key_base + (l >> 2) + 8 * (j >> 1);
          const float lsj = (j & 1) ? lsv.y : lsv.x;
          const float neg_lse = -(lsj == -INFINITY ? 0.f : lsj) * kLog2e;
          float x = fmaf(st[4 * i + j], scale_log2, neg_lse);
          if constexpr (MASK) {
            if (mk.bias && r < dm.Sq && c < dm.Sk)
              x = fmaf(__fadd_rn(__fmul_rn(st[4 * i + j], scale), bias_at(mk, b, h, r, c)),
                       kLog2e, neg_lse);
          }
          float p = ex2_ftz(x);
          if (cut) {
            if constexpr (MASK) {
              if (r >= dm.Sq || !visible(mk, dm, b, r, c, causal, offset)) p = 0.f;
            } else if (r >= dm.Sq || c >= dm.Sk || (causal && c > r + offset)) {
              p = 0.f;
            }
          }
          float pd = p, dpv = dpt[4 * i + j];
          if (dr.on) {
            const bool kp = keep(seed_bh, r, c, dm.Sk, dr.thresh);
            pd = kp ? p * dr.keep_scale : 0.f;
            dpv = kp ? dpv * dr.keep_scale : 0.f;
          }
          pv[j] = pd;
          dsv[j] = p * (dpv - ((j & 1) ? dlv.y : dlv.x));
        }
        pa[i >> 1][2 * (i & 1)] = pack_bf16(pv[0], pv[1]);
        pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(pv[2], pv[3]);
        sa[i >> 1][2 * (i & 1)] = pack_bf16(dsv[0], dsv[1]);
        sa[i >> 1][2 * (i & 1) + 1] = pack_bf16(dsv[2], dsv[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < QW / 16; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[i][x] = sa[i][x] = 0u;
    }

    if constexpr (NS == 1) {
      // dV += P^T dO, dK += ds^T Q
#pragma unroll
      for (int qc = 0; qc < BQ / 16; ++qc)
#pragma unroll
        for (int nd = 0; nd < DP / 16; ++nd) {
          uint32_t bo[4], bq[4];
          ldsm_x4_trans(bo, dOt + 16 * qc * LD + t_lane + 16 * nd);
          ldsm_x4_trans(bq, Qt + 16 * qc * LD + t_lane + 16 * nd);
          mma_bf16(dva + 8 * nd, pa[qc], bo[0], bo[1]);
          mma_bf16(dva + 8 * nd + 4, pa[qc], bo[2], bo[3]);
          mma_bf16(dka + 8 * nd, sa[qc], bq[0], bq[1]);
          mma_bf16(dka + 8 * nd + 4, sa[qc], bq[2], bq[3]);
        }
    } else {
      // stage this warp's fragments (rows l / 4 (+ 8), columns 2 (l % 4)
      // (+ 8) of each 16 x 16 block), then each warp takes its keys'
      // P^T and ds^T over all BQ queries for its DW columns
#pragma unroll
      for (int qc = 0; qc < QW / 16; ++qc)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int at = (16 * kb + (l >> 2) + 8 * (x & 1)) * PLD + q_lo + 16 * qc +
                         2 * (l & 3) + 8 * (x >> 1);
          *reinterpret_cast<uint32_t*>(Pst + at) = pa[qc][x];
          *reinterpret_cast<uint32_t*>(dSst + at) = sa[qc][x];
        }
      __syncthreads();
      if (!hidden_all) {
#pragma unroll
        for (int qc = 0; qc < BQ / 16; ++qc) {
          uint32_t ap[4], as[4];
          ldsm_x4(ap, Pst + p_lane + 16 * qc);
          ldsm_x4(as, dSst + p_lane + 16 * qc);
#pragma unroll
          for (int nd = 0; nd < DW / 16; ++nd) {
            uint32_t bo[4], bq[4];
            ldsm_x4_trans(bo, dOt + 16 * qc * LD + t_lane + d_lo + 16 * nd);
            ldsm_x4_trans(bq, Qt + 16 * qc * LD + t_lane + d_lo + 16 * nd);
            mma_bf16(dva + 8 * nd, ap, bo[0], bo[1]);
            mma_bf16(dva + 8 * nd + 4, ap, bo[2], bo[3]);
            mma_bf16(dka + 8 * nd, as, bq[0], bq[1]);
            mma_bf16(dka + 8 * nd + 4, as, bq[2], bq[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // dk = scale dK, dv = dV; column pairs as one 4-byte store where the
  // rows allow
  __nv_bfloat16* dkb = dk + koff;
  __nv_bfloat16* dvb = dv + koff;
  const bool pairs = ((reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                       (2u * dm.D)) & 3) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key_base + (l >> 2) + 8 * r;
    if (row >= dm.Sk) continue;
    __nv_bfloat16* krow = dkb + static_cast<size_t>(row) * kstride;
    __nv_bfloat16* vrow = dvb + static_cast<size_t>(row) * kstride;
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      const int c = d_lo + 8 * i + 2 * (l & 3);
      const float k0v = dka[4 * i + 2 * r] * scale, k1v = dka[4 * i + 2 * r + 1] * scale;
      const float v0v = dva[4 * i + 2 * r], v1v = dva[4 * i + 2 * r + 1];
      if (pairs) {
        if (c < dm.D) {
          *reinterpret_cast<uint32_t*>(krow + c) = pack_bf16(k0v, k1v);
          *reinterpret_cast<uint32_t*>(vrow + c) = pack_bf16(v0v, v1v);
        }
      } else {
        if (c < dm.D) {
          krow[c] = __float2bfloat16(k0v);
          vrow[c] = __float2bfloat16(v0v);
        }
        if (c + 1 < dm.D) {
          krow[c + 1] = __float2bfloat16(k1v);
          vrow[c + 1] = __float2bfloat16(v1v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DP> struct Tile { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

template <int DP>
constexpr size_t fwd_smem() {
  constexpr int BQ = Tile<DP>::BQ, BK = Tile<DP>::BK;
  return sizeof(float) * (BQ * (DP + 1) + DP * (BK + 1) + BK * DP + BQ * (BK + 1));
}
template <int DP>
constexpr size_t dq_smem() {
  constexpr int BQ = Tile<DP>::BQ, BK = Tile<DP>::BK;
  return sizeof(float) * (2 * BQ * (DP + 1) + 2 * DP * (BK + 1) + BQ * (BK + 1) + 2 * BQ);
}
template <int DP>
constexpr size_t dkv_smem() {
  constexpr int BQ = Tile<DP>::BQ, BK = Tile<DP>::BK;
  return sizeof(float) * (2 * BK * (DP + 1) + 2 * DP * (BQ + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

enum class Pass { kFwd, kDq, kDkv };

// dq_fp32_kernel: Q and dO, a ring of two K, V stages (rows padded to
// DP + 4) and the row statistics; dkv_fp32_kernel: K and V, a ring of two
// kDkvRows<DP>-row Q, dO stages (padded), P^T and dS^T ([64][kDkvRows + 4])
// and the ring's row statistics
template <int DP>
constexpr size_t ring_smem(Pass pass) {
  return sizeof(float) * (pass == Pass::kDq
                              ? 2 * 64 * DP + 4 * 64 * (DP + 4) + 2 * 64
                              : 2 * 64 * DP + 4 * kDkvRows<DP> * (DP + 4) +
                                    2 * 64 * (kDkvRows<DP> + 4) + 4 * kDkvRows<DP>);
}

// fwd_fp32_kernel: Q, a ring of two K, V stages (rows padded to DP + 4)
// and P ([64][64 + 4])
template <int DP>
constexpr size_t fwd_ring_smem() {
  return sizeof(float) * (64 * DP + 4 * 64 * (DP + 4) + 64 * (64 + 4));
}

// fp32 up to DP = 128 takes fwd_fp32_kernel, dq_fp32_kernel and
// dkv_fp32_kernel, fp32 at DP = 256 the one-tile kernels; bf16 takes
// fwd_mma_kernel (kMma), dq_mma_kernel and dkv_mma_kernel (kMmaBwd) at
// every DP
template <typename T, int DP>
constexpr bool kRing = std::is_same<T, float>::value && DP <= 128;
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
template <typename T>
constexpr bool kMmaBwd = std::is_same<T, __nv_bfloat16>::value;

template <int DP, bool MASK>
cudaError_t launch_fwd_mma(const Args& a, cudaStream_t s) {
  using TL = MmaTile<DP, MASK>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(fwd_mma_kernel<DP, MASK>, TL::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int nq = (a.dm.Sq + TL::BQ - 1) / TL::BQ;
  fwd_mma_kernel<DP, MASK><<<dim3(nq, a.dm.B * a.dm.Hq), TL::THREADS, TL::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out),
      a.lse_out, a.dm, a.scale, a.causal, a.dr, a.mk);
  return cudaGetLastError();
}

template <int DP, bool MASK>
cudaError_t launch_dq_mma(const Args& a, cudaStream_t s) {
  using TL = DqTile<DP, MASK>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(dq_mma_kernel<DP, MASK>, TL::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int nq = (a.dm.Sq + TL::BQ - 1) / TL::BQ;
  dq_mma_kernel<DP, MASK><<<dim3(nq, a.dm.B * a.dm.Hq), TL::THREADS, TL::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      a.lse, a.delta, static_cast<__nv_bfloat16*>(a.out), a.dm, a.scale, a.causal, a.dr,
      a.mk);
  return cudaGetLastError();
}

template <int DP, bool MASK>
cudaError_t launch_dkv_mma(const Args& a, cudaStream_t s) {
  using TL = DkvTile<DP, MASK>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(dkv_mma_kernel<DP, MASK>, TL::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int nk = (a.dm.Sk + TL::BK - 1) / TL::BK;
  dkv_mma_kernel<DP, MASK><<<dim3(nk, a.dm.B * a.dm.Hk), TL::THREADS, TL::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.dm, a.scale, a.causal, a.dr, a.mk);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_pass(Pass pass, const Args& a, cudaStream_t s) {
  const bool mask = a.mk.bias || a.mk.qseg || a.mk.dbias;
  if constexpr (kMma<T>) {
    if (pass == Pass::kFwd)
      return mask ? launch_fwd_mma<DP, true>(a, s) : launch_fwd_mma<DP, false>(a, s);
  }
  if constexpr (kMmaBwd<T>) {
    if (pass == Pass::kDq)
      return mask ? launch_dq_mma<DP, true>(a, s) : launch_dq_mma<DP, false>(a, s);
    if (pass == Pass::kDkv)
      return mask ? launch_dkv_mma<DP, true>(a, s) : launch_dkv_mma<DP, false>(a, s);
  }
  if constexpr (kMma<T> && kMmaBwd<T>) {
    return cudaErrorInvalidValue;  // every bf16 pass returned above
  } else {
    constexpr int BQ = Tile<DP>::BQ, BK = Tile<DP>::BK;
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    const int nq = (a.dm.Sq + BQ - 1) / BQ, nk = (a.dm.Sk + BK - 1) / BK;
    // per (T, DP): by pass, without and with the Mask
    static bool smem_set[3][2] = {};
    cudaError_t err;
    if (pass == Pass::kFwd) {
      if constexpr (kRing<T, DP>) {
        constexpr size_t smem = fwd_ring_smem<DP>();
        auto kern = mask ? fwd_fp32_kernel<DP, true> : fwd_fp32_kernel<DP, false>;
        if ((err = allow_smem(kern, smem, smem_set[0][mask])) != cudaSuccess) return err;
        kern<<<dim3(nq, a.dm.B * a.dm.Hq), kThreads, smem, s>>>(
            q, k, v, static_cast<T*>(a.out), a.lse_out, a.dm, a.scale, a.causal, a.dr, a.mk);
      } else if constexpr (!kMma<T>) {
        constexpr size_t smem = fwd_smem<DP>();
        auto kern = mask ? fwd_kernel<T, DP, BQ, BK, true> : fwd_kernel<T, DP, BQ, BK, false>;
        if ((err = allow_smem(kern, smem, smem_set[0][mask])) != cudaSuccess) return err;
        kern<<<dim3(nq, a.dm.B * a.dm.Hq), kThreads, smem, s>>>(
            q, k, v, static_cast<T*>(a.out), a.lse_out, a.dm, a.scale, a.causal, a.dr, a.mk);
      }
    } else if constexpr (kRing<T, DP>) {
      if (pass == Pass::kDq) {
        constexpr size_t smem = ring_smem<DP>(Pass::kDq);
        auto kern = mask ? dq_fp32_kernel<DP, true> : dq_fp32_kernel<DP, false>;
        if ((err = allow_smem(kern, smem, smem_set[1][mask])) != cudaSuccess) return err;
        kern<<<dim3(nq, a.dm.B * a.dm.Hq), kThreads, smem, s>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.out), a.dm, a.scale, a.causal,
            a.dr, a.mk);
      } else {
        constexpr size_t smem = ring_smem<DP>(Pass::kDkv);
        auto kern = mask ? dkv_fp32_kernel<DP, true> : dkv_fp32_kernel<DP, false>;
        if ((err = allow_smem(kern, smem, smem_set[2][mask])) != cudaSuccess) return err;
        kern<<<dim3(nk, a.dm.B * a.dm.Hk), kThreads, smem, s>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
            a.dm, a.scale, a.causal, a.dr, a.mk);
      }
    } else if constexpr (!kMmaBwd<T>) {
      if (pass == Pass::kDq) {
        constexpr size_t smem = dq_smem<DP>();
        auto kern = mask ? dq_kernel<T, DP, BQ, BK, true> : dq_kernel<T, DP, BQ, BK, false>;
        if ((err = allow_smem(kern, smem, smem_set[1][mask])) != cudaSuccess) return err;
        kern<<<dim3(nq, a.dm.B * a.dm.Hq), kThreads, smem, s>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.out), a.dm, a.scale, a.causal,
            a.dr, a.mk);
      } else {
        constexpr size_t smem = dkv_smem<DP>();
        auto kern = mask ? dkv_kernel<T, DP, BQ, BK, true> : dkv_kernel<T, DP, BQ, BK, false>;
        if ((err = allow_smem(kern, smem, smem_set[2][mask])) != cudaSuccess) return err;
        kern<<<dim3(nk, a.dm.B * a.dm.Hk), kThreads, smem, s>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
            a.dm, a.scale, a.causal, a.dr, a.mk);
      }
    }
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_typed(Pass pass, const Args& a, cudaStream_t s) {
  if (a.dm.D <= 64) return launch_pass<T, 64>(pass, a, s);
  if (a.dm.D <= 128) return launch_pass<T, 128>(pass, a, s);
  return launch_pass<T, 256>(pass, a, s);
}

int run(Pass pass, Args a, int dtype, void* stream) {
  const Dims& d = a.dm;
  if (d.B <= 0 || d.Sq <= 0 || d.Sk <= 0) return 0;
  if (d.Hq <= 0 || d.Hk <= 0 || d.Hq % d.Hk != 0 || d.D < 1 || d.D > 256 ||
      static_cast<long long>(d.B) * d.Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == ptk::kFloat32
                              ? launch_typed<float>(pass, a, s)
                              : launch_typed<__nv_bfloat16>(pass, a, s);
  return static_cast<int>(err);
}

}  // namespace

// Each entry launches on `stream` without synchronising and returns the
// launch's CUDA error code (0 on success). Tensors as in the header
// comment; `seed` is a device pointer to one int32 (NULL without dropout);
// `bias` (NULL: none) with its four element strides, and `qseg` / `kseg`
// (NULL: none) with `seg_causal`, as Mask in flash_common.cuh; `dbias`
// (dq only; NULL: not emitted) a zeroed fp32 [B, Hq, Sq, Sk].
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Sq, int Sk, int Hq,
                         int Hk, int D, float scale, int causal, int drop_on,
                         int thresh, float keep_scale, const void* seed,
                         PTK_MASK_PARAMS, int dtype, void* stream) {
  Args a = make_args(q, k, v, B, Sq, Sk, Hq, Hk, D, scale, causal, drop_on,
                     thresh, keep_scale, seed, PTK_MASK_ARGS);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return run(Pass::kFwd, a, dtype, stream);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int Sq, int Sk, int Hq, int Hk,
                        int D, float scale, int causal, int drop_on,
                        int thresh, float keep_scale, const void* seed,
                        PTK_MASK_PARAMS, void* dbias, int dtype,
                        void* stream) {
  Args a = make_args(q, k, v, B, Sq, Sk, Hq, Hk, D, scale, causal, drop_on,
                     thresh, keep_scale, seed, PTK_MASK_ARGS);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  a.mk.dbias = static_cast<float*>(dbias);
  return run(Pass::kDq, a, dtype, stream);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B,
                         int Sq, int Sk, int Hq, int Hk, int D, float scale,
                         int causal, int drop_on, int thresh,
                         float keep_scale, const void* seed,
                         PTK_MASK_PARAMS, int dtype, void* stream) {
  Args a = make_args(q, k, v, B, Sq, Sk, Hq, Hk, D, scale, causal, drop_on,
                     thresh, keep_scale, seed, PTK_MASK_ARGS);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return run(Pass::kDkv, a, dtype, stream);
}
