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
// Design (simple and right, not yet fast): 256 threads as a 16 x 16 grid;
// each thread owns a (BQ/16) x (BK/16) patch of the score tile and a
// (rows/16) x (D/16) patch of the output or gradient tile. Tiles of Q, K,
// V, dO and of P / dS live in shared memory as fp32 (bf16 converted on
// load, exact), padded by one word per row so the strided reads do not
// collide on banks; the products are FMA loops over shared memory
// (CUDA cores, not tensor cores). D is zero-padded to DP = 64, 128 or 256.
// Row max and row sums are shuffles across the 16 threads of a row.
// bf16 calls with head dims up to 128 take the tensor-core forward, dq
// and dkv of flash_attention_sm90.cu instead (`flash_route`); these
// kernels serve fp32, wider heads and strides TMA cannot take. Both
// sources share the dropout hash of flash_common.cuh.
#include "common.cuh"
#include "flash_common.cuh"

#include <math.h>

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

template <typename T, int DP>
cudaError_t launch_pass(Pass pass, const Args& a, cudaStream_t s) {
  constexpr int BQ = Tile<DP>::BQ, BK = Tile<DP>::BK;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int nq = (a.dm.Sq + BQ - 1) / BQ, nk = (a.dm.Sk + BK - 1) / BK;
  // per (T, DP): by pass, without and with the Mask
  static bool smem_set[3][2] = {};
  const bool mask = a.mk.bias || a.mk.qseg || a.mk.dbias;
  cudaError_t err;
  if (pass == Pass::kFwd) {
    constexpr size_t smem = fwd_smem<DP>();
    auto kern = mask ? fwd_kernel<T, DP, BQ, BK, true> : fwd_kernel<T, DP, BQ, BK, false>;
    if ((err = allow_smem(kern, smem, smem_set[0][mask])) != cudaSuccess) return err;
    kern<<<dim3(nq, a.dm.B * a.dm.Hq), kThreads, smem, s>>>(
        q, k, v, static_cast<T*>(a.out), a.lse_out, a.dm, a.scale, a.causal, a.dr, a.mk);
  } else if (pass == Pass::kDq) {
    constexpr size_t smem = dq_smem<DP>();
    auto kern = mask ? dq_kernel<T, DP, BQ, BK, true> : dq_kernel<T, DP, BQ, BK, false>;
    if ((err = allow_smem(kern, smem, smem_set[1][mask])) != cudaSuccess) return err;
    kern<<<dim3(nq, a.dm.B * a.dm.Hq), kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.out), a.dm, a.scale, a.causal, a.dr,
        a.mk);
  } else {
    constexpr size_t smem = dkv_smem<DP>();
    auto kern = mask ? dkv_kernel<T, DP, BQ, BK, true> : dkv_kernel<T, DP, BQ, BK, false>;
    if ((err = allow_smem(kern, smem, smem_set[2][mask])) != cudaSuccess) return err;
    kern<<<dim3(nk, a.dm.B * a.dm.Hk), kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dm,
        a.scale, a.causal, a.dr, a.mk);
  }
  return cudaGetLastError();
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
