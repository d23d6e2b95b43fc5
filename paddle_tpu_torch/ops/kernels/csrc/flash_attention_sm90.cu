// Flash attention forward, dq and dk/dv on Hopper's tensor cores
// (sm_90a): warpgroup MMA (wgmma) fed by TMA through mbarrier rings.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_fwd`), `_dq_kernel` and `_dkv_kernel` (launched by
// `_bwd_impl`) for bf16 operands; `flash_attention.cu` keeps fp32, head
// dims above 128 and strides TMA cannot take. The contract is that file's
// (its header comment), unchanged:
//   q, dO, out: [B, Sq, Hq, D];  k, v, dk, dv: [B, Sk, Hk, D], read in
//   place; lse, delta: [B*Hq, Sq] fp32; GQA by h / (Hq/Hk) without
//   expanding K/V; causal keeps key j for query i iff j <= i + (Sk - Sq);
//   s = scale * (q . k) in fp32; p rounded to bf16 before P.V (and before
//   P^T.dO), ds before its products with K and Q; rows that see no key give
//   out = 0 and lse = -inf; dropout by the murmur3 hash of `_keep_block` /
//   `_mix_seed`, bit for bit, with lse from the undropped p.
// Here additionally: bf16 only, D a multiple of 8 up to 128 (zero-filled
// by TMA to DP = 64 or 128), 16-byte aligned operands.
// The additive bias, the segment words and the dq pass's dbias output
// (flash_common.cuh, Mask) are template arguments of every kernel (BIAS,
// SEG; dq's BIAS = 2 also emits dbias), so the instantiations without them
// keep their registers and wgmma waits. The bias joins in natural units,
// (s scale + b) log2(e) in the forward's exp2 domain, and as
// exp(fl(fl(s scale) + b) - lse) in the backward, the plain version's order.
// Every pass knows two bias classes, chosen on the host
// (`flash_bias_class`):
// - "keys", a bias that does not vary along queries (query stride 0 or
//   Sq = 1: every padding mask, [B,1,1,Sk] as BERT's): dkv holds the bias
//   of its thread's two keys in two registers, read once per q head (once
//   per CTA when the heads share it); in dq and the forward a producer
//   warp copies each K stage's 64 (128) key biases into the stage,
//   arriving on its full barrier, in the order the consumers read them
//   (keys_slot, fwd_keys_slot), and a consumer loads its 16 (32) per tile
//   as 4 (8) x 16 bytes (the forward's second four halfway through its
//   scale pass). Past Sk dq's stage holds 0, the forward's -inf, which
//   masks the ragged key edge in place of a compare per element. No
//   per-element global load, no guard in the loop. These instantiations
//   read shared memory by ld.shared (the stage's pointers, built from an
//   aligned integer, would take generic loads: a tenth of dq's time). In
//   dq, and in dkv at D = 64, the two consumer warpgroups take turns
//   issuing S and dP (named barriers 1 and 2, FlashAttention-3's
//   ping-pong), so one's elementwise pass runs beside the other's
//   products; dq takes them bias-free too at D = 128. In the forwards the
//   same turns measured slower on an H100 (1-4 % in this kernel, 3-5 % on
//   top of the bias-free forward's overlap), so neither has them.
// - "plane", every other bias, and any bias with segments or dbias. Simple,
//   not fast: each consumer thread reads the bias and the segment words of
//   its accumulator elements with plain global loads at their (row, col),
//   guarded to row < Sq and key < Sk, on every tile (TMA zero-fills only
//   the tiles); with segments every tile is masked element by element.
// Both classes add the same value in the same order, so they give the
// same bits (a row past Sq, never stored, may differ).
//
// What bounds it: at GPT-2's training shape (B*H = 96, S = 1024, D = 64,
// causal) the forward does 12.9 GFLOP on 50 MB (13 us at 989 TFLOP/s,
// 15 us at 3.35 TB/s); dq and dkv do 1.5x and twice the flops on about
// the same bytes, so they are bound by operations (20 and 26 us).
//
// Design (FlashAttention-3's split; its intra-warpgroup overlap in the
// bias-free forward; its ping-pong scheduling in dq's "keys" and D = 128
// instantiations and in dkv's "keys" ones at D = 64): 384 threads = three
// warpgroups.
// Warpgroup 0 is the producer: it gives up registers (setmaxnreg 24) and
// one thread keeps TMA loads in flight through a ring of stages (two;
// three in dkv at D = 128 and in the bias-free forward; four in dq), each
// with a "full" barrier (TMA
// bytes) and an "empty" barrier (256 consumer arrivals).
// Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 rows each; the
// role index comes from lane 0 (warp-uniform) in dq and dkv.
// ptxas allocates the consumers above the launch's 168 registers for
// values it spills otherwise, but it keeps wgmma accumulators and A
// fragments, with what else is live across a wgmma, to about that count:
// more, and it serialises every wgmma of the kernel (C7512) and spills.
// Each wgmma kernel is laid out to stay under it (the build phase of
// chip_smoke.py reports HGMMAs and waits per instantiation).
//
// forward with a bias or segments (fwd_sm90_kernel): grid (q tiles of
//   128, B*Hq), long causal rows first. Q is loaded once; K and V tiles of
//   128 keys stream. Per tile: S = Q.K^T by
//   SS wgmma m64n128k16; masks only on tiles the diagonal or an edge
//   cuts; online softmax in registers in the exp2 domain (log2(e) folded
//   into the scale), row max and sum by shuffles over the 4 lanes sharing
//   a row; dropout from each accumulator element's (row, col); P packed to
//   bf16 in registers as the A operand of O += P.V (RS wgmma, V MN-major).
//   Epilogue: O / l to bf16 straight from registers (rows past Sq not
//   stored), lse = m ln 2 + log l.
// forward without either (fwd_overlap_sm90_kernel: every train cell's
//   attention but BERT's): FlashAttention-3's intra-warpgroup overlap. Per
//   tile j a consumer issues S_j, rescales O, issues O += P_{j-1}.V_{j-1}
//   behind it, waits for S_j alone and runs the softmax of j (row max as
//   a tree, one FFMA and one ex2.approx.ftz per element, row sums,
//   dropout) while P.V runs, then waits for P.V and packs P_j; the
//   rescale still precedes each tile's P.V. Live in wgmma operands: O,
//   S_j and P_{j-1}, so tiles hold 64 keys (64 + 32 + 16 registers at
//   D = 128; 128 keys serialised every wgmma and spilled). A warpgroup's
//   loop ends at its last row's diagonal tile, so only that 64 x 64 block
//   and the key edge are compared element by element, and the CUT and
//   dropout choices are made once per tile, outside the element loop. K
//   and V have empty barriers of their own (a K stage is free once S is
//   done) over three stages. CTAs run in groups of 16 heads, each head's
//   longest q tile first: K and V stay in L2 and the tail is short.
//   Measured slower on an H100 and not kept: the warpgroups' ping-pong on
//   top (3-5 %), 128-key tiles at D = 64 (they spill). What bounds it:
//   without its softmax it ran at 64 % of the tensor peak at the Llama
//   cell's shape; the softmax, overlapped by P.V alone, adds half again.
// dkv at D = 64: grid (k tiles of 128, B*Hk); each consumer owns 64 keys
//   with dK and dV in fp32 registers. K and V are loaded once; Q and dO
//   tiles of 64 rows stream over the group's rep q heads from the causal
//   start, and a producer warp copies lse (+inf past Sq, so p = 0 there)
//   and delta into the same stage. Per tile: S^T = K.Q^T and
//   dP^T = V.dO^T (SS, one group); P^T = exp(S^T scale - lse) masked (the
//   plain version's rounding, not exp2: p is rounded to bf16 next) and
//   dropped; dS^T = P^T (dP^T_dropped - delta); dV += P^T.dO and
//   dK += dS^T.Q (RS, B MN-major). Dropout is a template argument of dkv
//   and dq: in dkv that took a fifth off its time (fewer registers live);
//   it slowed the forward. Measured slower and not kept: issuing dV's
//   product while dS^T is formed. Epilogue: dK x scale and dV to bf16,
//   rows past Sk not stored.
// dkv at D = 128 (dkv128_sm90_kernel): dK and dV of 64 keys are 128 fp32
//   registers a thread, and with S^T and dP^T in flight ptxas serialised
//   all 24 wgmmas and spilled (1.02 ms at the Llama cell's shape on an
//   H100 80GB HBM3 at 700 W). So a CTA owns 64 keys and the two
//   consumers split the accumulators: warpgroup 1 issues S^T = K.Q^T (SS), forms p, hands it to warpgroup 2
//   in fp32 through shared memory (two buffers, named barriers 1-4) and
//   accumulates dV += P^T.dO (RS); warpgroup 2 issues dP^T = V.dO^T, forms
//   dS^T from the p it receives and accumulates dK += dS^T.Q (RS). Each
//   holds 64 + 32 + 16 registers in wgmma operands, so nothing is
//   serialised or spilled. Each waits for its previous RS product only
//   once its next SS one is issued, then releases that product's stage;
//   three stages. Q and dO stream once per 64 keys instead of 128 (twice
//   the L2 reads). Measured slower on the same card and not kept: P^T
//   and dS^T through shared memory for SS products, K and V as register
//   A fragments for S^T and dP^T, and issuing the next S^T before p is
//   formed (144 registers: serialised).
// dq: grid (q tiles of 128, B*Hq), long causal rows first, as the
//   forward. Q and dO are loaded once; K and V tiles of 64 keys stream
//   through four stages (registers, not shared memory, bound the tile:
//   see DqTile). Each consumer reads the lse and delta of its two rows
//   once from global memory. Per tile: S = Q.K^T and dP = dO.V^T (SS, the
//   forward's descriptors); p = exp(s scale - lse) in the plain version's
//   rounding, masked past the diagonal and at keys >= Sk (zero-filled by
//   TMA: unlike dkv, no padded lse zeroes them); dropout on dP;
//   dS = p (dP - delta) packed to bf16 A fragments; dQ += dS.K (RS, K
//   MN-major). A warpgroup skips the tiles none of its rows sees (at
//   D = 128 they end the CTA's range: its loop stops at its last tile and
//   passes the rest through after it; at D = 64 that split measured
//   slower). Epilogue: dQ x scale to bf16, rows past Sq not stored.
#include "common.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"

#include <math.h>

#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace hop;
using namespace ptk;

constexpr int kThreads = 384;          // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// segment words of rows past Sq and keys past Sk: their ids (>> 16) are
// negative and differ, so they see nothing (the reference's padding words)
constexpr int kNoQuery = -(1 << 20);
constexpr int kNoKey = -(2 << 20);

__device__ __forceinline__ int seg_word(const int* seg, int b, int n, int i,
                                        int none) {
  return i < n ? seg[static_cast<size_t>(b) * n + i] : none;
}

// The bias row of (batch b, head h, query row): bias_at(mk, b, h, row, c)
// is row_ptr[c * sk]; NULL for a row past Sq (its bias reads as 0).
__device__ __forceinline__ const float* bias_row(const Mask& mk, const Dims& dm,
                                                 int b, int h, int row) {
  return row < dm.Sq ? mk.bias + b * mk.sb + h * mk.sh + row * mk.sq : nullptr;
}

// The "keys" bias class: the bias of (batch b, q head h, key), the same
// for every query; 0 for a key past Sk.
__device__ __forceinline__ float key_bias(const Mask& mk, const Dims& dm, int b,
                                          int h, int key) {
  return key < dm.Sk ? mk.bias[b * mk.sb + h * mk.sh + key * mk.sk] : 0.f;
}

// dq's stage of key biases: key j of the tile (column frag_col(l, i, e) =
// 8 i + 2 (l & 3) + e) at the slot that puts each thread's 16 biases in a
// row, by l & 3, then i, then e: 4 x 16 bytes per thread and tile.
__device__ __forceinline__ int keys_slot(int j) {
  return 16 * ((j & 7) >> 1) + 2 * (j >> 3) + (j & 1);
}

// The forward's stage of 128 key biases: key j (column 8 i + 2 (l & 3) + e)
// at the slot that puts float4 i >> 1 of column group l & 3 at 4 (i >> 1) +
// (l & 3), element 2 (i & 1) + e, so the four groups of a warp read 64
// neighbouring bytes per ld.shared.v4 (by thread, the groups would sit 128
// bytes apart: one bank, four ways).
__device__ __forceinline__ int fwd_keys_slot(int j) {
  return 16 * (j >> 4) + 4 * ((j & 7) >> 1) + 2 * ((j >> 3) & 1) + (j & 1);
}

// Key tiles of BK a forward q tile from q0 visits: tiles past its last
// row's causal diagonal are dead.
template <int BQ, int BK>
__device__ __forceinline__ int fwd_key_tiles(const Dims& dm, int q0, int causal) {
  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + dm.Sk - dm.Sq;
    nk = last < 0 ? 0 : min(nk, last / BK + 1);
  }
  return nk;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Accumulator element j of n-block i of thread (w, l): row and column
// inside the warpgroup's 64-row tile (hopper.cuh).
__device__ __forceinline__ int frag_row(int w, int l, int j) {
  return 16 * w + (l >> 2) + 8 * (j >> 1);
}
__device__ __forceinline__ int frag_col(int l, int i, int j) {
  return 8 * i + 2 * (l & 3) + (j & 1);
}

template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int kk = 0; kk < R; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

// Store a 64 x DP accumulator of this warpgroup as bf16 rows of a
// [.., S, H, D] tensor: `base` = &t[b, 0, h, 0], `stride` = H * D, rows
// from `row0`, at most `rows` of them, columns below D. Columns come in
// pairs and D is a multiple of 8, so each pair is one 4-byte store.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride,
                                           const float (&acc)[DP / 2],
                                           int row0, int rows, int D,
                                           float mul0, float mul1, int w,
                                           int l) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + frag_row(w, l, 2 * half);
    if (r >= rows) continue;
    const float mul = half ? mul1 : mul0;
    bf16* p = base + static_cast<size_t>(r) * stride;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = frag_col(l, i, 0);
      if (c < D)
        *reinterpret_cast<uint32_t*>(p + c) =
            pack_bf16(acc[4 * i + 2 * half] * mul, acc[4 * i + 2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: grid (nq, B*Hq)
// ---------------------------------------------------------------------------

template <int DP>
struct FwdTile {
  static constexpr int BQ = 128, BK = 128, STAGES = 2, CH = DP / 64;
  static constexpr int Q_CHUNK = BQ * 128;          // bytes of one 64-col chunk
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = CH * Q_CHUNK;
  static constexpr int KV_BYTES = CH * KV_CHUNK;    // K or V, one stage
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 128;
  static constexpr int KEY_BIAS_BYTES = STAGES * BK * 4;   // "keys" class only
};

// BIAS: 0 none, 1 bias ("plane" class), 2 bias of the "keys" class
template <int DP, int BIAS, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                float* __restrict__ lse, Dims dm, float scale_log2,
                int causal, Dropout dr, float scale, Mask mk) {
  using T = FwdTile<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + T::Q_BYTES;                     // [ST] x KV_BYTES
  uint8_t* Vs = Ks + ST * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;                     // [ST]
  uint64_t* v_full = k_full + ST;                    // [ST]
  uint64_t* kv_empty = v_full + ST;                  // [ST]
  // "keys": each K stage's 128 key biases, past the barriers' 128 bytes
  [[maybe_unused]] float* kbias =
      reinterpret_cast<float*>(Vs + ST * T::KV_BYTES + 128);   // [ST][BK]

  const int nq = (dm.Sq + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);  // long rows first
  const int bh = blockIdx.y;
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int q0 = qi * BQ;
  const int offset = dm.Sk - dm.Sq;
  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + offset;       // tiles past it are dead
    nk = last < 0 ? 0 : min(nk, last / BK + 1);
  }
  // under "keys" each role counts its tiles itself: one count live in
  // every role spilled at DP = 128
  auto key_tiles = [&]() {
    return BIAS == 2 ? fwd_key_tiles<BQ, BK>(dm, q0, causal) : nk;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      // "keys": the TMA thread + the key-bias warp
      mbar_init(k_full + s, BIAS == 2 ? 1 + 32 : 1);
      mbar_init(v_full + s, 1);
      mbar_init(kv_empty + s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 drives TMA; under "keys" warp 1 copies each
    // K stage's key biases (-inf past Sk) into the stage ----
    reg_dealloc<kProducerRegs>();
    if (BIAS == 2 && threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x & 31;
      const int n_tiles = key_tiles();
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % ST;
        mbar_wait(kv_empty + s, ((kt / ST) & 1) ^ 1);
#pragma unroll
        for (int rr = 0; rr < BK / 32; ++rr) {
          const int key = kt * BK + lane + 32 * rr;
          kbias[s * BK + fwd_keys_slot(lane + 32 * rr)] =
              key < dm.Sk ? key_bias(mk, dm, b, h, key) : -INFINITY;
        }
        mbar_arrive(k_full + s);
      }
    } else if (threadIdx.x == 0) {
      const int n_tiles = key_tiles();
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::CH; ++c)
        tma_load_4d(Qs + c * T::Q_CHUNK, &tq, q_full, 64 * c, h, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % ST;
        mbar_wait(kv_empty + s, ((kt / ST) & 1) ^ 1);
        uint8_t* kd = Ks + s * T::KV_BYTES;
        uint8_t* vd = Vs + s * T::KV_BYTES;
        mbar_expect_tx(k_full + s, T::KV_BYTES);
        for (int c = 0; c < T::CH; ++c)
          tma_load_4d(kd + c * T::KV_CHUNK, &tk, k_full + s, 64 * c, hk, kt * BK, b);
        mbar_expect_tx(v_full + s, T::KV_BYTES);
        for (int c = 0; c < T::CH; ++c)
          tma_load_4d(vd + c * T::KV_CHUNK, &tv, v_full + s, 64 * c, hk, kt * BK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int w = t >> 5, l = t & 31;
    const int row_base = q0 + 64 * cw;               // first row of this warpgroup
    const uint32_t seed_bh =
        dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
    [[maybe_unused]] int qw[2] = {0, 0};             // segment words of the two rows
    if constexpr (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        qw[r] = seg_word(mk.qseg, b, dm.Sq, row_base + frag_row(w, l, 2 * r), kNoQuery);
    }
    [[maybe_unused]] const float* brow[2] = {nullptr, nullptr};   // bias rows
    [[maybe_unused]] const int bsk = static_cast<int>(mk.sk);     // 0 or 1
    if constexpr (BIAS == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        brow[r] = bias_row(mk, dm, b, h, row_base + frag_row(w, l, 2 * r));
    }

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float lsum[2] = {0.f, 0.f};                      // this thread's share
    const uint32_t q_addr = smem_u32(Qs) + 64 * cw * 128;

    const int n_tiles = key_tiles();
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % ST;
      const uint32_t par = (kt / ST) & 1;
      const int k0 = kt * BK;
      const uint32_t k_addr = smem_u32(Ks + s * T::KV_BYTES);
      const uint32_t v_addr = smem_u32(Vs + s * T::KV_BYTES);

      // S = Q K^T (fp32, 64 x BK)
      float sc[BK / 2];
      mbar_wait(k_full + s, par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        const uint64_t da = desc_sw128(q_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024);
        const uint64_t db = desc_sw128(k_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024);
        wgmma_ss<BK, 0>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      // "keys": this thread's 32 key biases of the tile as 8 x 16 bytes by
      // ld.shared, four while S runs and four halfway through the scale
      // pass (all eight up front spill at DP = 128)
      [[maybe_unused]] float4 kb4[BK / 16];
      [[maybe_unused]] const uint32_t kb_addr =
          BIAS == 2 ? smem_u32(kbias + s * BK) + 16 * (l & 3) : 0u;
      if constexpr (BIAS == 2) {
#pragma unroll
        for (int f = 0; f < BK / 32; ++f) kb4[f] = lds_f4(kb_addr + 64 * f);
      }
      wgmma_wait<0>();
      fence_regs(sc);

      // scale (and add the bias) into the exp2 domain; mask where the
      // diagonal or an edge cuts, and everywhere under segments. Under
      // "keys" the key edge is in the bias (-inf past Sk), and log2(e)
      // joins at the max and in exp2 below: rounding is monotone, so the
      // max of fl(y log2 e) is fl(max(y) log2 e), the "plane" class's bits
      constexpr bool EDGE = BIAS != 2;
      const bool cut = SEG || (EDGE && k0 + BK > dm.Sk) ||
                       (causal && k0 + BK - 1 > row_base + offset);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        // "keys": the two key biases of this column pair
        [[maybe_unused]] float2 kb = make_float2(0.f, 0.f);
        if constexpr (BIAS == 2) {
          if (i == BK / 16) {
#pragma unroll
            for (int f = BK / 32; f < BK / 16; ++f) kb4[f] = lds_f4(kb_addr + 64 * f);
          }
          kb = (i & 1) ? make_float2(kb4[i >> 1].z, kb4[i >> 1].w)
                       : make_float2(kb4[i >> 1].x, kb4[i >> 1].y);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x;
          if constexpr (BIAS == 1) {
            const int c = k0 + frag_col(l, i, j);
            const float* br = brow[j >> 1];
            const float bv = br && c < dm.Sk ? br[c * bsk] : 0.f;
            x = __fmul_rn(__fadd_rn(__fmul_rn(sc[4 * i + j], scale), bv), kLog2e);
          } else if constexpr (BIAS == 2) {
            x = __fadd_rn(__fmul_rn(sc[4 * i + j], scale), (j & 1) ? kb.y : kb.x);
          } else {
            x = sc[4 * i + j] * scale_log2;
          }
          if (cut) {
            const int c = k0 + frag_col(l, i, j);
            const int r = row_base + frag_row(w, l, j);
            bool dead = (EDGE && c >= dm.Sk) || (causal && c > r + offset);
            if constexpr (SEG)
              dead = dead || !seg_sees(qw[j >> 1], seg_word(mk.kseg, b, dm.Sk, c, kNoKey),
                                       mk.seg_causal);
            if (dead) x = -INFINITY;
          }
          sc[4 * i + j] = x;
        }
      }

      // online softmax over the two rows this thread holds
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], sc[4 * i + j]);
      float m_safe[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mt = quad_max(mx[r]);
        const float m_new = fmaxf(m[r], BIAS == 2 ? __fmul_rn(mt, kLog2e) : mt);
        m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_safe[r]);          // 0 while m was -inf
        m[r] = m_new;
      }
      // p, its row sums, and P (dropped) rounded to bf16 as A fragments of
      // O += P V
      float rs[2] = {0.f, 0.f};
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        float pv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = BIAS == 2 ? __fmul_rn(sc[4 * i + j], kLog2e) : sc[4 * i + j];
          const float p = exp2f(x - m_safe[j >> 1]);
          rs[j >> 1] += p;
          pv[j] = p;
          if (dr.on)
            pv[j] = keep(seed_bh, row_base + frag_row(w, l, j),
                         k0 + frag_col(l, i, j), dm.Sk, dr.thresh)
                        ? p * dr.keep_scale
                        : 0.f;
        }
        pa[i >> 1][2 * (i & 1)] = pack_bf16(pv[0], pv[1]);
        pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(pv[2], pv[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) lsum[r] = alpha[r] * lsum[r] + rs[r];
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[4 * i + j] *= alpha[j >> 1];

      // O += P V (V MN-major)
      mbar_wait(v_full + s, par);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP, 1>(o, pa[kk], desc_sw128(v_addr + kk * 2048, T::KV_CHUNK, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_frags(pa);
      mbar_arrive(kv_empty + s);
    }

    // epilogue
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float L = quad_sum(lsum[r]);
      inv[r] = L > 0.f ? 1.f / L : 0.f;
      const int row = row_base + frag_row(w, l, 2 * r);
      if ((l & 3) == 0 && row < dm.Sq)
        lse[static_cast<size_t>(bh) * dm.Sq + row] =
            L > 0.f ? m[r] * kLn2 + logf(L) : -INFINITY;
    }
    const size_t stride = static_cast<size_t>(dm.Hq) * dm.D;
    bf16* ob = out + (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
    store_rows<DP>(ob, stride, o, row_base, dm.Sq, dm.D, inv[0], inv[1], w, l);
  }
}

// ---------------------------------------------------------------------------
// forward without bias or segments: grid (nq, B*Hq), CTAs in head groups
// ---------------------------------------------------------------------------

// Tiles of 64 keys: O, S, P and the wgmma operands in flight stay inside
// the registers ptxas keeps for them at DP = 128 (64 + 32 + 16; tiles of
// 128 keys need 64 + 64 + 32 and serialised every wgmma).
template <int DP>
struct FwdOvTile {
  static constexpr int BQ = 128, BK = 64, STAGES = 3, CH = DP / 64;
  static constexpr int Q_CHUNK = BQ * 128;          // bytes of one 64-col chunk
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = CH * Q_CHUNK;
  static constexpr int KV_BYTES = CH * KV_CHUNK;    // K or V, one stage
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 128;
  // heads whose q tiles run longest first, before the next group's: their
  // K and V stay in L2 (16 heads at S = 2048, D = 128: 16 MB)
  static constexpr int HEAD_GROUP = 16;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_overlap_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        Dims dm, float scale_log2, int causal, Dropout dr) {
  using T = FwdOvTile<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES, G = T::HEAD_GROUP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + T::Q_BYTES;                     // [ST] x KV_BYTES
  uint8_t* Vs = Ks + ST * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;                     // [ST]
  uint64_t* v_full = k_full + ST;                    // [ST]
  uint64_t* k_empty = v_full + ST;                   // [ST]
  uint64_t* v_empty = k_empty + ST;                  // [ST]

  // block -> (q tile, head): groups of G heads, inside a group every
  // head's longest q tile first
  const int nq = (dm.Sq + BQ - 1) / BQ;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  const int g0 = blk / (G * nq) * G;
  const int gn = min(G, static_cast<int>(gridDim.y) - g0);
  const int qi = nq - 1 - (blk - g0 * nq) / gn;
  const int bh = g0 + (blk - g0 * nq) % gn;
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int q0 = qi * BQ;
  const int offset = dm.Sk - dm.Sq;
  const int nk = fwd_key_tiles<BQ, BK>(dm, q0, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2 * 128);
      mbar_init(v_empty + s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the role index, warp-uniform (lane 0's), as in dq
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: thread 0 drives TMA. K and V have barriers of their
    // own: a K stage is free once S is done, a V stage once P V is ----
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::CH; ++c)
        tma_load_4d(Qs + c * T::Q_CHUNK, &tq, q_full, 64 * c, h, q0, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        const uint32_t par = ((kt / ST) & 1) ^ 1;
        mbar_wait(k_empty + s, par);
        mbar_expect_tx(k_full + s, T::KV_BYTES);
        for (int c = 0; c < T::CH; ++c)
          tma_load_4d(Ks + s * T::KV_BYTES + c * T::KV_CHUNK, &tk, k_full + s,
                      64 * c, hk, kt * BK, b);
        mbar_wait(v_empty + s, par);
        mbar_expect_tx(v_full + s, T::KV_BYTES);
        for (int c = 0; c < T::CH; ++c)
          tma_load_4d(Vs + s * T::KV_BYTES + c * T::KV_CHUNK, &tv, v_full + s,
                      64 * c, hk, kt * BK, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  reg_alloc<kConsumerRegs>();
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;
  const int w = t >> 5, l = t & 31;
  const int row_base = q0 + 64 * cw;                 // first row of this warpgroup
  // the key tiles this warpgroup's rows see: none past Sq; under causal,
  // none past its last row's diagonal (the CTA's other tiles, passed
  // through after the loop)
  int nw = row_base >= dm.Sq ? 0 : nk;
  if (causal && nw > 0) {
    const int last = row_base + 63 + offset;
    nw = last < 0 ? 0 : min(nk, last / BK + 1);
  }
  const uint32_t seed_bh =
      dr.on ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
  // one FFMA per element needs the max taken on unscaled scores
  const bool raw_ok = scale_log2 > 0.f;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float lsum[2] = {0.f, 0.f};                        // this thread's share
  float alpha[2];
  float sc[BK / 2];                                  // S, then p in place
  uint32_t pa[BK / 16][4];                           // P, bf16 A fragments
  const uint32_t q_addr = smem_u32(Qs) + 64 * cw * 128;

  // S = Q K^T of tile kt (fp32, 64 x BK), committed as one group
  auto issue_s = [&](int kt) {
    const uint32_t k_addr = smem_u32(Ks + kt % ST * T::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss<BK, 0>(sc, desc_sw128(q_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024),
                      desc_sw128(k_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile kt (V MN-major), committed as one group
  auto issue_pv = [&](int kt) {
    const uint32_t v_addr = smem_u32(Vs + kt % ST * T::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP, 1>(o, pa[kk], desc_sw128(v_addr + kk * 2048, T::KV_CHUNK, 1024), 1);
    wgmma_commit();
  };
  // Online softmax of tile kt in the exp2 domain: p (dropped) in place in
  // sc, m and lsum carried, alpha set. CUT (the diagonal or the key edge
  // cuts the tile, or the scale is not positive): scale, compare each
  // element, exp2(x - m); else one FFMA per element, exp2(s c - m).
  // Dropout is chosen per tile, so neither branch sits in the element loop.
  auto softmax = [&](auto cut_tag, auto drop_tag, int kt) {
    constexpr bool CUT = decltype(cut_tag)::value;
    constexpr bool DROP = decltype(drop_tag)::value;
    constexpr int NB = BK / 8;                       // n-blocks of 8 keys
    const int k0 = kt * BK;
    if constexpr (CUT) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[4 * i + j] * scale_log2;
          const int c = k0 + frag_col(l, i, j);
          const int r = row_base + frag_row(w, l, j);
          if (c >= dm.Sk || (causal && c > r + offset)) x = -INFINITY;
          sc[4 * i + j] = x;
        }
    }
    // row maxima as a tree (a max is exact in any order)
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tr[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) tr[i] = fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]);
#pragma unroll
      for (int n = NB / 2; n > 0; n /= 2)
#pragma unroll
        for (int i = 0; i < n; ++i) tr[i] = fmaxf(tr[i], tr[i + n]);
      mx[r] = quad_max(tr[0]);
    }
    float neg_m[2];                                  // -m, 0 while m is -inf
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the scale is positive and rounding monotone: max fl(s c) is
      // fl(max(s) c), the CUT branch's maximum
      const float m_new = fmaxf(m[r], CUT ? mx[r] : mx[r] * scale_log2);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_safe);               // 0 while m was -inf
      m[r] = m_new;
      neg_m[r] = -m_safe;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = ex2_ftz(CUT ? sc[4 * i + j] + neg_m[j >> 1]
                              : fmaf(sc[4 * i + j], scale_log2, neg_m[j >> 1]));
        rs[j >> 1] += p;
        if constexpr (DROP)
          p = keep(seed_bh, row_base + frag_row(w, l, j), k0 + frag_col(l, i, j),
                   dm.Sk, dr.thresh)
                  ? p * dr.keep_scale
                  : 0.f;
        sc[4 * i + j] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) lsum[r] = alpha[r] * lsum[r] + rs[r];
  };
  auto softmax_tile = [&](int kt) {
    const int k0 = kt * BK;
    const bool cut = !raw_ok || k0 + BK > dm.Sk ||
                     (causal && k0 + BK - 1 > row_base + offset);
    if (cut) {
      if (dr.on) softmax(std::true_type{}, std::true_type{}, kt);
      else softmax(std::true_type{}, std::false_type{}, kt);
    } else {
      if (dr.on) softmax(std::false_type{}, std::true_type{}, kt);
      else softmax(std::false_type{}, std::false_type{}, kt);
    }
    // the pass stays ahead of the wait for P V: nothing it computes may
    // sink past that wait
    fence_regs(sc);
    fence_regs(lsum);
    fence_regs(alpha);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[4 * i + j] *= alpha[j >> 1];
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      pa[i >> 1][2 * (i & 1)] = pack_bf16(sc[4 * i], sc[4 * i + 1]);
      pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
    }
  };

  mbar_wait(q_full, 0);
  if (nw > 0) {
    // tile 0: S, softmax, P
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty);
    softmax_tile(0);
    pack();
    // tile kt: S of kt, then O rescaled and P V of kt - 1 issued behind
    // it; the softmax of kt runs once S is done, while P V runs
    for (int kt = 1; kt < nw; ++kt) {
      mbar_wait(k_full + kt % ST, (kt / ST) & 1);
      mbar_wait(v_full + (kt - 1) % ST, ((kt - 1) / ST) & 1);
      fence_regs(o);
      wgmma_fence();
      issue_s(kt);
      rescale();
      fence_regs(o);
      wgmma_fence();
      issue_pv(kt - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(k_empty + kt % ST);
      softmax_tile(kt);
      wgmma_wait<0>();
      fence_regs(o);
      fence_frags(pa);
      mbar_arrive(v_empty + (kt - 1) % ST);
      pack();
    }
    // P V of the last tile
    mbar_wait(v_full + (nw - 1) % ST, ((nw - 1) / ST) & 1);
    rescale();
    fence_regs(o);
    wgmma_fence();
    issue_pv(nw - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_frags(pa);
    mbar_arrive(v_empty + (nw - 1) % ST);
  }
  // the CTA's tiles no row of this warpgroup sees: released in order (the
  // waits keep each arrival in its round, as in dq)
  for (int kt = nw; kt < nk; ++kt) {
    mbar_wait(k_full + kt % ST, (kt / ST) & 1);
    mbar_arrive(k_empty + kt % ST);
    mbar_wait(v_full + kt % ST, (kt / ST) & 1);
    mbar_arrive(v_empty + kt % ST);
  }

  // epilogue
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float L = quad_sum(lsum[r]);
    inv[r] = L > 0.f ? 1.f / L : 0.f;
    const int row = row_base + frag_row(w, l, 2 * r);
    if ((l & 3) == 0 && row < dm.Sq)
      lse[static_cast<size_t>(bh) * dm.Sq + row] =
          L > 0.f ? m[r] * kLn2 + logf(L) : -INFINITY;
  }
  const size_t stride = static_cast<size_t>(dm.Hq) * dm.D;
  bf16* ob = out + (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
  store_rows<DP>(ob, stride, o, row_base, dm.Sq, dm.D, inv[0], inv[1], w, l);
}

// ---------------------------------------------------------------------------
// dkv: grid (nk, B*Hk)
// ---------------------------------------------------------------------------

// D = 64 (D = 128 takes Dkv128Tile)
template <int DP>
struct DkvTile {
  static constexpr int BK = 128, BQ = 64, STAGES = 2, CH = DP / 64;
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int KV_BYTES = CH * KV_CHUNK;    // K or V, loaded once
  static constexpr int Q_CHUNK = BQ * 128;
  static constexpr int Q_BYTES = CH * Q_CHUNK;      // Q or dO, one stage
  static constexpr int STAT_BYTES = 2 * BQ * 4;     // lse, delta
  static constexpr int SMEM = 1024 + 2 * KV_BYTES +
                              STAGES * (2 * Q_BYTES + STAT_BYTES) + 128;
};

// BIAS: 0 none, 1 bias ("plane" class), 2 bias of the "keys" class
template <int DP, bool DROP, int BIAS, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Dims dm,
                float scale, int causal, Dropout dr, Mask mk) {
  using T = DkvTile<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + T::KV_BYTES;
  uint8_t* Qs = Vs + T::KV_BYTES;                    // [ST] x Q_BYTES
  uint8_t* dOs = Qs + ST * T::Q_BYTES;               // [ST] x Q_BYTES
  float* stats = reinterpret_cast<float*>(dOs + ST * T::Q_BYTES);  // [ST][2][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + ST * 2 * BQ);
  uint64_t* full = kv_full + 1;                      // [ST]
  uint64_t* empty = full + ST;                       // [ST]

  const int kt = blockIdx.x;
  const int bhk = blockIdx.y;
  const int b = bhk / dm.Hk, hk = bhk % dm.Hk;
  const int rep = dm.Hq / dm.Hk;
  const int k0 = kt * BK;
  const int offset = dm.Sk - dm.Sq;
  const int nq = (dm.Sq + BQ - 1) / BQ;
  // first q tile whose last row sees key k0
  int qi0 = 0;
  if (causal) {
    const int need = k0 - offset - (BQ - 1);
    qi0 = need <= 0 ? 0 : min(nq, (need + BQ - 1) / BQ);
  }
  const int per_head = nq - qi0;
  const int ntiles = rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1 + 32);           // the TMA thread + the stats warp
      mbar_init(empty + s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the role index, warp-uniform (lane 0's): faster in the bias-free and
  // "keys" instantiations on an H100 (with lse and delta by ld.shared),
  // slower in the "plane" ones, which keep threadIdx.x / 128
  const int wg = BIAS == 1 ? static_cast<int>(threadIdx.x) / 128
                           : __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: thread 0 drives TMA, warp 1 copies lse and delta ----
    reg_dealloc<kProducerRegs>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int c = 0; c < T::CH; ++c) {
        tma_load_4d(Ks + c * T::KV_CHUNK, &tk, kv_full, 64 * c, hk, k0, b);
        tma_load_4d(Vs + c * T::KV_CHUNK, &tv, kv_full, 64 * c, hk, k0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        const int h = hk * rep + it / per_head;
        const int q0 = (qi0 + it % per_head) * BQ;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * T::Q_BYTES);
        for (int c = 0; c < T::CH; ++c) {
          tma_load_4d(Qs + s * T::Q_BYTES + c * T::Q_CHUNK, &tq, full + s, 64 * c, h, q0, b);
          tma_load_4d(dOs + s * T::Q_BYTES + c * T::Q_CHUNK, &tdo, full + s, 64 * c, h, q0, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        const int bh = b * dm.Hq + hk * rep + it / per_head;
        const int q0 = (qi0 + it % per_head) * BQ;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        float* st = stats + s * 2 * BQ;
#pragma unroll
        for (int rr = 0; rr < BQ / 32; ++rr) {
          const int j = lane + 32 * rr, row = q0 + j;
          const size_t idx = static_cast<size_t>(bh) * dm.Sq + row;
          // a row that sees no key (lse = -inf) reads 0; a padded row +inf,
          // so its p is 0 (as the reference pads lse)
          const float ls = row < dm.Sq ? lse[idx] : INFINITY;
          st[j] = ls == -INFINITY ? 0.f : ls;
          st[BQ + j] = row < dm.Sq ? delta[idx] : 0.f;
        }
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int w = t >> 5, l = t & 31;
    const int key_base = k0 + 64 * cw;               // first key of this warpgroup
    const uint32_t k_addr = smem_u32(Ks) + 64 * cw * 128;
    const uint32_t v_addr = smem_u32(Vs) + 64 * cw * 128;

    const uint32_t seed = DROP ? static_cast<uint32_t>(dr.seed[0]) : 0u;
    [[maybe_unused]] int kw[2] = {0, 0};             // segment words of the two keys
    if constexpr (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        kw[r] = seg_word(mk.kseg, b, dm.Sk, key_base + frag_row(w, l, 2 * r), kNoKey);
    }
    // "plane": the bias column of each key (-1 past Sk: its bias reads as
    // 0). "keys": the bias of the thread's two keys under the tile's q
    // head, in registers, read again only where the head changes and the
    // heads' biases differ (sh != 0)
    [[maybe_unused]] long long bkey[2] = {-1, -1};
    [[maybe_unused]] float bk[2] = {0.f, 0.f};
    if constexpr (BIAS == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key_base + frag_row(w, l, 2 * r);
        bkey[r] = key < dm.Sk ? key * mk.sk : -1;
      }
    } else if constexpr (BIAS == 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bk[r] = key_bias(mk, dm, b, hk * rep, key_base + frag_row(w, l, 2 * r));
    }
    constexpr bool PP = BIAS == 2;
    if constexpr (PP) {
      // ping-pong: a warpgroup issues S and dP after a sync on barrier
      // 1 + cw, which the other's arrival after its own S and dP
      // completes; warpgroup 2's first arrival lets warpgroup 1 start
      if (cw == 1) named_arrive(1, 256);
    }
    float dka[DP / 2], dva[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % ST;
      const uint32_t par = (it / ST) & 1;
      const int bh = b * dm.Hq + hk * rep + it / per_head;
      const int q0 = (qi0 + it % per_head) * BQ;
      if constexpr (BIAS == 2) {
        if (mk.sh != 0 && it > 0 && it % per_head == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            bk[r] = key_bias(mk, dm, b, bh - b * dm.Hq, key_base + frag_row(w, l, 2 * r));
        }
      }
      // every key of this warpgroup past the tile's last row: nothing to add
      // (the wait keeps this arrival in round `it`: arriving early could
      // complete the previous round's release while the other warpgroup
      // still reads that stage)
      if (causal && key_base > q0 + BQ - 1 + offset) {
        mbar_wait(full + s, par);
        if constexpr (PP) {
          named_sync(1 + cw, 256);
          named_arrive(2 - cw, 256);
        }
        mbar_arrive(empty + s);
        continue;
      }
      const uint32_t q_addr = smem_u32(Qs + s * T::Q_BYTES);
      const uint32_t do_addr = smem_u32(dOs + s * T::Q_BYTES);

      // S^T = K Q^T and dP^T = V dO^T (fp32, 64 keys x BQ queries)
      float st[BQ / 2], dpt[BQ / 2];
      mbar_wait(full + s, par);
      if constexpr (PP) named_sync(1 + cw, 256);   // this warpgroup's turn
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss<BQ, 0>(st, desc_sw128(k_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024),
                        desc_sw128(q_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss<BQ, 0>(dpt, desc_sw128(v_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024),
                        desc_sw128(do_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if constexpr (PP) named_arrive(2 - cw, 256);   // the other's turn
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, each rounded to bf16 as the A fragments of its product
      const float* ls = stats + s * 2 * BQ;
      const float* dl = ls + BQ;
      const bool cut = causal && key_base + 63 > q0 + offset;
      const uint32_t seed_bh = DROP ? mix_seed(seed, bh) : 0u;
      // this tile's q head's bias plane
      [[maybe_unused]] const float* bplane =
          BIAS == 1 ? mk.bias + b * mk.sb + (bh - b * dm.Hq) * mk.sh : nullptr;
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      const uint32_t ls_addr = smem_u32(ls), dl_addr = smem_u32(dl);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int cl = frag_col(l, i, 0);
        // by ld.shared (the pointers' loads would be generic)
        const float2 lsv = lds_f2(ls_addr + 4 * cl);
        const float2 dlv = lds_f2(dl_addr + 4 * cl);
        float pv[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = key_base + frag_row(w, l, j);
          const int qr = q0 + cl + (j & 1);
          // exp(s scale - lse) in the plain version's order of rounding
          // (product, then difference): an argument off by a few ulp, as
          // exp2 with log2(e) folded in gives, flips the bf16 rounding of
          // some large p. The bias of (query qr, key) is read transposed.
          float x = __fmul_rn(st[4 * i + j], scale);
          if constexpr (BIAS == 1)
            x = __fadd_rn(x, qr < dm.Sq && bkey[j >> 1] >= 0
                                 ? bplane[qr * mk.sq + bkey[j >> 1]]
                                 : 0.f);
          else if constexpr (BIAS == 2)
            x = __fadd_rn(x, bk[j >> 1]);
          float p = expf(x - ((j & 1) ? lsv.y : lsv.x));
          if constexpr (SEG) {
            if ((cut && key > qr + offset) ||
                !seg_sees(seg_word(mk.qseg, b, dm.Sq, qr, kNoQuery), kw[j >> 1],
                          mk.seg_causal))
              p = 0.f;
          } else {
            if (cut && key > qr + offset) p = 0.f;
          }
          float dp = dpt[4 * i + j];
          pv[j] = p;
          if constexpr (DROP) {
            const bool kp = keep(seed_bh, qr, key, dm.Sk, dr.thresh);
            pv[j] = kp ? p * dr.keep_scale : 0.f;
            dp = kp ? dp * dr.keep_scale : 0.f;
          }
          ds[j] = p * (dp - ((j & 1) ? dlv.y : dlv.x));
        }
        pa[i >> 1][2 * (i & 1)] = pack_bf16(pv[0], pv[1]);
        pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(pv[2], pv[3]);
        da[i >> 1][2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
        da[i >> 1][2 * (i & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO, dK += dS^T Q (B operands MN-major)
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DP, 1>(dva, pa[kk], desc_sw128(do_addr + kk * 2048, T::Q_CHUNK, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DP, 1>(dka, da[kk], desc_sw128(q_addr + kk * 2048, T::Q_CHUNK, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_frags(pa);
      fence_frags(da);
      mbar_arrive(empty + s);
    }

    if constexpr (PP) {
      if (cw == 0) named_sync(1, 256);   // warpgroup 2's last arrival
    }
    const size_t stride = static_cast<size_t>(dm.Hk) * dm.D;
    const size_t koff = (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
    store_rows<DP>(dk + koff, stride, dka, key_base, dm.Sk, dm.D, scale, scale, w, l);
    store_rows<DP>(dv + koff, stride, dva, key_base, dm.Sk, dm.D, 1.f, 1.f, w, l);
  }
}

// ---------------------------------------------------------------------------
// dkv at D = 128: grid (Sk / 64, B*Hk)
// ---------------------------------------------------------------------------

// Each CTA owns 64 keys, and each consumer warpgroup one of the two
// accumulators: warpgroup 1 forms S^T and P^T and accumulates dV,
// warpgroup 2 forms dP^T and dS^T and accumulates dK. A warpgroup then
// holds 64 accumulator registers, one or two 32-register products and a
// 16-register A fragment (P^T or dS^T, RS products). dK and dV of 64 keys
// in one warpgroup (128 registers at D = 128) left ptxas no room for a
// product in flight: it serialised every wgmma and spilled. p crosses from
// warpgroup 1 to 2 in fp32 through shared memory (two buffers, handed over
// by named barriers).
struct Dkv128Tile {
  static constexpr int DP = 128, BK = 64, BQ = 64, STAGES = 3, CH = 2;
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int KV_BYTES = CH * KV_CHUNK;    // K or V, loaded once
  static constexpr int Q_CHUNK = BQ * 128;
  static constexpr int Q_BYTES = CH * Q_CHUNK;      // Q or dO, one stage
  static constexpr int STAT_BYTES = 2 * BQ * 4;     // lse, delta
  static constexpr int PF_BYTES = BK * BQ * 4;      // p, fp32: one buffer
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * Q_BYTES +
                              2 * PF_BYTES + STAGES * STAT_BYTES + 128;
};

// named barriers between the consumer warpgroups: p of an even / odd tile
// stored (warpgroup 1 arrives, 2 syncs), read (2 arrives, 1 syncs)
constexpr int kBarPReady = 1, kBarPFree = 3;

template <bool DROP, int BIAS, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
dkv128_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, Dims dm,
                   float scale, int causal, Dropout dr, Mask mk) {
  using T = Dkv128Tile;
  constexpr int DP = T::DP, BQ = T::BQ, BK = T::BK, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + T::KV_BYTES;
  uint8_t* Qs = Vs + T::KV_BYTES;                    // [ST] x Q_BYTES
  uint8_t* dOs = Qs + ST * T::Q_BYTES;               // [ST] x Q_BYTES
  float* pf = reinterpret_cast<float*>(dOs + ST * T::Q_BYTES);   // [2] x PF_BYTES
  float* stats = pf + 2 * BK * BQ;                   // [ST][2][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + ST * 2 * BQ);
  uint64_t* full = kv_full + 1;                      // [ST]
  uint64_t* empty = full + ST;                       // [ST]

  const int kt = blockIdx.x;
  const int bhk = blockIdx.y;
  const int b = bhk / dm.Hk, hk = bhk % dm.Hk;
  const int rep = dm.Hq / dm.Hk;
  const int k0 = kt * BK;
  const int offset = dm.Sk - dm.Sq;
  const int nq = (dm.Sq + BQ - 1) / BQ;
  // first q tile whose last row sees key k0: every tile from it on has a
  // row that sees a key of the CTA, so neither warpgroup skips a tile
  int qi0 = 0;
  if (causal) {
    const int need = k0 - offset - (BQ - 1);
    qi0 = need <= 0 ? 0 : min(nq, (need + BQ - 1) / BQ);
  }
  const int per_head = nq - qi0;
  const int ntiles = rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1 + 32);           // the TMA thread + the stats warp
      mbar_init(empty + s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the role index, warp-uniform (lane 0's)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: thread 0 drives TMA, warp 1 copies lse and delta ----
    reg_dealloc<kProducerRegs>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int c = 0; c < T::CH; ++c) {
        tma_load_4d(Ks + c * T::KV_CHUNK, &tk, kv_full, 64 * c, hk, k0, b);
        tma_load_4d(Vs + c * T::KV_CHUNK, &tv, kv_full, 64 * c, hk, k0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        const int h = hk * rep + it / per_head;
        const int q0 = (qi0 + it % per_head) * BQ;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * T::Q_BYTES);
        for (int c = 0; c < T::CH; ++c) {
          tma_load_4d(Qs + s * T::Q_BYTES + c * T::Q_CHUNK, &tq, full + s, 64 * c, h, q0, b);
          tma_load_4d(dOs + s * T::Q_BYTES + c * T::Q_CHUNK, &tdo, full + s, 64 * c, h, q0, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        const int bh = b * dm.Hq + hk * rep + it / per_head;
        const int q0 = (qi0 + it % per_head) * BQ;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        float* st = stats + s * 2 * BQ;
#pragma unroll
        for (int rr = 0; rr < BQ / 32; ++rr) {
          const int j = lane + 32 * rr, row = q0 + j;
          const size_t idx = static_cast<size_t>(bh) * dm.Sq + row;
          // as in dkv_sm90_kernel: -inf reads 0, a padded row +inf
          const float ls = row < dm.Sq ? lse[idx] : INFINITY;
          st[j] = ls == -INFINITY ? 0.f : ls;
          st[BQ + j] = row < dm.Sq ? delta[idx] : 0.f;
        }
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers: the CTA's 64 keys, one accumulator each ----
  reg_alloc<kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int w = t >> 5, l = t & 31;
  // p's float2 v (0..15) of thread t at pf_base + 1024 v: thread t of
  // warpgroup 2 reads what thread t of warpgroup 1 stored (the same
  // accumulator elements)
  const uint32_t pf_base = smem_u32(pf) + 8 * t;
  const uint32_t seed = DROP ? static_cast<uint32_t>(dr.seed[0]) : 0u;
  float acc[DP / 2];                                 // dV (warpgroup 1), dK (2)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  if (wg == 1) {
    // ---- S^T = K Q^T, P^T = exp(S^T scale - lse) masked, dV += P^T dO ----
    [[maybe_unused]] int kw[2] = {0, 0};             // segment words of the two keys
    if constexpr (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        kw[r] = seg_word(mk.kseg, b, dm.Sk, k0 + frag_row(w, l, 2 * r), kNoKey);
    }
    // "plane": each key's bias column (-1 past Sk); "keys": the two keys'
    // biases under the tile's q head (read again where the head changes
    // and the heads' biases differ), as in dkv_sm90_kernel
    [[maybe_unused]] long long bkey[2] = {-1, -1};
    [[maybe_unused]] float bk[2] = {0.f, 0.f};
    if constexpr (BIAS == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + frag_row(w, l, 2 * r);
        bkey[r] = key < dm.Sk ? key * mk.sk : -1;
      }
    } else if constexpr (BIAS == 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bk[r] = key_bias(mk, dm, b, hk * rep, k0 + frag_row(w, l, 2 * r));
    }
    const uint32_t k_addr = smem_u32(Ks);
    uint32_t pa[BQ / 16][4];                         // P^T, read by dV's product

    // S^T of tile it, committed as one group
    auto issue_s = [&](float (&st)[BQ / 2], int it) {
      const int s = it % ST;
      const uint32_t q_addr = smem_u32(Qs + s * T::Q_BYTES);
      mbar_wait(full + s, (it / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss<BQ, 0>(st, desc_sw128(k_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024),
                        desc_sw128(q_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // tile it, once its S^T and the previous tile's dV product are done:
    // release that stage, form p (the plain version's rounding and masks,
    // as dkv_sm90_kernel) for warpgroup 2 and P^T (dropped) as A fragments,
    // issue dV += P^T dO (dO MN-major) without waiting for it
    auto finish = [&](float (&st)[BQ / 2], int it) {
      fence_regs(acc);
      fence_frags(pa);
      fence_regs(st);
      if (it > 0) mbar_arrive(empty + (it + ST - 1) % ST);
      const int s = it % ST;
      const int bh = b * dm.Hq + hk * rep + it / per_head;
      const int q0 = (qi0 + it % per_head) * BQ;
      if constexpr (BIAS == 2) {
        if (mk.sh != 0 && it > 0 && it % per_head == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            bk[r] = key_bias(mk, dm, b, bh - b * dm.Hq, k0 + frag_row(w, l, 2 * r));
        }
      }
      named_sync(kBarPFree + (it & 1), 256);         // its p buffer is read
      const uint32_t pf_addr = pf_base + (it & 1) * T::PF_BYTES;
      const uint32_t ls_addr = smem_u32(stats + s * 2 * BQ);
      const bool cut = causal && k0 + 63 > q0 + offset;
      const uint32_t seed_bh = DROP ? mix_seed(seed, bh) : 0u;
      [[maybe_unused]] const float* bplane =
          BIAS == 1 ? mk.bias + b * mk.sb + (bh - b * dm.Hq) * mk.sh : nullptr;
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int cl = frag_col(l, i, 0);
        const float2 lsv = lds_f2(ls_addr + 4 * cl);
        float pv[4], pk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + frag_row(w, l, j);
          const int qr = q0 + cl + (j & 1);
          float x = __fmul_rn(st[4 * i + j], scale);
          if constexpr (BIAS == 1)
            x = __fadd_rn(x, qr < dm.Sq && bkey[j >> 1] >= 0
                                 ? bplane[qr * mk.sq + bkey[j >> 1]]
                                 : 0.f);
          else if constexpr (BIAS == 2)
            x = __fadd_rn(x, bk[j >> 1]);
          float p = expf(x - ((j & 1) ? lsv.y : lsv.x));
          if constexpr (SEG) {
            if ((cut && key > qr + offset) ||
                !seg_sees(seg_word(mk.qseg, b, dm.Sq, qr, kNoQuery), kw[j >> 1],
                          mk.seg_causal))
              p = 0.f;
          } else {
            if (cut && key > qr + offset) p = 0.f;
          }
          pv[j] = p;
          pk[j] = p;
          if constexpr (DROP)
            pk[j] = keep(seed_bh, qr, key, dm.Sk, dr.thresh) ? p * dr.keep_scale : 0.f;
        }
        sts_f2(pf_addr + 1024 * (2 * i), make_float2(pv[0], pv[1]));
        sts_f2(pf_addr + 1024 * (2 * i + 1), make_float2(pv[2], pv[3]));
        pa[i >> 1][2 * (i & 1)] = pack_bf16(pk[0], pk[1]);
        pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(pk[2], pk[3]);
      }
      named_arrive(kBarPReady + (it & 1), 256);      // p to warpgroup 2
      const uint32_t do_addr = smem_u32(dOs + s * T::Q_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DP, 1>(acc, pa[kk], desc_sw128(do_addr + kk * 2048, T::Q_CHUNK, 1024), 1);
      wgmma_commit();
    };

    mbar_wait(kv_full, 0);
    float st[BQ / 2];
    for (int it = 0; it < ntiles; ++it) {
      issue_s(st, it);
      wgmma_wait<0>();
      finish(st, it);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(pa);
    if (ntiles > 0) mbar_arrive(empty + (ntiles - 1) % ST);
    // warpgroup 2's last two releases of the p buffers
    named_sync(kBarPFree + (ntiles & 1), 256);
    named_sync(kBarPFree + ((ntiles + 1) & 1), 256);
  } else {
    // ---- dP^T = V dO^T, dS^T = P^T (dP^T_dropped - delta), dK += dS^T Q ----
    const uint32_t v_addr = smem_u32(Vs);
    uint32_t da[BQ / 16][4];                         // dS^T, read by dK's product
    named_arrive(kBarPFree, 256);                    // both p buffers free
    named_arrive(kBarPFree + 1, 256);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % ST;
      const int bh = b * dm.Hq + hk * rep + it / per_head;
      const int q0 = (qi0 + it % per_head) * BQ;
      const uint32_t q_addr = smem_u32(Qs + s * T::Q_BYTES);
      const uint32_t do_addr = smem_u32(dOs + s * T::Q_BYTES);
      float dpt[BQ / 2];
      mbar_wait(full + s, (it / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss<BQ, 0>(dpt, desc_sw128(v_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024),
                        desc_sw128(do_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // the previous tile's dK product is done: release its stage
      wgmma_wait<1>();
      fence_regs(acc);
      fence_frags(da);
      if (it > 0) mbar_arrive(empty + (it + ST - 1) % ST);
      wgmma_wait<0>();
      fence_regs(dpt);

      const uint32_t dl_addr = smem_u32(stats + s * 2 * BQ + BQ);
      const uint32_t seed_bh = DROP ? mix_seed(seed, bh) : 0u;
      named_sync(kBarPReady + (it & 1), 256);        // this tile's p stored
      const uint32_t pf_addr = pf_base + (it & 1) * T::PF_BYTES;
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int cl = frag_col(l, i, 0);
        const float2 dlv = lds_f2(dl_addr + 4 * cl);
        const float2 p01 = lds_f2(pf_addr + 1024 * (2 * i));
        const float2 p23 = lds_f2(pf_addr + 1024 * (2 * i + 1));
        const float pp[4] = {p01.x, p01.y, p23.x, p23.y};
        float ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float dp = dpt[4 * i + j];
          if constexpr (DROP)
            dp = keep(seed_bh, q0 + cl + (j & 1), k0 + frag_row(w, l, j), dm.Sk, dr.thresh)
                     ? dp * dr.keep_scale
                     : 0.f;
          ds[j] = pp[j] * (dp - ((j & 1) ? dlv.y : dlv.x));
        }
        da[i >> 1][2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
        da[i >> 1][2 * (i & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      named_arrive(kBarPFree + (it & 1), 256);       // p buffer read

      // dK += dS^T Q (Q MN-major); waited for behind the next tile's dP^T
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DP, 1>(acc, da[kk], desc_sw128(q_addr + kk * 2048, T::Q_CHUNK, 1024), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(da);
    if (ntiles > 0) mbar_arrive(empty + (ntiles - 1) % ST);
  }
  const size_t stride = static_cast<size_t>(dm.Hk) * dm.D;
  const size_t koff = (static_cast<size_t>(b) * dm.Sk * dm.Hk + hk) * dm.D;
  if (wg == 1)
    store_rows<DP>(dv + koff, stride, acc, k0, dm.Sk, dm.D, 1.f, 1.f, w, l);
  else
    store_rows<DP>(dk + koff, stride, acc, k0, dm.Sk, dm.D, scale, scale, w, l);
}

// ---------------------------------------------------------------------------
// dq: grid (nq, B*Hq)
// ---------------------------------------------------------------------------

// K/V tiles of 64 keys keep S, dP (32 each), dQ (DP / 2) and the dS
// fragments (16) live per consumer thread inside its register budget;
// tiles of 128 would need 64 + 64 + 64 + 32 at DP = 128.
template <int DP>
struct DqTile {
  static constexpr int BQ = 128, BK = 64, STAGES = 4, CH = DP / 64;
  static constexpr int Q_CHUNK = BQ * 128;          // bytes of one 64-col chunk
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = CH * Q_CHUNK;      // Q or dO, loaded once
  static constexpr int KV_BYTES = CH * KV_CHUNK;    // K or V, one stage
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 128;
  static constexpr int KEY_BIAS_BYTES = STAGES * BK * 4;   // "keys" class only
};

// BIAS: 0 none, 1 bias ("plane" class), 2 bias and dbias ("plane"), 3 bias
// of the "keys" class
template <int DP, bool DROP, int BIAS, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, Dims dm, float scale, int causal,
               Dropout dr, Mask mk) {
  using T = DqTile<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + T::Q_BYTES;
  uint8_t* Ks = dOs + T::Q_BYTES;                    // [ST] x KV_BYTES
  uint8_t* Vs = Ks + ST * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * T::KV_BYTES);
  uint64_t* kv_full = q_full + 1;                    // [ST]
  uint64_t* kv_empty = kv_full + ST;                 // [ST]
  // "keys": each stage's 64 key biases, past the barriers' 128 bytes
  [[maybe_unused]] float* kbias =
      reinterpret_cast<float*>(Vs + ST * T::KV_BYTES + 128);   // [ST][BK]

  const int nq = (dm.Sq + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);  // long rows first
  const int bh = blockIdx.y;
  const int b = bh / dm.Hq, h = bh % dm.Hq;
  const int hk = h / (dm.Hq / dm.Hk);
  const int q0 = qi * BQ;
  const int offset = dm.Sk - dm.Sq;
  int nk = (dm.Sk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + offset;       // tiles past it are dead
    nk = last < 0 ? 0 : min(nk, last / BK + 1);
  }

  constexpr bool PP = BIAS == 3 || DP == 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      // "keys": the TMA thread + the key-bias warp
      mbar_init(kv_full + s, BIAS == 3 ? 1 + 32 : 1);
      mbar_init(kv_empty + s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the role index, warp-uniform (lane 0's), as in dkv
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: thread 0 drives TMA; under "keys" warp 1 copies each
    // stage's key biases (0 past Sk) into the stage ----
    reg_dealloc<kProducerRegs>();
    if (BIAS == 3 && threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x & 31;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        mbar_wait(kv_empty + s, ((kt / ST) & 1) ^ 1);
#pragma unroll
        for (int rr = 0; rr < BK / 32; ++rr) {
          const int j = lane + 32 * rr;
          kbias[s * BK + keys_slot(j)] = key_bias(mk, dm, b, h, kt * BK + j);
        }
        mbar_arrive(kv_full + s);
      }
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
      for (int c = 0; c < T::CH; ++c) {
        tma_load_4d(Qs + c * T::Q_CHUNK, &tq, q_full, 64 * c, h, q0, b);
        tma_load_4d(dOs + c * T::Q_CHUNK, &tdo, q_full, 64 * c, h, q0, b);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        mbar_wait(kv_empty + s, ((kt / ST) & 1) ^ 1);
        uint8_t* kd = Ks + s * T::KV_BYTES;
        uint8_t* vd = Vs + s * T::KV_BYTES;
        mbar_expect_tx(kv_full + s, 2 * T::KV_BYTES);
        for (int c = 0; c < T::CH; ++c) {
          tma_load_4d(kd + c * T::KV_CHUNK, &tk, kv_full + s, 64 * c, hk, kt * BK, b);
          tma_load_4d(vd + c * T::KV_CHUNK, &tv, kv_full + s, 64 * c, hk, kt * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int w = t >> 5, l = t & 31;
    const int row_base = q0 + 64 * cw;               // first row of this warpgroup
    const uint32_t seed_bh =
        DROP ? mix_seed(static_cast<uint32_t>(dr.seed[0]), bh) : 0u;
    [[maybe_unused]] int qw[2] = {0, 0};             // segment words of the two rows
    if constexpr (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        qw[r] = seg_word(mk.qseg, b, dm.Sq, row_base + frag_row(w, l, 2 * r), kNoQuery);
    }
    // bias rows, and dbias rows (NULL past Sq)
    [[maybe_unused]] const float* brow[2] = {nullptr, nullptr};
    [[maybe_unused]] float* drow[2] = {nullptr, nullptr};
    [[maybe_unused]] const int bsk = static_cast<int>(mk.sk);     // 0 or 1
    if constexpr (BIAS == 1 || BIAS == 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + frag_row(w, l, 2 * r);
        brow[r] = bias_row(mk, dm, b, h, row);
        if constexpr (BIAS == 2)
          drow[r] = row < dm.Sq ? mk.dbias + (static_cast<size_t>(bh) * dm.Sq + row) * dm.Sk
                                : nullptr;
      }
    }

    // lse and delta of the two rows this thread holds, read once: a row
    // that sees no key (lse = -inf) reads 0; a row past Sq +inf, so its p
    // is 0 (TMA zero-fills its Q and dO)
    float ls[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_base + frag_row(w, l, 2 * r);
      const size_t idx = static_cast<size_t>(bh) * dm.Sq + row;
      const float x = row < dm.Sq ? lse[idx] : INFINITY;
      ls[r] = x == -INFINITY ? 0.f : x;
      dl[r] = row < dm.Sq ? delta[idx] : 0.f;
    }

    float dqa[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs) + 64 * cw * 128;
    const uint32_t do_addr = smem_u32(dOs) + 64 * cw * 128;

    if constexpr (PP) {
      // ping-pong: a warpgroup issues S and dP after a sync on barrier
      // 1 + cw, which the other's arrival after its own S and dP
      // completes; warpgroup 2's first arrival lets warpgroup 1 start
      if (cw == 1) named_arrive(1, 256);
    }
    // the key tiles no row of this warpgroup sees (none past Sq; under
    // causal, none past its last row's diagonal) end the CTA's range:
    // [nk_w, nk), passed through after the loop
    constexpr bool SPLIT = DP == 128;
    int nk_w = row_base >= dm.Sq ? 0 : nk;
    if (causal && nk_w > 0) {
      const int last = row_base + 63 + offset;
      nk_w = last < 0 ? 0 : min(nk, last / BK + 1);
    }
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < (SPLIT ? nk_w : nk); ++kt) {
      const int s = kt % ST;
      const uint32_t par = (kt / ST) & 1;
      const int k0 = kt * BK;
      // no row of this warpgroup sees a key of the tile: nothing to add
      // (waiting for the tile keeps this arrival in round `kt`, as in dkv)
      if (!SPLIT && (row_base >= dm.Sq || (causal && k0 > row_base + 63 + offset))) {
        mbar_wait(kv_full + s, par);
        if constexpr (PP) {
          named_sync(1 + cw, 256);
          named_arrive(2 - cw, 256);
        }
        mbar_arrive(kv_empty + s);
        continue;
      }
      const uint32_t k_addr = smem_u32(Ks + s * T::KV_BYTES);
      const uint32_t v_addr = smem_u32(Vs + s * T::KV_BYTES);

      // S = Q K^T and dP = dO V^T (fp32, 64 rows x BK keys) as one batch
      // on one barrier for K and V: a wait loop between the two products
      // made ptxas wait out every wgmma (a fifth of the kernel's time)
      float sc[BK / 2], dpa[BK / 2];
      mbar_wait(kv_full + s, par);
      if constexpr (PP) named_sync(1 + cw, 256);   // this warpgroup's turn
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss<BK, 0>(sc, desc_sw128(q_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024),
                        desc_sw128(k_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss<BK, 0>(dpa, desc_sw128(do_addr + (kk >> 2) * T::Q_CHUNK + off, 16, 1024),
                        desc_sw128(v_addr + (kk >> 2) * T::KV_CHUNK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if constexpr (PP) named_arrive(2 - cw, 256);   // the other's turn
      // "keys": this thread's 16 key biases of the tile, 4 x 16 bytes by
      // ld.shared, loaded while the products run
      [[maybe_unused]] float4 kb4[BK / 16];
      if constexpr (BIAS == 3) {
        const uint32_t kb_addr = smem_u32(kbias + s * BK) + 64 * (l & 3);
#pragma unroll
        for (int m = 0; m < BK / 16; ++m) kb4[m] = lds_f4(kb_addr + 16 * m);
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dpa);

      // dS = P (dP_dropped - delta), rounded to bf16 as the A fragments of
      // dQ += dS K (and stored in fp32 as dbias). Masks where the diagonal
      // or the ragged key edge cuts, and everywhere under segments: TMA
      // zero-fills keys past Sk, whose s = 0 would give p = exp(-lse)
      const bool cut = k0 + BK > dm.Sk ||
                       (causal && k0 + BK - 1 > row_base + offset);
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        float ds[4];
        // "keys": the two key biases of this column pair
        [[maybe_unused]] float2 kb = make_float2(0.f, 0.f);
        if constexpr (BIAS == 3)
          kb = (i & 1) ? make_float2(kb4[i >> 1].z, kb4[i >> 1].w)
                       : make_float2(kb4[i >> 1].x, kb4[i >> 1].y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = row_base + frag_row(w, l, j);
          const int col = k0 + frag_col(l, i, j);
          // exp(s scale - lse) in the plain version's order of rounding, as
          // in dkv (exp2 flips the bf16 rounding of some large p)
          float x = __fmul_rn(sc[4 * i + j], scale);
          if constexpr (BIAS == 1 || BIAS == 2)
            x = __fadd_rn(x, brow[j >> 1] && col < dm.Sk ? brow[j >> 1][col * bsk] : 0.f);
          else if constexpr (BIAS == 3)
            x = __fadd_rn(x, (j & 1) ? kb.y : kb.x);
          float p = expf(x - ls[j >> 1]);
          if constexpr (SEG) {
            if ((cut && (col >= dm.Sk || (causal && col > row + offset))) ||
                !seg_sees(qw[j >> 1], seg_word(mk.kseg, b, dm.Sk, col, kNoKey),
                          mk.seg_causal))
              p = 0.f;
          } else {
            if (cut && (col >= dm.Sk || (causal && col > row + offset))) p = 0.f;
          }
          float dp = dpa[4 * i + j];
          if constexpr (DROP)
            dp = keep(seed_bh, row, col, dm.Sk, dr.thresh) ? dp * dr.keep_scale : 0.f;
          ds[j] = p * (dp - dl[j >> 1]);
          if constexpr (BIAS == 2)
            if (drow[j >> 1] && col < dm.Sk) drow[j >> 1][col] = ds[j];
        }
        da[i >> 1][2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
        da[i >> 1][2 * (i & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K (K MN-major: +16 keys per k16 step, LBO = the distance
      // between K's two 64-column chunks)
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DP, 1>(dqa, da[kk], desc_sw128(k_addr + kk * 2048, T::KV_CHUNK, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_frags(da);
      mbar_arrive(kv_empty + s);
    }
    for (int kt = SPLIT ? nk_w : nk; kt < nk; ++kt) {
      mbar_wait(kv_full + kt % ST, (kt / ST) & 1);
      if constexpr (PP) {
        named_sync(1 + cw, 256);
        named_arrive(2 - cw, 256);
      }
      mbar_arrive(kv_empty + kt % ST);
    }

    if constexpr (PP) {
      if (cw == 0) named_sync(1, 256);   // warpgroup 2's last arrival
    }
    const size_t stride = static_cast<size_t>(dm.Hq) * dm.D;
    bf16* db = dq + (static_cast<size_t>(b) * dm.Sq * dm.Hq + h) * dm.D;
    store_rows<DP>(db, stride, dqa, row_base, dm.Sq, dm.D, scale, scale, w, l);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The maps are encoded on every call, from this call's pointers: a tensor
// map holds its base address, so one cached by shape alone would read
// another call's tensors.
template <int DP>
cudaError_t launch_fwd(const Args& a, bool keys, cudaStream_t s) {
  const Dims& d = a.dm;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if (!a.mk.bias && !a.mk.qseg) {
    // bias-free: fwd_overlap_sm90_kernel
    using T = FwdOvTile<DP>;
    if ((err = make_map_bshd(&tq, a.q, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
        (err = make_map_bshd(&tk, a.k, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess ||
        (err = make_map_bshd(&tv, a.v, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess)
      return err;
    static bool smem_set = false;
    if ((err = allow_smem(fwd_overlap_sm90_kernel<DP>, T::SMEM, smem_set)) != cudaSuccess)
      return err;
    const int nq = (d.Sq + T::BQ - 1) / T::BQ;
    fwd_overlap_sm90_kernel<DP><<<dim3(nq, d.B * d.Hq), kThreads, T::SMEM, s>>>(
        tq, tk, tv, static_cast<bf16*>(a.out), a.lse_out, d, a.scale * kLog2e,
        a.causal, a.dr);
    return cudaGetLastError();
  }
  using T = FwdTile<DP>;
  if ((err = make_map_bshd(&tq, a.q, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
      (err = make_map_bshd(&tk, a.k, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess ||
      (err = make_map_bshd(&tv, a.v, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess)
    return err;
  // instantiation by (bias mode, segments); the "keys" class (mode 2) has
  // no segments
  static const decltype(&fwd_sm90_kernel<DP, 1, false>) kerns[4] = {
      fwd_sm90_kernel<DP, 1, false>, fwd_sm90_kernel<DP, 2, false>,
      fwd_sm90_kernel<DP, 0, true>, fwd_sm90_kernel<DP, 1, true>};
  static bool smem_set[4] = {};
  const int mode = a.mk.bias ? (keys ? 2 : 1) : 0;
  const int var = a.mk.qseg ? 2 + (mode != 0) : mode - 1;
  const int smem = T::SMEM + (mode == 2 ? T::KEY_BIAS_BYTES : 0);
  auto kern = kerns[var];
  if ((err = allow_smem(kern, smem, smem_set[var])) != cudaSuccess) return err;
  const int nq = (d.Sq + T::BQ - 1) / T::BQ;
  kern<<<dim3(nq, d.B * d.Hq), kThreads, smem, s>>>(
      tq, tk, tv, static_cast<bf16*>(a.out), a.lse_out, d, a.scale * kLog2e,
      a.causal, a.dr, a.scale, a.mk);
  return cudaGetLastError();
}

cudaError_t launch_dkv128(const Args& a, bool keys, cudaStream_t s) {
  using T = Dkv128Tile;
  const Dims& d = a.dm;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map_bshd(&tq, a.q, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
      (err = make_map_bshd(&tdo, a.dout, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
      (err = make_map_bshd(&tk, a.k, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess ||
      (err = make_map_bshd(&tv, a.v, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess)
    return err;
  // instantiation by (dropout, bias mode, segments), as launch_dkv's
  static const decltype(&dkv128_sm90_kernel<false, 0, false>) kerns[10] = {
      dkv128_sm90_kernel<false, 0, false>, dkv128_sm90_kernel<true, 0, false>,
      dkv128_sm90_kernel<false, 1, false>, dkv128_sm90_kernel<true, 1, false>,
      dkv128_sm90_kernel<false, 2, false>, dkv128_sm90_kernel<true, 2, false>,
      dkv128_sm90_kernel<false, 0, true>, dkv128_sm90_kernel<true, 0, true>,
      dkv128_sm90_kernel<false, 1, true>, dkv128_sm90_kernel<true, 1, true>};
  static bool smem_set[10] = {};
  const int mode = a.mk.bias ? (keys ? 2 : 1) : 0;
  const int var = (a.dr.on ? 1 : 0) + 2 * mode + (a.mk.qseg ? 6 : 0);
  auto kern = kerns[var];
  if ((err = allow_smem(kern, T::SMEM, smem_set[var])) != cudaSuccess) return err;
  const int nk = (d.Sk + T::BK - 1) / T::BK;
  kern<<<dim3(nk, d.B * d.Hk), kThreads, T::SMEM, s>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), d, a.scale, a.causal, a.dr, a.mk);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const Args& a, bool keys, cudaStream_t s) {
  using T = DkvTile<DP>;
  const Dims& d = a.dm;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map_bshd(&tq, a.q, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
      (err = make_map_bshd(&tdo, a.dout, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
      (err = make_map_bshd(&tk, a.k, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess ||
      (err = make_map_bshd(&tv, a.v, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess)
    return err;
  // instantiation by (dropout, bias mode, segments); the "keys" class
  // (mode 2) has no segments
  static const decltype(&dkv_sm90_kernel<DP, false, 0, false>) kerns[10] = {
      dkv_sm90_kernel<DP, false, 0, false>, dkv_sm90_kernel<DP, true, 0, false>,
      dkv_sm90_kernel<DP, false, 1, false>, dkv_sm90_kernel<DP, true, 1, false>,
      dkv_sm90_kernel<DP, false, 2, false>, dkv_sm90_kernel<DP, true, 2, false>,
      dkv_sm90_kernel<DP, false, 0, true>, dkv_sm90_kernel<DP, true, 0, true>,
      dkv_sm90_kernel<DP, false, 1, true>, dkv_sm90_kernel<DP, true, 1, true>};
  static bool smem_set[10] = {};
  const int mode = a.mk.bias ? (keys ? 2 : 1) : 0;
  const int var = (a.dr.on ? 1 : 0) + 2 * mode + (a.mk.qseg ? 6 : 0);
  auto kern = kerns[var];
  if ((err = allow_smem(kern, T::SMEM, smem_set[var])) != cudaSuccess) return err;
  const int nk = (d.Sk + T::BK - 1) / T::BK;
  kern<<<dim3(nk, d.B * d.Hk), kThreads, T::SMEM, s>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), d, a.scale, a.causal, a.dr, a.mk);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const Args& a, bool keys, cudaStream_t s) {
  using T = DqTile<DP>;
  const Dims& d = a.dm;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map_bshd(&tq, a.q, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
      (err = make_map_bshd(&tdo, a.dout, d.B, d.Sq, d.Hq, d.D, T::BQ)) != cudaSuccess ||
      (err = make_map_bshd(&tk, a.k, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess ||
      (err = make_map_bshd(&tv, a.v, d.B, d.Sk, d.Hk, d.D, T::BK)) != cudaSuccess)
    return err;
  // instantiation by (dropout, bias mode, segments); dbias needs a bias;
  // the "keys" class (mode 3) has no dbias and no segments
  if (a.mk.dbias && !a.mk.bias) return cudaErrorInvalidValue;
  static const decltype(&dq_sm90_kernel<DP, false, 0, false>) kerns[14] = {
      dq_sm90_kernel<DP, false, 0, false>, dq_sm90_kernel<DP, true, 0, false>,
      dq_sm90_kernel<DP, false, 1, false>, dq_sm90_kernel<DP, true, 1, false>,
      dq_sm90_kernel<DP, false, 2, false>, dq_sm90_kernel<DP, true, 2, false>,
      dq_sm90_kernel<DP, false, 3, false>, dq_sm90_kernel<DP, true, 3, false>,
      dq_sm90_kernel<DP, false, 0, true>, dq_sm90_kernel<DP, true, 0, true>,
      dq_sm90_kernel<DP, false, 1, true>, dq_sm90_kernel<DP, true, 1, true>,
      dq_sm90_kernel<DP, false, 2, true>, dq_sm90_kernel<DP, true, 2, true>};
  static bool smem_set[14] = {};
  const int mode = a.mk.bias ? (a.mk.dbias ? 2 : keys ? 3 : 1) : 0;
  const int var = (a.dr.on ? 1 : 0) + 2 * mode + (a.mk.qseg ? 8 : 0);
  const int smem = T::SMEM + (mode == 3 ? T::KEY_BIAS_BYTES : 0);
  auto kern = kerns[var];
  if ((err = allow_smem(kern, smem, smem_set[var])) != cudaSuccess) return err;
  const int nq = (d.Sq + T::BQ - 1) / T::BQ;
  kern<<<dim3(nq, d.B * d.Hq), kThreads, smem, s>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.out), d, a.scale,
      a.causal, a.dr, a.mk);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// What the wrapper's route and bias class already guarantee, checked again
// at the door: a "keys" bias does not vary along queries (query stride 0
// or Sq = 1), and comes without segments and without dbias.
bool valid(const Args& a, std::initializer_list<const void*> ptrs,
           bool keys = false) {
  const Dims& d = a.dm;
  if (keys && (!a.mk.bias || a.mk.qseg || a.mk.dbias || (a.mk.sq != 0 && d.Sq != 1)))
    return false;
  if (d.Hq <= 0 || d.Hk <= 0 || d.Hq % d.Hk != 0 || d.D < 8 || d.D > 128 ||
      d.D % 8 != 0 || static_cast<long long>(d.B) * d.Hq > 65535)
    return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

// Each entry launches on `stream` without synchronising and returns the
// launch's CUDA error code (0 on success). bf16 tensors as in the header
// comment; `seed` is a device pointer to one int32 (NULL without dropout);
// the bias, segment and dbias arguments as flash_attention.cu's entries
// take them. Each also takes `bias_keys`, the bias class the wrapper chose
// (`flash_bias_class`): 1 "keys", 0 "plane".
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int Sq, int Sk,
                              int Hq, int Hk, int D, float scale, int causal,
                              int drop_on, int thresh, float keep_scale,
                              const void* seed, PTK_MASK_PARAMS,
                              int bias_keys, void* stream) {
  Args a = make_args(q, k, v, B, Sq, Sk, Hq, Hk, D, scale, causal, drop_on,
                     thresh, keep_scale, seed, PTK_MASK_ARGS);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (!valid(a, {q, k, v, out}, bias_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? launch_fwd<64>(a, bias_keys, s)
                                  : launch_fwd<128>(a, bias_keys, s));
}

extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int Sq,
                             int Sk, int Hq, int Hk, int D, float scale,
                             int causal, int drop_on, int thresh,
                             float keep_scale, const void* seed,
                             PTK_MASK_PARAMS, void* dbias, int bias_keys,
                             void* stream) {
  Args a = make_args(q, k, v, B, Sq, Sk, Hq, Hk, D, scale, causal, drop_on,
                     thresh, keep_scale, seed, PTK_MASK_ARGS);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  a.mk.dbias = static_cast<float*>(dbias);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (!valid(a, {q, k, v, dout, dq}, bias_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? launch_dq<64>(a, bias_keys, s)
                                  : launch_dq<128>(a, bias_keys, s));
}

extern "C" int flash_dkv_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int Sq, int Sk, int Hq, int Hk, int D,
                              float scale, int causal, int drop_on,
                              int thresh, float keep_scale, const void* seed,
                              PTK_MASK_PARAMS, int bias_keys, void* stream) {
  Args a = make_args(q, k, v, B, Sq, Sk, Hq, Hk, D, scale, causal, drop_on,
                     thresh, keep_scale, seed, PTK_MASK_ARGS);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (!valid(a, {q, k, v, dout, dk, dv}, bias_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? launch_dkv<64>(a, bias_keys, s)
                                  : launch_dkv128(a, bias_keys, s));
}
