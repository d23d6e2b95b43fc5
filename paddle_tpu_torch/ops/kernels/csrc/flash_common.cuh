// What the two flash-attention sources share: the problem's dimensions, the
// dropout parameters and hash, the additive bias and segment words (Mask),
// the launch arguments, and the opt-in to more than 48 KB of dynamic
// shared memory.
//
// The dropout hash is the reference's `_keep_block` / `_mix_seed`
// (murmur3 finalisers), bit for bit: chip_smoke.py reads both routes'
// keep-masks back against `dropout_keep_mask`, so this is its only copy.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ptk {

struct Dims {
  int B, Sq, Sk, Hq, Hk, D;
};

struct Dropout {
  int on;
  int thresh;          // pre-biased: keep iff (int)(hash ^ 0x80000000) >= thresh
  float keep_scale;    // fp32(1 / (1 - rate))
  const int* seed;     // one int32 on the device
};

__device__ __forceinline__ uint32_t mix_seed(uint32_t seed, uint32_t bh) {
  uint32_t h = seed ^ (bh * 0x9E3779B1u);
  h *= 0x85EBCA6Bu;
  h ^= h >> 7;
  h *= 0xC2B2AE35u;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ bool keep(uint32_t seed_bh, int row, int col,
                                     int sk, int thresh) {
  uint32_t h = (static_cast<uint32_t>(row) * static_cast<uint32_t>(sk) +
                static_cast<uint32_t>(col)) ^ seed_bh;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return static_cast<int>(h ^ 0x80000000u) >= thresh;
}

// The additive bias, the segment words and the dbias output of a launch
// (the reference's `has_bias`, `has_seg` / `seg_causal` and `emit_dbias`).
//   bias: fp32, element (b, h, q, k) at b*sb + h*sh + q*sq + k*sk; the
//     wrapper passes a broadcast view, with stride 0 on broadcast dims, so
//     no broadcast dim is materialised. Added to scale * (q . k) before the
//     masks.
//   qseg / kseg: [B, Sq] / [B, Sk] int32 words (`_encode_seg`): segment id
//     in the high bits, the end-relative position biased by 0x8000 in the
//     low 16. Query i sees key j iff their ids match and, under
//     seg_causal, klow <= qlow (the per-segment diagonal).
//   dbias: the dq pass writes ds (fp32, before its bf16 rounding) into a
//     zeroed [B, Hq, Sq, Sk] buffer; tiles it skips stay zero.
// Every read of bias or segment words, and every dbias store, is guarded
// to q < Sq and k < Sk: TMA zero-fills the tiles' ragged edges, plain
// loads do not.
struct Mask {
  const float* bias;                 // NULL: no bias
  long long sb, sh, sq, sk;
  const int* qseg;                   // NULL: no segments
  const int* kseg;
  int seg_causal;
  float* dbias;                      // NULL: not emitted
};

__device__ __forceinline__ float bias_at(const Mask& mk, int b, int h, int q,
                                         int k) {
  return mk.bias[b * mk.sb + h * mk.sh + q * mk.sq + k * mk.sk];
}

// Query word qw sees key word kw (segment ids in the high bits).
__device__ __forceinline__ bool seg_sees(int qw, int kw, int seg_causal) {
  return (qw >> 16) == (kw >> 16) &&
         (!seg_causal || (kw & 0xFFFF) <= (qw & 0xFFFF));
}

// The operands of one launch: a forward fills out / lse_out, a dq pass
// dout / lse / delta / out (dq), a dkv pass dout / lse / delta / dk / dv.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out, *dk, *dv;
  float* lse_out;
  Dims dm;
  float scale;
  int causal;
  Dropout dr;
  Mask mk;
};

inline Args make_args(const void* q, const void* k, const void* v, int B,
                      int Sq, int Sk, int Hq, int Hk, int D, float scale,
                      int causal, int drop_on, int thresh, float keep_scale,
                      const void* seed, const void* bias, long long sb,
                      long long sh, long long sq, long long sk,
                      const void* qseg, const void* kseg, int seg_causal) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dm = Dims{B, Sq, Sk, Hq, Hk, D};
  a.scale = scale;
  a.causal = causal;
  a.dr = Dropout{drop_on, thresh, keep_scale, static_cast<const int*>(seed)};
  a.mk = Mask{static_cast<const float*>(bias), sb, sh, sq, sk,
              static_cast<const int*>(qseg), static_cast<const int*>(kseg),
              seg_causal, nullptr};
  return a;
}

// The Mask parameters of a C entry, and the same names as make_args's
// arguments.
#define PTK_MASK_PARAMS                                                  \
  const void *bias, long long bias_sb, long long bias_sh,               \
      long long bias_sq, long long bias_sk, const void *qseg,           \
      const void *kseg, int seg_causal
#define PTK_MASK_ARGS \
  bias, bias_sb, bias_sh, bias_sq, bias_sk, qseg, kseg, seg_causal

// The forward's exp2 domain: scores times log2(e), lse = m ln 2 + log l.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU alone (no range fix-up; a result below 2^-126 flushes
// to 0)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the quad of lanes that hold one accumulator row (lanes
// l ^ 1, l ^ 2)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two fp32 values as one bf16x2 register (lo in the low half, to nearest
// even), the packing of an mma.sync or wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once
// (`done` is the flag of one kernel instantiation; no call happens inside
// a graph capture that follows a warm-up launch).
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  done = err == cudaSuccess;
  return err;
}

}  // namespace ptk
