// What the two flash-attention sources share: the problem's dimensions, the
// dropout parameters and hash, the launch arguments, and the opt-in to
// more than 48 KB of dynamic shared memory.
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
};

inline Args make_args(const void* q, const void* k, const void* v, int B,
                      int Sq, int Sk, int Hq, int Hk, int D, float scale,
                      int causal, int drop_on, int thresh, float keep_scale,
                      const void* seed) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dm = Dims{B, Sq, Sk, Hq, Hk, D};
  a.scale = scale;
  a.causal = causal;
  a.dr = Dropout{drop_on, thresh, keep_scale, static_cast<const int*>(seed)};
  return a;
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
