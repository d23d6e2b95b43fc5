// RMSNorm forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/norms.py `_rms_fwd_kernel` (launched by
// `_rms_fwd`, wrapped by `rms_norm_pallas`). For each row of x viewed as
// [R, N]:
//     inv[r] = rsqrt(mean(x[r]^2) + eps)        (fp32)
//     y[r]   = x[r] * inv[r] * w                (stored in x's dtype)
// x and w are each fp32 or bf16; w may be absent (w = 1). Any N >= 1.
//
// What bounds it: memory. It reads x once and writes y once, doing ~4
// flops per element. On the decode path (R = batch <= 8, N = 4096, fp32)
// one launch moves about 0.28 MB, an 0.08 us bound at 3.35 TB/s, so the
// launch latency dominates by two orders of magnitude: the later fix is
// to fuse the norm into its neighbours or to capture each decode step as
// a CUDA graph, not to tune this kernel.
//
// Design (simple and right): one 256-thread block per row. Each thread
// loads its share of the row with 16-byte vector loads when N and the
// pointers allow it (whole-row scalar loads otherwise), keeps it in
// registers (4096 fp32 values over 256 threads is 16 per thread), sums
// the squares in fp32 with a warp-shuffle then shared-memory reduction,
// and writes y from the registers, so x is read from memory once. Rows
// too wide for the register cache re-read x in the second pass.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// VEC: elements per load (16 bytes of TX, or 1 on the scalar path).
// VPT: vectors each thread keeps in registers; 0 means the row is too
// wide for that and the store pass re-reads x.
template <typename TX, typename TW, int VEC, int VPT>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ y, float* __restrict__ inv, int n,
                    float eps) {
  const long long row = blockIdx.x;
  const TX* xr = x + row * n;
  TX* yr = y + row * n;
  const int nvec = n / VEC;

  float cache[VPT > 0 ? VPT : 1][VEC];
  float ss = 0.f;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = threadIdx.x + j * kThreads;
      if (v < nvec) {
        ptk::load_vec<TX, VEC>(xr + v * VEC, cache[j]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) ss += cache[j][k] * cache[j][k];
      }
    }
  } else {
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      float t[VEC];
      ptk::load_vec<TX, VEC>(xr + v * VEC, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss += t[k] * t[k];
    }
  }

  const float r = rsqrtf(ptk::block_sum(ss) / static_cast<float>(n) + eps);
  if (threadIdx.x == 0) inv[row] = r;

  auto emit = [&](int v, float (&xv)[VEC]) {
    float wv[VEC];
    if (w != nullptr) {
      ptk::load_vec<TW, VEC>(w + v * VEC, wv);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) wv[k] = 1.f;
    }
    float out[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = xv[k] * r * wv[k];
    ptk::store_vec<TX, VEC>(yr + v * VEC, out);
  };

  if constexpr (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = threadIdx.x + j * kThreads;
      if (v < nvec) emit(v, cache[j]);
    }
  } else {
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      float t[VEC];
      ptk::load_vec<TX, VEC>(xr + v * VEC, t);
      emit(v, t);
    }
  }
}

template <typename TX, typename TW, int VEC>
cudaError_t launch_vec(const void* x, const void* w, void* y, float* inv,
                       long long rows, int n, float eps, cudaStream_t s) {
  const int per_thread = (n / VEC + kThreads - 1) / kThreads;
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const TW*>(w);
  auto* yp = static_cast<TX*>(y);
  const dim3 grid(static_cast<unsigned>(rows)), block(kThreads);
  if (per_thread <= 1)
    rms_norm_fwd_kernel<TX, TW, VEC, 1><<<grid, block, 0, s>>>(xp, wp, yp, inv, n, eps);
  else if (per_thread <= 2)
    rms_norm_fwd_kernel<TX, TW, VEC, 2><<<grid, block, 0, s>>>(xp, wp, yp, inv, n, eps);
  else if (per_thread <= 4)
    rms_norm_fwd_kernel<TX, TW, VEC, 4><<<grid, block, 0, s>>>(xp, wp, yp, inv, n, eps);
  else if (per_thread <= 8)
    rms_norm_fwd_kernel<TX, TW, VEC, 8><<<grid, block, 0, s>>>(xp, wp, yp, inv, n, eps);
  else
    rms_norm_fwd_kernel<TX, TW, VEC, 0><<<grid, block, 0, s>>>(xp, wp, yp, inv, n, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, float* inv,
                   long long rows, int n, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool vec_ok = n % kVec == 0 && aligned16(x) && aligned16(y) &&
                      (w == nullptr || aligned16(w));
  if (vec_ok) return launch_vec<TX, TW, kVec>(x, w, y, inv, rows, n, eps, s);
  return launch_vec<TX, TW, 1>(x, w, y, inv, rows, n, eps, s);
}

}  // namespace

// x: [rows, n] of x_dtype; w: [n] of w_dtype or NULL; y: like x;
// inv: [rows] fp32. Launches on `stream` without synchronising and
// returns the launch's cudaGetLastError() code (0 on success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y,
                            void* inv, long long rows, int n, float eps,
                            int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (n < 1 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto* invp = static_cast<float*>(inv);
  auto s = static_cast<cudaStream_t>(stream);
  const bool xf = x_dtype == ptk::kFloat32;
  const bool wf = w == nullptr ? xf : w_dtype == ptk::kFloat32;
  cudaError_t err;
  if (xf && wf)
    err = launch<float, float>(x, w, y, invp, rows, n, eps, s);
  else if (xf)
    err = launch<float, __nv_bfloat16>(x, w, y, invp, rows, n, eps, s);
  else if (wf)
    err = launch<__nv_bfloat16, float>(x, w, y, invp, rows, n, eps, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, invp, rows, n, eps, s);
  return static_cast<int>(err);
}
