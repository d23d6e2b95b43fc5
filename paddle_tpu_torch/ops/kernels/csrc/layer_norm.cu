// LayerNorm forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/norms.py `_ln_fwd_kernel` (launched by
// `_ln_fwd`, wrapped by `layer_norm_pallas`). For each row of x viewed as
// [R, N]:
//     mu[r]   = mean(x[r])                                  (fp32)
//     rstd[r] = rsqrt(mean((x[r] - mu[r])^2) + eps)         (fp32)
//     y[r]    = (x[r] - mu[r]) * rstd[r] * w + b            (x's dtype)
// x is fp32 or bf16; w and b share one dtype (fp32 or bf16) and either may
// be absent (w = 1, b = 0). Any N >= 1. mu and rstd are saved for the
// backward, which is plain PyTorch (as the reference's `_ln_bwd` is XLA).
//
// What bounds it: memory. It reads x once and writes y once with ~8 flops
// per element. On the GPT-2 training path (R = 8192 tokens, N = 768,
// bf16) one launch moves about 25 MB, a 7.5 us bound at 3.35 TB/s.
//
// Design (the RMSNorm kernel's, rms_norm.cu): one block per row, 128
// threads when the row has at most 128 vectors (GPT-2's 768 bf16 is 96
// vectors of 8) and 256 otherwise. Each thread keeps its share of the row
// in registers after 16-byte vector loads (scalar loads when N or the
// pointers do not allow them), so x is read from memory once; the mean
// and then the centred sum of squares are block reductions (warp shuffle,
// then shared memory). Rows too wide for the register cache re-read x.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// VEC: elements per load (16 bytes of TX, or 1 on the scalar path).
// VPT: vectors each thread keeps in registers; 0 means the row is too
// wide for that and the later passes re-read x.
template <typename TX, typename TW, int VEC, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const TW* __restrict__ b, TX* __restrict__ y,
                      float* __restrict__ mu_out,
                      float* __restrict__ rstd_out, int n, float eps) {
  const long long row = blockIdx.x;
  const TX* xr = x + row * n;
  TX* yr = y + row * n;
  const int nvec = n / VEC;
  const int nt = blockDim.x;

  float cache[VPT > 0 ? VPT : 1][VEC];
  float s = 0.f;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = threadIdx.x + j * nt;
      if (v < nvec) {
        ptk::load_vec<TX, VEC>(xr + v * VEC, cache[j]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) s += cache[j][k];
      }
    }
  } else {
    for (int v = threadIdx.x; v < nvec; v += nt) {
      float t[VEC];
      ptk::load_vec<TX, VEC>(xr + v * VEC, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += t[k];
    }
  }
  const float mean = ptk::block_sum(s) / static_cast<float>(n);

  float ss = 0.f;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = threadIdx.x + j * nt;
      if (v < nvec) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float d = cache[j][k] - mean;
          ss += d * d;
        }
      }
    }
  } else {
    for (int v = threadIdx.x; v < nvec; v += nt) {
      float t[VEC];
      ptk::load_vec<TX, VEC>(xr + v * VEC, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = t[k] - mean;
        ss += d * d;
      }
    }
  }
  const float rstd =
      rsqrtf(ptk::block_sum(ss) / static_cast<float>(n) + eps);
  if (threadIdx.x == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }

  auto emit = [&](int v, float (&xv)[VEC]) {
    float wv[VEC], bv[VEC];
    if (w != nullptr) {
      ptk::load_vec<TW, VEC>(w + v * VEC, wv);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) wv[k] = 1.f;
    }
    if (b != nullptr) {
      ptk::load_vec<TW, VEC>(b + v * VEC, bv);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) bv[k] = 0.f;
    }
    float out[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      out[k] = (xv[k] - mean) * rstd * wv[k] + bv[k];
    ptk::store_vec<TX, VEC>(yr + v * VEC, out);
  };

  if constexpr (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = threadIdx.x + j * nt;
      if (v < nvec) emit(v, cache[j]);
    }
  } else {
    for (int v = threadIdx.x; v < nvec; v += nt) {
      float t[VEC];
      ptk::load_vec<TX, VEC>(xr + v * VEC, t);
      emit(v, t);
    }
  }
}

template <typename TX, typename TW, int VEC>
cudaError_t launch_vec(const void* x, const void* w, const void* b, void* y,
                       float* mu, float* rstd, long long rows, int n,
                       float eps, cudaStream_t s) {
  const int nvec = n / VEC;
  const int threads = nvec <= 128 ? 128 : kMaxThreads;
  const int per_thread = (nvec + threads - 1) / threads;
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const TW*>(w);
  const auto* bp = static_cast<const TW*>(b);
  auto* yp = static_cast<TX*>(y);
  const dim3 grid(static_cast<unsigned>(rows)), block(threads);
  if (per_thread <= 1)
    layer_norm_fwd_kernel<TX, TW, VEC, 1><<<grid, block, 0, s>>>(xp, wp, bp, yp, mu, rstd, n, eps);
  else if (per_thread <= 2)
    layer_norm_fwd_kernel<TX, TW, VEC, 2><<<grid, block, 0, s>>>(xp, wp, bp, yp, mu, rstd, n, eps);
  else if (per_thread <= 4)
    layer_norm_fwd_kernel<TX, TW, VEC, 4><<<grid, block, 0, s>>>(xp, wp, bp, yp, mu, rstd, n, eps);
  else if (per_thread <= 8)
    layer_norm_fwd_kernel<TX, TW, VEC, 8><<<grid, block, 0, s>>>(xp, wp, bp, yp, mu, rstd, n, eps);
  else
    layer_norm_fwd_kernel<TX, TW, VEC, 0><<<grid, block, 0, s>>>(xp, wp, bp, yp, mu, rstd, n, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   float* mu, float* rstd, long long rows, int n, float eps,
                   cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  // a TW vector of kVec elements is 16 bytes (fp32) or 8 (bf16 under an
  // fp32 x): both need the parameter rows 16-byte aligned
  const bool vec_ok = n % kVec == 0 && aligned16(x) && aligned16(y) &&
                      (w == nullptr || aligned16(w)) &&
                      (b == nullptr || aligned16(b));
  if (vec_ok)
    return launch_vec<TX, TW, kVec>(x, w, b, y, mu, rstd, rows, n, eps, s);
  return launch_vec<TX, TW, 1>(x, w, b, y, mu, rstd, rows, n, eps, s);
}

}  // namespace

// x: [rows, n] of x_dtype; w, b: [n] of w_dtype, each may be NULL; y: like
// x; mu, rstd: [rows] fp32. Launches on `stream` without synchronising and
// returns the launch's cudaGetLastError() code (0 on success).
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mu, void* rstd, long long rows,
                              int n, float eps, int x_dtype, int w_dtype,
                              void* stream) {
  if (rows <= 0) return 0;
  if (n < 1 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto* mup = static_cast<float*>(mu);
  auto* rsp = static_cast<float*>(rstd);
  auto s = static_cast<cudaStream_t>(stream);
  const bool xf = x_dtype == ptk::kFloat32;
  const bool wf = (w == nullptr && b == nullptr) ? xf
                                                 : w_dtype == ptk::kFloat32;
  cudaError_t err;
  if (xf && wf)
    err = launch<float, float>(x, w, b, y, mup, rsp, rows, n, eps, s);
  else if (xf)
    err = launch<float, __nv_bfloat16>(x, w, b, y, mup, rsp, rows, n, eps, s);
  else if (wf)
    err = launch<__nv_bfloat16, float>(x, w, b, y, mup, rsp, rows, n, eps, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, mup, rsp, rows, n, eps, s);
  return static_cast<int>(err);
}
