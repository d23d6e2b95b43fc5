// RMSNorm forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/norms.py `_rms_fwd_kernel` (launched by
// `_rms_fwd`, wrapped by `rms_norm_pallas`). For each row of x viewed as
// [R, N]:
//     inv[r] = rsqrt(mean(x[r]^2) + eps)        (fp32)
//     y[r]   = x[r] * inv[r] * w                (stored in x's dtype)
// x and w are each fp32 or bf16; w may be absent (w = 1). Any N >= 1.
//
// What bounds it: memory at many rows, latency at few. It reads x once
// and writes y once, doing ~4 flops per element. On the decode path (R =
// batch <= 8, N = 4096, fp32) one launch moves about 0.28 MB, an 0.08 us
// bound at 3.35 TB/s, so the launch and the kernel's chain of dependent
// steps set its time. On an NVIDIA H100 80GB HBM3 at 700 W, in a CUDA
// graph (chip_ab.py): an empty kernel of 8 such blocks 0.97 us, 0.66 us
// with programmatic dependent launch; the many-row kernel at [8, 4096]
// fp32 2.26 us, the small-row kernel 1.57 us.
//
// Design. One 256-thread block per row. Each thread loads its share of
// the row with 16-byte vector loads when N and the pointers allow it
// (whole-row scalar loads otherwise), keeps it in registers (4096 fp32
// values over 256 threads is 16 per thread), sums the squares in fp32
// with a warp-shuffle then shared-memory reduction, and writes y from the
// registers, so x is read from memory once. Two routes:
// - many rows (rms_norm_fwd_kernel): w is read after the reduction, as y
//   is written; rows too wide for the register cache re-read x in the
//   second pass;
// - few rows (rms_norm_small_kernel: at most kSmallRows rows, each within
//   the register cache), where the chain is the time: w's vectors load
//   with x's, so there is one dependent memory round trip and not two;
//   the reduction takes one block barrier, not ptk::block_sum's two; and
//   the launch uses programmatic dependent launch (cudaLaunchKernelEx
//   with programmatic stream serialisation; griddepcontrol.wait before
//   the first load), so the blocks are resident when the previous kernel
//   in the stream ends. The partials are added in block_sum's order, so
//   both routes give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// at most this many rows take the small-row route: one block per SM (the
// H100 has 132), so every block starts at once and the kernel's time is
// one block's chain, not the bytes
constexpr long long kSmallRows = 132;

// griddepcontrol.wait: returns once every grid this one depends on (the
// previous kernel in the stream) has finished and its writes are visible
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

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

// The partial sums of the block's warps, added in the order in which
// ptk::block_sum's last warp adds them (a butterfly: lanes i and i + 4,
// then i + 2, then i + 1), so that both routes give the same bits.
__device__ __forceinline__ float sum_partials(const float (&part)[kWarps]) {
  float q[kWarps];
#pragma unroll
  for (int i = 0; i < kWarps; ++i) q[i] = part[i];
#pragma unroll
  for (int off = kWarps / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < off; ++i) q[i] = q[i] + q[i + off];
  return q[0];
}

// The small-row route: rows that fit the register cache (VPT > 0), too
// few to fill the card. One dependent memory round trip (w's vectors
// load with x's, before the reduction) and one block barrier (each warp
// writes its partial, every thread adds the partials itself). Launched
// with programmatic stream serialisation, so its blocks can be resident
// before the previous kernel in the stream has finished: the wait comes
// before the first load, since that kernel may have written x or w.
template <typename TX, typename TW, int VEC, int VPT>
__global__ void __launch_bounds__(kThreads)
rms_norm_small_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      TX* __restrict__ y, float* __restrict__ inv, int n,
                      float eps) {
  wait_for_previous_grid();
  const long long row = blockIdx.x;
  const TX* xr = x + row * n;
  TX* yr = y + row * n;
  const int nvec = n / VEC;

  float xc[VPT][VEC], wc[VPT][VEC];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = threadIdx.x + j * kThreads;
    if (v < nvec) {
      ptk::load_vec<TX, VEC>(xr + v * VEC, xc[j]);
      if (w != nullptr) {
        ptk::load_vec<TW, VEC>(w + v * VEC, wc[j]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) wc[j][k] = 1.f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss += xc[j][k] * xc[j][k];
    }
  }

  __shared__ float part[kWarps];
  ss = ptk::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  const float r = rsqrtf(sum_partials(part) / static_cast<float>(n) + eps);
  if (threadIdx.x == 0) inv[row] = r;

#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = threadIdx.x + j * kThreads;
    if (v < nvec) {
      float out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[k] = xc[j][k] * r * wc[j][k];
      ptk::store_vec<TX, VEC>(yr + v * VEC, out);
    }
  }
}

// An empty kernel of the same launch: the launch's own floor.
__global__ void __launch_bounds__(kThreads) empty_kernel(int pdl) {
  if (pdl) wait_for_previous_grid();
}

// Launch `kernel` with programmatic stream serialisation.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, cudaStream_t s,
                       Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  // read and clear the thread's last error, as the <<<>>> launches do
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename TX, typename TW, int VEC>
cudaError_t launch_vec(const void* x, const void* w, void* y, float* inv,
                       long long rows, int n, float eps, cudaStream_t s) {
  const int per_thread = (n / VEC + kThreads - 1) / kThreads;
  const auto* xp = static_cast<const TX*>(x);
  const auto* wp = static_cast<const TW*>(w);
  auto* yp = static_cast<TX*>(y);
  const dim3 grid(static_cast<unsigned>(rows)), block(kThreads);
  if (rows <= kSmallRows && per_thread <= 8) {
    if (per_thread <= 1)
      return launch_pdl(rms_norm_small_kernel<TX, TW, VEC, 1>, grid, s, xp, wp, yp, inv, n, eps);
    if (per_thread <= 2)
      return launch_pdl(rms_norm_small_kernel<TX, TW, VEC, 2>, grid, s, xp, wp, yp, inv, n, eps);
    if (per_thread <= 4)
      return launch_pdl(rms_norm_small_kernel<TX, TW, VEC, 4>, grid, s, xp, wp, yp, inv, n, eps);
    return launch_pdl(rms_norm_small_kernel<TX, TW, VEC, 8>, grid, s, xp, wp, yp, inv, n, eps);
  }
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

// The launch floor beside the kernels: an empty kernel of `rows` blocks
// of the same size, launched as the small-row route launches (pdl = 1:
// with programmatic stream serialisation, waiting on the previous grid)
// or as the many-row route does (pdl = 0).
extern "C" int rms_norm_floor(long long rows, int pdl, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (pdl) return static_cast<int>(launch_pdl(empty_kernel, grid, s, 1));
  empty_kernel<<<grid, kThreads, 0, s>>>(0);
  return static_cast<int>(cudaGetLastError());
}
