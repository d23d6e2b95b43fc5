// Hard-label softmax cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/cross_entropy.py `_fwd_kernel` (launched
// by `_fwd`) and `_bwd_kernel` (launched by `_bwd_rule` with
// bwd="pallas"), wrapped by `softmax_xent_pallas`. For each row r of the
// logits x viewed as [R, V] (fp32 or bf16) with an int64 label l = lab[r]:
//
//   forward   lse[r]  = m + log(sum_c exp(x[r,c] - m)),  m = max_c x[r,c]
//             loss[r] = lse[r] - x[r,l]  if 0 <= l < V, else 0   (fp32)
//   backward  dx[r,c] = (exp(x[r,c] - lse[r]) - [c == l]) * (g[r] * valid)
//             in x's dtype, valid = 0 <= l < V.
//
// What bounds them: memory. The forward reads x once (the TPU kernel's
// one pass over a VMEM row block); the backward reads x once and writes dx
// once. On the GPT-2 training path ([8192, 50304] bf16, 824 MB) that is
// 0.246 ms for the forward and 0.492 ms for the backward at 3.35 TB/s;
// about four fp32 operations per element are far below the compute peak.
//
// Design. A bf16 row of GPT-2's vocabulary is 100 KB, more than a block
// keeps in registers, so the forward never holds the row: one block per
// row, each thread walks its share in 16-byte vectors (four in flight)
// keeping a running (max m, sum s of exp(x - m)), rescaled by exp(m_old -
// m_new) when its max grows. The threads' pairs then combine by the same
// rule, m = max(m1, m2), s = s1 e^(m1 - m) + s2 e^(m2 - m), across the
// warp (shuffles) and the block (shared memory). A pair whose max is still
// -inf holds nothing and adds 0, not exp(-inf + inf) = NaN. The label's
// logit is read directly, by one thread, and only when the label is valid,
// so a label outside [0, V) is never an address. The backward is one block
// per row writing each element once. Row offsets are 64-bit (R * V passes
// 2^31 at longer contexts). expf/logf, not the fast intrinsics, so the
// result stays within an ulp or two of the plain PyTorch version.
//
// Rows of any alignment (forward). A row that does not start on a 16-byte
// boundary (BERT's V = 30522 in bf16: row r starts at r x 61044 bytes, 0,
// 4, 8 or 12 mod 16; an odd V; a view at a storage offset) is read as
// three parts: a head of at most 16 / sizeof(T) - 1 scalars up to the
// row's first 16-byte boundary, the aligned body in 16-byte vectors (the
// loop above, started at the head's end), and a tail of fewer than one
// vector's scalars. Head and tail are loaded before the body and folded
// into the thread's (m, s) after it, so they add no round trip. An aligned
// row has neither and runs the body alone. Scalar loads for the whole row
// would keep 2 KB in flight per block (four 2-byte loads a thread), the
// body 16 KB: at BERT's [8192, 30522] bf16 logits the forward takes 0.18
// ms against a 0.149 ms bound, scalar loads 0.31 ms (NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke.py). The body's four loads go out, predicated,
// before any is converted (the SASS shows four LDG.E.128 in a row), so
// all four are in flight; eight a thread or 512 threads a block measured
// slower (chip_ab.py). The backward keeps 16-byte vectors only for rows
// that start aligned (V a multiple of 8 for bf16, 4 for fp32, and aligned
// bases) and takes scalar loads for the others.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors each thread has in flight

// Fold U x VEC values into the thread's running (m, s).
template <int U, int VEC>
__device__ __forceinline__ void accumulate(float& m, float& s,
                                           const float (&xv)[U][VEC]) {
  float vm = -INFINITY;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < VEC; ++k) vm = fmaxf(vm, xv[u][k]);
  const float mn = fmaxf(m, vm);
  if (mn == -INFINITY) return;  // nothing but -inf so far: s stays 0
  float acc = s * expf(m - mn);  // m = -inf gives exp(-inf) = 0, s = 0
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc += expf(xv[u][k] - mn);
  m = mn;
  s = acc;
}

// (m, s) <- (m, s) combined with (m2, s2) by the online rule.
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mn = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.f : s * expf(m - mn);
  const float b = m2 == -INFINITY ? 0.f : s2 * expf(m2 - mn);
  m = mn;
  s = a + b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_xent_fwd_kernel(const T* __restrict__ x,
                        const long long* __restrict__ labels,
                        float* __restrict__ loss, float* __restrict__ lse,
                        int n) {
  constexpr int VEC = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* xr = x + row * static_cast<long long>(n);
  // head: the scalars before the row's first 16-byte boundary
  const unsigned mis = reinterpret_cast<uintptr_t>(xr) & 15u;
  const int head = min(n, static_cast<int>(((16u - mis) & 15u) / sizeof(T)));
  const T* xb = xr + head;  // the body, 16-byte aligned
  const int nvec = (n - head) / VEC;
  const int tail = head + nvec * VEC;  // first scalar after the body
  const int nt = blockDim.x;
  const int t = threadIdx.x;

  // one head and one tail scalar per thread, loaded ahead of the body
  const bool edge = t < head || t < n - tail;
  float ht[1][2] = {{-INFINITY, -INFINITY}};
  if (t < head) ht[0][0] = ptk::to_float(xr[t]);
  if (t < n - tail) ht[0][1] = ptk::to_float(xr[tail + t]);

  float m = -INFINITY, s = 0.f;
  for (int base = t; base < nvec; base += kUnroll * nt) {
    float xv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * nt;
      if (v < nvec) {
        ptk::load_vec<T, VEC>(xb + static_cast<long long>(v) * VEC, xv[u]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xv[u][k] = -INFINITY;
      }
    }
    accumulate(m, s, xv);
  }
  if (edge) accumulate(m, s, ht);

  // warp, then block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, m2, s2);
  }
  __shared__ float part_m[32], part_s[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part_m[warp] = m;
    part_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = nt >> 5;
    m = lane < nwarps ? part_m[lane] : -INFINITY;
    s = lane < nwarps ? part_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      combine(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(s);  // an all -inf row: -inf + log 0 = -inf
      const long long lab = labels[row];
      const bool valid = lab >= 0 && lab < n;
      const float picked = valid ? ptk::to_float(xr[lab]) : 0.f;
      loss[row] = valid ? l - picked : 0.f;
      lse[row] = l;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_xent_bwd_kernel(const T* __restrict__ x,
                        const long long* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ g, T* __restrict__ dx,
                        int n) {
  const long long row = blockIdx.x;
  const long long off = row * static_cast<long long>(n);
  const T* xr = x + off;
  T* dr = dx + off;
  const int nvec = n / VEC;
  const int nt = blockDim.x;
  const long long lab = labels[row];
  const float valid = (lab >= 0 && lab < n) ? 1.f : 0.f;
  const float gv = g[row] * valid;
  const float l = lse[row];

  for (int base = threadIdx.x; base < nvec; base += kUnroll * nt) {
    float xv[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * nt;
      if (v < nvec)
        ptk::load_vec<T, VEC>(xr + static_cast<long long>(v) * VEC, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * nt;
      if (v < nvec) {
        float out[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const long long col = static_cast<long long>(v) * VEC + k;
          const float onehot = col == lab ? 1.f : 0.f;
          out[k] = (expf(xv[u][k] - l) - onehot) * gv;
        }
        ptk::store_vec<T, VEC>(dr + static_cast<long long>(v) * VEC, out);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int threads_for(int nvec) {
  // enough warps for the row's vectors, at most kThreads
  const int warps = (nvec + 31) / 32;
  return warps >= kThreads / 32 ? kThreads : warps * 32;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const long long* labels, float* loss,
                       float* lse, long long rows, int n, cudaStream_t s) {
  // at least one warp: a row shorter than a vector is head and tail alone
  const int nvec = n / static_cast<int>(16 / sizeof(T));
  softmax_xent_fwd_kernel<T>
      <<<dim3(static_cast<unsigned>(rows)), threads_for(nvec > 0 ? nvec : 1),
         0, s>>>(static_cast<const T*>(x), labels, loss, lse, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const long long* labels,
                       const float* lse, const float* g, void* dx,
                       long long rows, int n, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>(rows));
  const auto* xp = static_cast<const T*>(x);
  auto* dp = static_cast<T*>(dx);
  if (n % kVec == 0 && aligned16(x) && aligned16(dx)) {
    softmax_xent_bwd_kernel<T, kVec><<<grid, threads_for(n / kVec), 0, s>>>(
        xp, labels, lse, g, dp, n);
  } else {
    softmax_xent_bwd_kernel<T, 1><<<grid, threads_for(n), 0, s>>>(
        xp, labels, lse, g, dp, n);
  }
  return cudaGetLastError();
}

bool bad_shape(long long rows, int n) {
  return n < 1 || rows > 0x7fffffffLL;
}

}  // namespace

// x: [rows, n] of x_dtype; labels: [rows] int64; loss, lse: [rows] fp32.
// Launches on `stream` without synchronising and returns the launch's
// cudaGetLastError() code (0 on success).
extern "C" int softmax_xent_fwd(const void* x, const void* labels,
                                void* loss, void* lse, long long rows, int n,
                                int x_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (bad_shape(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* lp = static_cast<const long long*>(labels);
  auto* lo = static_cast<float*>(loss);
  auto* ls = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == ptk::kFloat32
          ? launch_fwd<float>(x, lp, lo, ls, rows, n, s)
          : launch_fwd<__nv_bfloat16>(x, lp, lo, ls, rows, n, s);
  return static_cast<int>(err);
}

// x, dx: [rows, n] of x_dtype; labels: [rows] int64; lse, g: [rows] fp32.
extern "C" int softmax_xent_bwd(const void* x, const void* labels,
                                const void* lse, const void* g, void* dx,
                                long long rows, int n, int x_dtype,
                                void* stream) {
  if (rows <= 0) return 0;
  if (bad_shape(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* lp = static_cast<const long long*>(labels);
  const auto* ls = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == ptk::kFloat32
          ? launch_bwd<float>(x, lp, ls, gp, dx, rows, n, s)
          : launch_bwd<__nv_bfloat16>(x, lp, ls, gp, dx, rows, n, s);
  return static_cast<int>(err);
}
