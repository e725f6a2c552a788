// Batched SPD inverse by Newton-Schulz, one thread block per matrix (CUDA,
// sm_90a).
//
// Replaces qppvm_tpu/opt/pallas_linalg.py::_ns_kernel, the TPU kernel that
// pins K and the iterate X in VMEM for the whole iteration loop. It computes
// exactly linalg.spd_inverse_ns(K, iters, refine=0):
//   d = rsqrt(max(diag K, 1e-30)), Ks = d K d^T,
//   X0 = I / max(max column abs-sum of Ks, 1e-30),
//   iters x  X <- X (2I - Ks X),   out = d X d^T.
//
// What bounds it on an H100: 2 * iters dependent dense n x n products per
// matrix, 4 * iters * n^3 flops against 8 n^2 bytes read and written, so it
// is compute-bound (at B 1024, n 64, 26 iterations: 27.9 GFLOP, 0.417 ms at
// the 67 TFLOP/s float32 peak, against 0.010 ms for its 33.5 MB). The
// design follows from that:
//   * one block per matrix (grid = B); Ks, X and one temporary stay in
//     dynamic shared memory for the whole loop (3 n^2 floats: 48 KB at
//     n 64, 23 KB at n 44), so device memory is read once and written once;
//   * 256 threads as a 16 x 16 grid; each thread owns an R x R register tile
//     of every product (R = ceil(n / 16), rows ty + 16 r, columns tx + 16 c),
//     so each step over the inner dimension costs 2R shared loads for R^2
//     FMAs; rows are padded to an odd stride, so the two rows a warp reads
//     fall in different banks;
//   * a product accumulates in registers and stores after a barrier, so
//     X <- X T can overwrite X in place and three buffers suffice;
//   * at R <= 4 (n <= 64) the kernel is held to 64 registers a thread, so
//     four blocks fit on an SM by registers and by shared memory;
//   * the diagonal prescale and the 1-norm are in-block reductions.
// Not done yet (later work): tensor-core (wgmma) products, several matrices
// per block at small n, TMA loads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // the thread grid is kSide x kSide
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 9;   // n <= 144; shared memory caps n at 139 first

__host__ __device__ constexpr int stride(int n) { return n | 1; }

// max that propagates NaN, like jnp.max / torch.amax
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// acc = A B for n x n row-major shared matrices of row stride ld; this
// thread's R x R tile.
template <int R>
__device__ __forceinline__ void tile_product(float (&acc)[R][R], const float* A,
                                             const float* B, int n, int ld) {
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
  for (int k = 0; k < n; ++k) {
    float a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty + kSide * r, j = tx + kSide * r;
      a[r] = i < n ? A[i * ld + k] : 0.f;
      b[r] = j < n ? B[k * ld + j] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// C = A B, or C = 2I - A B with kTwoIMinus. C may alias A or B: every
// thread finishes reading before any thread writes.
template <int R, bool kTwoIMinus>
__device__ void product(float* C, const float* A, const float* B, int n,
                        int ld) {
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  float acc[R][R];
  tile_product<R>(acc, A, B, n, ld);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + kSide * r, j = tx + kSide * c;
      if (i < n && j < n)
        C[i * ld + j] = kTwoIMinus ? (i == j ? 2.f : 0.f) - acc[r][c]
                                   : acc[r][c];
    }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kThreads, R <= 4 ? 4 : 1)
    ns_inverse_kernel(const float* __restrict__ K_all, float* __restrict__ out,
                      int n, int iters) {
  extern __shared__ float sm[];
  const int ld = stride(n);
  float* Ks = sm;
  float* X = Ks + n * ld;
  float* T = X + n * ld;
  float* d = T + n * ld;
  float* red = d + n;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* K = K_all + b * n * n;

  for (int i = tid; i < n; i += kThreads) d[i] = rsqrtf(fmaxf(K[i * n + i], 1e-30f));
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    Ks[i * ld + j] = d[i] * K[idx] * d[j];
  }
  __syncthreads();

  // 1-norm: the largest column abs-sum of Ks
  float cs = -INFINITY;
  for (int j = tid; j < n; j += kThreads) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += fabsf(Ks[i * ld + j]);
    cs = nanmax(cs, s);
  }
  for (int o = 16; o > 0; o >>= 1) cs = nanmax(cs, __shfl_xor_sync(0xffffffffu, cs, o));
  if ((tid & 31) == 0) red[tid >> 5] = cs;
  __syncthreads();
  float norm1 = red[0];
  for (int w = 1; w < kWarps; ++w) norm1 = nanmax(norm1, red[w]);
  const float x0 = 1.f / fmaxf(norm1, 1e-30f);
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    X[i * ld + j] = i == j ? x0 : 0.f;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    product<R, true>(T, Ks, X, n, ld);   // T = 2I - Ks X
    product<R, false>(X, X, T, n, ld);   // X = X T
  }

  float* o = out + b * n * n;
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    o[idx] = d[i] * X[i * ld + j] * d[j];
  }
}

template <int R>
int launch(const float* K, float* out, int B, int n, int iters, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ns_inverse_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_inverse_kernel<R><<<B, kThreads, smem, stream>>>(K, out, n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs for an n x n matrix.
extern "C" int ns_inverse_smem_bytes(int n) {
  return (int)sizeof(float) * (3 * n * stride(n) + n + kWarps);
}

// Largest n the register tiles cover.
extern "C" int ns_inverse_max_n() { return kSide * kMaxR; }

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// K and out: B contiguous row-major n x n float32 matrices.
extern "C" int ns_inverse_launch(const float* K, float* out, int B, int n,
                                 int iters, void* stream) {
  if (B == 0) return 0;
  if (n < 1 || n > kSide * kMaxR) return (int)cudaErrorInvalidValue;
  const size_t smem = ns_inverse_smem_bytes(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch ((n + kSide - 1) / kSide) {
    case 1: return launch<1>(K, out, B, n, iters, smem, s);
    case 2: return launch<2>(K, out, B, n, iters, smem, s);
    case 3: return launch<3>(K, out, B, n, iters, smem, s);
    case 4: return launch<4>(K, out, B, n, iters, smem, s);
    case 5: return launch<5>(K, out, B, n, iters, smem, s);
    case 6: return launch<6>(K, out, B, n, iters, smem, s);
    case 7: return launch<7>(K, out, B, n, iters, smem, s);
    case 8: return launch<8>(K, out, B, n, iters, smem, s);
    default: return launch<9>(K, out, B, n, iters, smem, s);
  }
}
