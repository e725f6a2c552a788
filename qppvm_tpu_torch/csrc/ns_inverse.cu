// Batched SPD inverse by Newton-Schulz on Hopper's tensor cores, one thread
// block per matrix (CUDA, sm_90a).
//
// Replaces qppvm_tpu/opt/pallas_linalg.py::_ns_kernel, the TPU kernel that
// pins K and the iterate X in VMEM for the whole iteration loop. It computes
// exactly linalg.spd_inverse_ns(K, iters, refine=0):
//   d = rsqrt(max(diag K, 1e-30)), Ks = d K d^T,
//   X0 = I / max(max column abs-sum of Ks, 1e-30)   (NaN propagates),
//   iters x  X <- X (2I - Ks X),   out = d X d^T.
//
// What bounds it on an H100: 2 * iters dependent dense n x n products per
// matrix, 4 * iters * n^3 flops against 8 n^2 bytes read and written. At
// B 1024, n 64, 26 iterations that is 27.9 GFLOP against 33.5 MB: 0.010 ms
// of memory, 0.417 ms of float32 products on the CUDA cores (67 TFLOP/s),
// 0.169 ms as error-compensated 3xTF32 on the tensor cores (3 x 27.9 GFLOP
// at 495 TFLOP/s). It is bound by the tensor cores' rate; the design:
//   * every product is 3xTF32 on mma.sync.m16n8k8 (inline PTX, float32
//     accumulators in registers): x = hi + lo with hi = tf32(x) and
//     lo = tf32(x - hi) (cvt.rna; the subtraction is exact), and
//     A B ~ A_lo B_hi + A_hi B_lo + A_hi B_hi, the two small terms first into
//     the same accumulator. The dropped lo lo term is 2^-22 relative. No
//     iteration runs in plain TF32 (2^-11): NS then stalls far from the
//     float32 inverse;
//   * operands stay float32 in shared memory and are split at load: storing
//     hi and lo would double shared memory (two blocks per SM at n 64 instead
//     of four) to save two cvt and one add per loaded value;
//   * one block of 4 warps per matrix; Ks, X and T stay in dynamic shared
//     memory for the whole loop, so device memory is read once and written
//     once. Each warp owns whole 16-row strips of a product: at n 64 one
//     16 x 64 strip, 8 mma tiles, 32 accumulators. X <- X T runs in place:
//     the rows of X a strip reads as A are its own, read by its warp only,
//     which stores them after __syncwarp. Two block barriers an iteration;
//   * up to n 128 each buffer is padded with zeros to whole 16-row tiles (a
//     zero adds exactly 0 to a product, and no padded entry is ever stored)
//     and swizzled: entry (r, c) lies at r * ld + (c ^ f(r)), ld a multiple
//     of 32, f(r) = ((r & 3) << 3) | (r & 4). A warp's A-fragment load (row
//     g, column t) and its B-fragment load (row t, column g) then each hit
//     32 distinct banks, though X is read as A in one product and as B in
//     the other (a padded stride serves only one of the two, and storing X
//     twice would cost a fourth buffer). Above n 128 the padded buffers do
//     not fit in 227 KB, so they are n x n, loads outside the matrix read
//     zero, and bank conflicts are accepted;
//   * __launch_bounds__(128, 4) at n <= 64: four blocks per SM by registers
//     and by shared memory (49,424 bytes a block at n 64);
//   * the tile loop has no branch and the k-loop is unrolled by two, so a
//     warp keeps eight independent mma chains and the next loads in flight:
//     at B 1 one matrix has only 3 or 4 warps, and latency is what bounds it.
// What bounds it now, on an H100 at B 1024, n 64: about a fifth of the
// 3xTF32 bound (PERF.md). mma.sync issues a warp's 16 x 8 x 8 tiles one at a
// time, and every shared-memory value costs three instructions to split,
// four times over for B (each warp splits all of it). Next step: wgmma
// (warpgroup products from K-major swizzled shared memory) with the operands
// split once, at the epilogue.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNT = 18;     // 8-column tiles a strip holds: n <= 144
constexpr int kPadMaxN = 128;  // largest n with padded, swizzled buffers

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Rows allocated and row stride of each of the three buffers.
__host__ __device__ inline int buf_rows(int n) {
  return n <= kPadMaxN ? round_up(n, 16) : n;
}
__host__ __device__ inline int buf_ld(int n) {
  return n <= kPadMaxN ? round_up(n, 32) : n;
}

// Offset of entry (r, c): swizzled in a padded buffer, plain otherwise.
template <bool kPad>
__device__ __forceinline__ int at(int r, int c, int ld) {
  return r * ld + (kPad ? c ^ (((r & 3) << 3) | (r & 4)) : c);
}

template <bool kPad>
__device__ __forceinline__ float load(const float* S, int r, int c, int n,
                                      int ld) {
  if (kPad) return S[at<true>(r, c, ld)];
  return (r < n && c < n) ? S[r * ld + c] : 0.f;
}

// max that propagates NaN, like jnp.max / torch.amax
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// max(x, lo) that keeps a NaN x, like torch.clamp(x, min=lo)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to 2^-22 relative, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b on one 16 x 8 x 8 tile; fragments as the PTX ISA lays them out
// for lane l, g = l >> 2, t = l & 3: a = (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); b = (k t, col g), (k t+4, col g); d = (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] = rows r0 .. r0 + 15, columns 8j .. 8j + 7 of A B (n x n), in
// 3xTF32. Called by a whole warp. No test inside the loops: a tile past n
// multiplies zeros (padding, or masked loads above kPadMaxN), and a branch
// between tiles would serialise their loads and mma chains.
template <int NT, bool kPad>
__device__ __forceinline__ void strip_product(float (&acc)[NT][4],
                                              const float* A, const float* B,
                                              int r0, int n, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2   // the next k-step's loads overlap this one's mma chains
  for (int k0 = 0; k0 < n; k0 += 8) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(load<kPad>(A, r0 + g + 8 * (e & 1), k0 + t + 4 * (e >> 1), n, ld),
            ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split(load<kPad>(B, k0 + t + 4 * e, 8 * j + g, n, ld), bh[e], bl[e]);
      mma(acc[j], al, bh);
      mma(acc[j], ah, bl);
      mma(acc[j], ah, bh);
    }
  }
}

// Stores the strip of rows r0 .. r0 + 15 from acc: C = acc, or C = 2I - acc
// with kTwoIMinus. Entries outside the matrix are not stored.
template <int NT, bool kPad, bool kTwoIMinus>
__device__ __forceinline__ void store_strip(float* C,
                                            const float (&acc)[NT][4], int r0,
                                            int n, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    // only the two tiles of a strip that hold diagonal entries test for them
    const bool diag = kTwoIMinus && (j >> 1) == (r0 >> 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      if (i < n && c < n) {
        float v = acc[j][e];
        if (kTwoIMinus) v = (diag && i == c ? 2.f : 0.f) - v;
        C[at<kPad>(i, c, ld)] = v;
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 8 ? 4 : 1)
    ns_inverse_kernel(const float* __restrict__ K_all, float* __restrict__ out,
                      int n, int iters) {
  constexpr bool kPad = 8 * NT <= kPadMaxN;
  extern __shared__ float sm[];
  const int ld = buf_ld(n), size = buf_rows(n) * ld;
  float* Ks = sm;
  float* X = Ks + size;
  float* T = X + size;
  float* d = T + size;
  float* red = d + n;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int strips = round_up(n, 16) / 16;
  const size_t b = blockIdx.x;
  const float* K = K_all + b * n * n;

  if (kPad)
    for (int idx = tid; idx < 3 * size; idx += kThreads) sm[idx] = 0.f;
  for (int i = tid; i < n; i += kThreads)
    d[i] = rsqrtf(clamp_min(K[i * n + i], 1e-30f));
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    Ks[at<kPad>(i, j, ld)] = d[i] * K[idx] * d[j];
  }
  __syncthreads();

  // 1-norm: the largest column abs-sum of Ks
  float cs = -INFINITY;
  for (int j = tid; j < n; j += kThreads) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += fabsf(Ks[at<kPad>(i, j, ld)]);
    cs = nanmax(cs, s);
  }
  for (int o = 16; o > 0; o >>= 1)
    cs = nanmax(cs, __shfl_xor_sync(0xffffffffu, cs, o));
  if ((tid & 31) == 0) red[warp] = cs;
  __syncthreads();
  float norm1 = red[0];
  for (int w = 1; w < kWarps; ++w) norm1 = nanmax(norm1, red[w]);
  const float x0 = 1.f / clamp_min(norm1, 1e-30f);
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    X[at<kPad>(i, j, ld)] = (i == j ? 1.f : 0.f) * x0;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int s = warp; s < strips; s += kWarps) {   // T = 2I - Ks X
      float acc[NT][4];
      strip_product<NT, kPad>(acc, Ks, X, 16 * s, n, ld);
      store_strip<NT, kPad, true>(T, acc, 16 * s, n, ld);
    }
    __syncthreads();
    for (int s = warp; s < strips; s += kWarps) {   // X = X T, in place
      float acc[NT][4];
      strip_product<NT, kPad>(acc, X, T, 16 * s, n, ld);
      __syncwarp();
      store_strip<NT, kPad, false>(X, acc, 16 * s, n, ld);
    }
    __syncthreads();
  }

  float* o = out + b * n * n;
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    o[idx] = d[i] * X[at<kPad>(i, j, ld)] * d[j];
  }
}

template <int NT>
int launch(const float* K, float* out, int B, int n, int iters, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ns_inverse_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_inverse_kernel<NT><<<B, kThreads, smem, stream>>>(K, out, n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs for an n x n matrix.
extern "C" int ns_inverse_smem_bytes(int n) {
  return (int)sizeof(float) * (3 * buf_rows(n) * buf_ld(n) + n + kWarps);
}

// Largest n a strip's accumulators cover.
extern "C" int ns_inverse_max_n() { return 8 * kMaxNT; }

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// K and out: B contiguous row-major n x n float32 matrices.
extern "C" int ns_inverse_launch(const float* K, float* out, int B, int n,
                                 int iters, void* stream) {
  if (B == 0) return 0;
  if (n < 1 || n > 8 * kMaxNT) return (int)cudaErrorInvalidValue;
  const size_t smem = ns_inverse_smem_bytes(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (round_up(n, 16) / 16) {
    case 1: return launch<2>(K, out, B, n, iters, smem, s);
    case 2: return launch<4>(K, out, B, n, iters, smem, s);
    case 3: return launch<6>(K, out, B, n, iters, smem, s);
    case 4: return launch<8>(K, out, B, n, iters, smem, s);
    case 5: return launch<10>(K, out, B, n, iters, smem, s);
    case 6: return launch<12>(K, out, B, n, iters, smem, s);
    case 7: return launch<14>(K, out, B, n, iters, smem, s);
    case 8: return launch<16>(K, out, B, n, iters, smem, s);
    default: return launch<18>(K, out, B, n, iters, smem, s);
  }
}
