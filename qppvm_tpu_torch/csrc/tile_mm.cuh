// Register-tiled products of small shared-memory matrices for one thread
// block of 256 threads (CUDA, sm_90a).
//
// The threads form a 16 x 16 grid and each owns an RR x RC register tile of
// the output (rows ty + 16 r, columns tx + 16 c), so a step over the inner
// dimension costs RR + RC shared loads for RR RC FMAs. The elementwise step
// that follows a product goes into its store (the epilogue), and a product
// accumulates in registers and stores after a barrier, so X <- X T may
// overwrite X. Rows are best padded to an odd stride, so the rows a warp
// reads fall in different banks.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;  // the thread grid of products and mat-vecs

// Special registers read anew at each call: the compiler neither hoists nor
// shares them, so the offsets a helper derives from them live only inside
// that helper instead of in registers across the whole kernel.
__device__ __forceinline__ int thread_index() {
#ifdef __CUDA_ARCH__
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
#else
  return threadIdx.x;
#endif
}

// The identity at entry (i, j) = (ty + 16 r, tx + 16 c) of a product's tile:
// off the tile's diagonal (r != c) it is 0 at compile time, on it one
// predicate (tx == ty) serves all r, so no per-entry constant is kept live
// across the loops around a product.
__device__ __forceinline__ float delta(int r, int c, int i, int j) {
  return (r == c && i == j) ? 1.f : 0.f;
}

// C = op(A) op(B) for an M x N output with inner dimension K: op(A)[i][k]
// is A[k * lda + i] with TA, else A[i * lda + k]; op(B)[k][j] is
// B[j * ldb + k] with TB, else B[k * ldb + j]. This thread's RR x RC tile
// accumulates in registers; then epi(r, c, i, j, value) stores each entry
// with i < M, j < N. Rows and columns past M and N read whatever lies there
// (never stored; the caller keeps such reads inside the block's shared
// memory), so the loop has no branch. With in_place the block first waits
// until every thread has read its operands, so the epilogue may overwrite A
// or B. Ends with a barrier. Needs M <= 16 RR and N <= 16 RC.
template <int RR, int RC, bool TA, bool TB, class Epi>
__device__ __forceinline__ void product(int M, int N, int K, const float* A,
                                        int lda, const float* B, int ldb,
                                        bool in_place, Epi epi) {
  const int tid = thread_index(), tx = tid % kSide, ty = tid / kSide;
  // this thread's first row / column at k = 0; rows r and columns c follow
  // 16 apart
  const float* a0 = A + (TA ? ty : ty * lda);
  const float* b0 = B + (TB ? tx * ldb : tx);
  const int ra = TA ? kSide : kSide * lda, cb = TB ? kSide * ldb : kSide;
  const int sa = TA ? lda : 1, sb = TB ? 1 : ldb;  // step per k
  float acc[RR][RC];
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[RR], b[RC];
#pragma unroll
    for (int r = 0; r < RR; ++r) a[r] = a0[r * ra + k * sa];
#pragma unroll
    for (int c = 0; c < RC; ++c) b[c] = b0[c * cb + k * sb];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
  if (in_place) __syncthreads();
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int i = ty + kSide * r, j = tx + kSide * c;
      if (i < M && j < N) epi(r, c, i, j, acc[r][c]);
    }
  __syncthreads();
}

// product<> with the narrowest tiles that cover M x N: one 16-wide tile
// where a side is at most 16, else R. Needs M, N <= 16 R.
template <int R, bool TA, bool TB, class Epi>
__device__ __forceinline__ void product_fit(int M, int N, int K,
                                            const float* A, int lda,
                                            const float* B, int ldb,
                                            bool in_place, Epi epi) {
  if (M <= kSide && N <= kSide)
    product<1, 1, TA, TB>(M, N, K, A, lda, B, ldb, in_place, epi);
  else if (N <= kSide)
    product<R, 1, TA, TB>(M, N, K, A, lda, B, ldb, in_place, epi);
  else if (M <= kSide)
    product<1, R, TA, TB>(M, N, K, A, lda, B, ldb, in_place, epi);
  else
    product<R, R, TA, TB>(M, N, K, A, lda, B, ldb, in_place, epi);
}

}  // namespace
