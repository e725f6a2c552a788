// Whole-level ADMM QP solve, one thread block per problem (CUDA, sm_90a).
//
// Replaces qppvm_tpu/opt/pallas_qp.py::_level_kernel, the TPU kernel that
// solves one priority level of the whole-body-control cascade for every
// item of a batch. The semantics are those of qppvm_tpu/opt/qp.py::solve
// restricted to the deployed real-time profile (rho_updates = 0,
// polish_rounds = 0, Newton-Schulz inverses, warm-started KKT inverse):
//   Ruiz equilibration of the inequality rows from the originals;
//   elimination of head / tail equality rows (row-normalised Gram matrix,
//   its Jacobi-prescaled NS inverse, NS pseudo-inverse refinement, projector
//   Pn, particular solution x_p); per-row rho; K = Pn M0 Pn + (sigma + pin) I
//   - pin Pn; the warm NS inverse behind the contraction guard (err < 0.9)
//   with the Jacobi-prescaled cold start and its own cold budget, per
//   problem; the diagonal cold start where the inverse ends non-finite;
//   fixed-count ADMM at relaxation alpha; scaled residuals -> carried rho
//   scale clip(rho_in * factor, rho_scale_min, 1e2); unscaling,
//   equality-multiplier recovery, z clip, relative residuals, objective.
//   Every max and clip propagates NaN as jnp.max / jnp.clip do; every NS
//   step is the true product X (2I - K X), never symmetrised.
//
// What bounds it on an H100: one problem is about 1 M dependent FMAs on
// n = 44 matrices (the n^3 products of the KKT build and the NS steps, the
// mat-vecs of 12 ADMM iterations, the small Gram / pseudo-inverse chains),
// with device memory touched once for the inputs and once for the outputs.
// It is latency- and shared-memory-bound, not FMA-bound. The design:
//   * one block per problem (grid = B), 256 threads, the working set
//     (Ps, Pn, K, the NS iterate X, one temporary, the scaled rows, E, E^+,
//     vectors) in dynamic shared memory, about 50 KB at n = 44; rows padded
//     to an odd stride so the rows a warp reads fall in different banks;
//   * products (tile_mm.cuh): the threads form a 16 x 16 grid and each owns
//     an RR x RC register tile of the output (rows ty + 16 r, columns
//     tx + 16 c), so a step over the inner dimension costs RR + RC shared
//     loads for RR RC FMAs; the elementwise step after a product (2I - .,
//     |I - .|, the KKT assembly, I - .) is done in its store; a product
//     accumulates in registers and stores after a barrier, so X <- X T
//     overwrites X; a product covers 16 R rows, so A Pn Kinv (mi rows) runs
//     in blocks of 16 R;
//   * mat-vecs: row i of the output belongs to the 16 lanes with ty = i % 16,
//     which split the columns and sum with 4 shuffles, so all 8 warps work;
//   * ADMM: the loop's fixed matrices enter it as products, x_t = (Pn Kinv)
//     rhs with Pn Kinv in registers in the product layout and z_t = A x_t =
//     (As Pn Kinv) rhs from shared memory, so x_t and z_t come from rhs in
//     one phase and an iteration takes 2 barriers, not 4 (Kinv alone
//     without equalities); the updates of x, z, y ride in the reducing
//     lane's store;
//   * the Gram NS inverse (ne <= 12) runs in warp 0 alone, synchronised by
//     __syncwarp, its operands in shared memory;
//     larger ne take the block-wide products;
//   * at n <= 48 (R = 3) the kernel is held to 64 registers a thread, so
//     4 blocks fit on an SM by registers and by shared memory; thread and
//     block indices are read where used (thread_index) so that offsets
//     derived from them do not stay live across the whole kernel.
// Not done yet (later work): tensor-core products (3xTF32), thread-block
// clusters splitting one problem over several SMs.

#include <cuda_runtime.h>
#include <math.h>

#include "tile_mm.cuh"  // kSide, thread_index, delta, product, product_fit

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 7;       // n <= 112; shared memory caps n at 97 first
constexpr int kGramWarp = 12;  // largest ne whose Gram NS runs in one warp
constexpr int kRed = 8;        // values reduced together by block_reduce
static_assert(kThreads == kSide * kSide, "products and mat-vecs use a 16 x 16 grid");

struct Params {
  const float *P, *q, *A, *l, *u, *wx, *wz, *wy, *wK, *wr;
  float *x, *z, *y, *K, *r, *prim, *dual, *obj;
  int n, m, h, t;
  int iters, warm_iters, cold_iters, scale_iters, pinv_iters, gram_iters;
  float rho, sigma, alpha, rho_adapt_tol, rho_scale_min, eq_pin;
  int z_clip;
};

__host__ __device__ constexpr int stride(int n) { return n | 1; }

// max that propagates NaN from either side, like jnp.max / torch.amax
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// min(max(x, lo), hi) propagating NaN, like jnp.clip / torch.clamp
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// This thread's row and column on the 16 x 16 grid.
__device__ __forceinline__ int grid_row() { return thread_index() / kSide; }
__device__ __forceinline__ int grid_col() { return thread_index() % kSide; }

__device__ __forceinline__ unsigned block_index() {
#ifdef __CUDA_ARCH__
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
#else
  return blockIdx.x;
#endif
}

// Sum / NaN-propagating max over the 16 lanes of a half warp (all 32 lanes
// call it; each half reduces its own).
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction of N values at once: bit k of sum_mask makes v[k] a
// sum, else a NaN-propagating max. Every thread calls it and gets the
// results in v.
template <int N>
__device__ void block_reduce(float (&v)[N], float* red, unsigned sum_mask) {
  static_assert(N <= kRed, "red holds kRed values a warp");
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v[k], o);
      v[k] = (sum_mask >> k & 1) ? v[k] + w : nanmax(v[k], w);
    }
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[(threadIdx.x >> 5) * kRed + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = red[k];
    for (int w = 1; w < kWarps; ++w)
      s = (sum_mask >> k & 1) ? s + red[w * kRed + k] : nanmax(s, red[w * kRed + k]);
    v[k] = s;
  }
}

// Mat-vec on the 16 x 16 grid, no barrier: output o = ty + 16 a belongs to
// the 16 lanes of half warp ty, which split the inner index k = tx + 16 c,
// load(o, k) giving the term; op sums (or maxes) and lane tx = a calls
// epi(o, result). With P > 0 (n_out <= 16 P) the P outputs of a half warp
// run interleaved; P = 0 takes any n_out. For matrices in shared or device
// memory.
template <bool kMax, int P, class Load, class Epi>
__device__ __forceinline__ void spread(int n_out, int n_in, Load load,
                                       Epi epi) {
  const int tid = thread_index(), tx = tid % kSide, ty = tid / kSide;
  if constexpr (P > 0) {
    float s[P];
#pragma unroll
    for (int a = 0; a < P; ++a) s[a] = kMax ? -INFINITY : 0.f;
    for (int k = tx; k < n_in; k += kSide)
#pragma unroll
      for (int a = 0; a < P; ++a) {
        const int o = ty + kSide * a;
        if (o < n_out) s[a] = kMax ? nanmax(s[a], load(o, k)) : s[a] + load(o, k);
      }
#pragma unroll
    for (int a = 0; a < P; ++a) s[a] = kMax ? half_max(s[a]) : half_sum(s[a]);
#pragma unroll
    for (int a = 0; a < P; ++a)
      if (tx == a && ty + kSide * a < n_out) epi(ty + kSide * a, s[a]);
  } else {
    for (int o0 = 0; o0 < n_out; o0 += kSide) {
      const int o = o0 + ty;
      float s = kMax ? -INFINITY : 0.f;
      if (o < n_out)
        for (int k = tx; k < n_in; k += kSide)
          s = kMax ? nanmax(s, load(o, k)) : s + load(o, k);
      s = kMax ? half_max(s) : half_sum(s);
      if (tx == 0 && o < n_out) epi(o, s);
    }
  }
}

// spread<> over outputs of any count (the rows of A, the equalities):
// one interleaved pass where they fit in 16.
template <bool kMax, class Load, class Epi>
__device__ __forceinline__ void spread_rows(int n_out, int n_in, Load load,
                                            Epi epi) {
  if (n_out <= kSide)
    spread<kMax, 1>(n_out, n_in, load, epi);
  else
    spread<kMax, 0>(n_out, n_in, load, epi);
}

// y = M v for an n x n matrix held in registers in the product layout
// (M[r][c] is entry (ty + 16 r, tx + 16 c), 0 outside n x n); v in shared
// memory; epi(i, y_i) on one lane of each row. No barrier.
template <int R, class Epi>
__device__ __forceinline__ void reg_mv(const float (&M)[R][R], const float* v,
                                       int n, Epi epi) {
  const int tid = thread_index(), tx = tid % kSide, ty = tid / kSide;
  float vv[R], s[R];
#pragma unroll
  for (int c = 0; c < R; ++c) vv[c] = tx + kSide * c < n ? v[tx + kSide * c] : 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < R; ++c) s[r] = fmaf(M[r][c], vv[c], s[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = half_sum(s[r]);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (tx == r && ty + kSide * r < n) epi(ty + kSide * r, s[r]);
}

// Loads rows x cols of row-major device memory (row length cols) into
// shared memory of row stride ld, dst[i * ld + j] = f(i, j, src[i][j]),
// with 16-byte loads where cols allows.
template <class F>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int rows, int cols, F f) {
  if ((cols & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int c4 = cols >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int idx = thread_index(); idx < rows * c4; idx += kThreads) {
      const int i = idx / c4, j = (idx - i * c4) * 4;
      const float4 v = __ldg(s4 + idx);
      float* d = dst + i * ld + j;
      d[0] = f(i, j, v.x);
      d[1] = f(i, j + 1, v.y);
      d[2] = f(i, j + 2, v.z);
      d[3] = f(i, j + 3, v.w);
    }
  } else {
    for (int idx = thread_index(); idx < rows * cols; idx += kThreads) {
      const int i = idx / cols, j = idx - i * cols;
      dst[i * ld + j] = f(i, j, __ldg(src + idx));
    }
  }
}

// Row vectors (one value per row of A) are stored interleaved, field f of
// row r at base[r * kRowFields + f]: every field is the base plus a
// constant, which costs no register to keep.
enum RowField { kE, kLs, kUs, kZ, kY, kRho, kAxp, kMt1, kReq, kBes, kBe0, kEt1,
                kFz, kFy, kFax, kRowFields };
struct RowVec {
  float* p;
  __device__ __forceinline__ float& operator[](int r) const { return p[r * kRowFields]; }
};

// The Jacobi-prescaled Gram NS inverse of linalg.spd_inverse_ns for
// ne <= 12, run by warp 0 alone. On entry G (12 x 12) holds the Gram matrix
// in its first ne rows and columns; on exit the inverse d X d. G, the
// iterate Xw and the temporary Tw are 12 x 12, 16-byte aligned and
// zero-padded, so every lane runs the same straight-line code and the
// padding stays zero. Lane (j = lane % 16, hf = lane / 16; lanes j >= 12
// idle) computes rows 2 s + hf of column j of each product, the rows
// interleaved: the left operand's rows by 16-byte loads, the right one's
// column by 4-byte loads. Operands stay in shared memory, so the warp
// holds few registers while the rest of the block waits.
__device__ void gram_ns_warp(float* G, float* Xw, float* Tw, RowVec dg, int ne, int iters) {
  constexpr int kH = kGramWarp / 2;  // rows per lane
  const int lane = threadIdx.x & 31, j = lane % kSide, hf = lane / kSide;
  if (lane < ne) dg[lane] = rsqrtf(nanmax(G[lane * kGramWarp + lane], 1e-30f));
  __syncwarp();
  float cs = 0.f;
#pragma unroll
  for (int s = 0; s < kH; ++s) {
    const int i = 2 * s + hf;
    const float v = (i < ne && j < ne) ? dg[i] * G[i * kGramWarp + j] * dg[j] : 0.f;
    if (j < kGramWarp) G[i * kGramWarp + j] = v;
    cs += fabsf(v);
  }
  cs += __shfl_xor_sync(0xffffffffu, cs, 16);
  float norm1 = j < ne ? cs : -INFINITY;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    norm1 = nanmax(norm1, __shfl_xor_sync(0xffffffffu, norm1, o));
  const float g0 = 1.f / nanmax(norm1, 1e-30f);
#pragma unroll
  for (int s = 0; s < kH; ++s)
    if (j < kGramWarp)
      Xw[(2 * s + hf) * kGramWarp + j] = (2 * s + hf == j && j < ne) ? g0 : 0.f;
  __syncwarp();

  // acc[s] = sum_k L[2 s + hf][k] Rt[k][j] over the 4-wide chunks that
  // hold the first ne columns
  auto rows_times_col = [&](const float* L, const float* Rt, float (&acc)[kH]) {
    const int nk4 = (ne + 3) / 4;
#pragma unroll
    for (int s = 0; s < kH; ++s) acc[s] = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < kGramWarp / 4; ++k4)
      if (k4 < nk4) {
        float c[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) c[u] = j < kGramWarp ? Rt[(4 * k4 + u) * kGramWarp + j] : 0.f;
#pragma unroll
        for (int s = 0; s < kH; ++s)
          if (2 * s < ne) {  // rows 2 s and 2 s + 1: the same for the warp
            const float4 g =
                *reinterpret_cast<const float4*>(L + (2 * s + hf) * kGramWarp + 4 * k4);
            acc[s] = fmaf(g.x, c[0], acc[s]);
            acc[s] = fmaf(g.y, c[1], acc[s]);
            acc[s] = fmaf(g.z, c[2], acc[s]);
            acc[s] = fmaf(g.w, c[3], acc[s]);
          }
      }
  };
  for (int it = 0; it < iters; ++it) {
    float acc[kH];
    rows_times_col(G, Xw, acc);  // T = 2I - G X
#pragma unroll
    for (int s = 0; s < kH; ++s)
      if (j < kGramWarp)
        Tw[(2 * s + hf) * kGramWarp + j] = (2 * s + hf == j ? 2.f : 0.f) - acc[s];
    __syncwarp();
    rows_times_col(Xw, Tw, acc);  // X <- X T
    __syncwarp();  // every lane has read the old X
#pragma unroll
    for (int s = 0; s < kH; ++s)
      if (j < kGramWarp) Xw[(2 * s + hf) * kGramWarp + j] = acc[s];
    __syncwarp();
  }
#pragma unroll
  for (int s = 0; s < kH; ++s) {
    const int i = 2 * s + hf;
    if (i < ne && j < ne) G[i * kGramWarp + j] = dg[i] * Xw[i * kGramWarp + j] * dg[j];
  }
}

// `iters` Newton-Schulz steps X <- X (2I - Km X) on n x n matrices of row
// stride ld, T a temporary; X is updated in place.
template <int R>
__device__ void ns_block(const float* Km, float* X, float* T, int n, int ld,
                         int iters) {
  for (int it = 0; it < iters; ++it) {
    product<R, R, false, false>(
        n, n, n, Km, ld, X, ld, false,
        [&](int r, int c, int i, int j, float v) {
          T[i * ld + j] = 2.f * delta(r, c, i, j) - v;
        });
    product<R, R, false, false>(
        n, n, n, X, ld, T, ld, true,
        [&](int, int, int i, int j, float v) { X[i * ld + j] = v; });
  }
}

// The register-tile size a launch uses for n (instantiated: 3, 4, 6, 7).
__host__ __device__ constexpr int tile_r(int n) {
  return n <= 3 * kSide ? 3 : n <= 4 * kSide ? 4 : n <= 6 * kSide ? 6 : kMaxR;
}

// Shared-memory layout in floats; level_qp_smem_floats gives its size.
struct Layout {
  int gw, nn, tt, as, es, ept, vn, tail;
  __host__ __device__ Layout(int n, int m, int h, int t) {
    const int ne = h + t, mi = m - ne, ld = stride(n), lde = stride(ne);
    gw = (ne > 0 && ne <= kGramWarp) ? kGramWarp * kGramWarp : 0;  // G, Xw, Tw: 16B aligned
    nn = n * ld;
    tt = (mi > n ? mi : n) * ld;  // T also holds diag(rho) As
    as = mi * ld;
    es = ne * ld;
    ept = ne > 0 ? n * lde : 0;
    vn = kSide * tile_r(n);       // stride of the 8 n-vectors
    // A product reads whole 16-row tiles of an operand (16 R rows, or 16
    // where it runs one-tile-wide: As with mi <= 16, Es with ne <= 12; As
    // in blocks of 16 R rows) and up to 16 R columns of its last row, the
    // excess never stored: the regions after a matrix take such reads, and
    // the tail pads the block's allocation where they would run past its end.
    const int mats = 3 * gw + 4 * nn + tt;
    const int body = mats + as + es + ept + 8 * vn + kRowFields * m + kWarps * kRed;
    const int as_rows = mi <= kSide ? kSide : (mi + vn - 1) / vn * vn;
    const int ends[4] = {mats - tt + vn * ld + vn,                        // T
                         mats + as_rows * ld + vn,                        // As
                         mats + as + (ne <= kGramWarp ? kSide : vn) * ld + vn,  // Es
                         mats + as + es + vn * lde + vn};                // E^+
    int end = 0;
    for (int k = 0; k < (ne > 0 ? 4 : 2); ++k) end = ends[k] > end ? ends[k] : end;
    tail = end > body ? end - body : 0;
  }
  __host__ __device__ int floats(int m) const {
    return 3 * gw + 4 * nn + tt + as + es + ept + 8 * vn + kRowFields * m + kWarps * kRed +
           tail;
  }
};

#ifdef LEVEL_QP_PHASES
// clock64() of block 0 at the end of each phase (tools/profile_level_qp.py)
__device__ long long level_qp_clocks[16];
#define PHASE(k) \
  if (blockIdx.x == 0 && threadIdx.x == 0) level_qp_clocks[k] = clock64()
#else
#define PHASE(k)
#endif

template <int R>
__global__ void __launch_bounds__(kThreads, R <= 3 ? 4 : (R == 4 ? 2 : 1))
    level_qp_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  PHASE(0);
  const int n = p.n, m = p.m, h = p.h, t = p.t;
  const int ne = h + t, mi = m - ne;
  const int ld = stride(n), lde = stride(ne);
  // thread indices are read where used (thread_index), not kept live
  const size_t b = blockIdx.x;

  const float* P0 = p.P + b * n * n;
  const float* q0 = p.q + b * n;
  const float* A0 = p.A + b * m * n;
  const float* l0 = p.l + b * m;
  const float* u0 = p.u + b * m;

  const Layout L(n, m, h, t);
  float* Gw = sm;             // Gram matrix / its inverse  12 x 12 (warp path)
  float* Xw = Gw + L.gw;      // Gram NS iterate            12 x 12
  float* Tw = Xw + L.gw;      // Gram NS temporary          12 x 12
  float* Ps = Tw + L.gw;      // scaled P                   n x ld
  float* Pn = Ps + L.nn;      // projector
  float* K = Pn + L.nn;       // KKT matrix, then Pn Kinv
  float* X = K + L.nn;        // NS iterate
  float* T = X + L.nn;        // temporary, max(n, mi) x ld
  float* As = T + L.tt;       // scaled inequality rows     mi x ld
  float* Es = As + L.as;      // normalised equality rows   ne x ld
  float* EpT = Es + L.es;     // pseudo-inverse E^+         n x lde
  // n-vectors at a fixed stride of 16 R, then the interleaved row vectors
  constexpr int VN = kSide * R;
  float* vn = EpT + L.ept;
  float *d = vn, *qs = vn + VN, *qeff = vn + 2 * VN, *xp = vn + 3 * VN;
  float *x = vn + 4 * VN, *vt1 = vn + 5 * VN, *vt2 = vn + 6 * VN, *vt3 = vn + 7 * VN;
  float* vm = vn + 8 * VN;
  const RowVec e{vm + kE}, ls{vm + kLs}, us{vm + kUs}, zz{vm + kZ}, yy{vm + kY},
      rhov{vm + kRho}, axp{vm + kAxp}, mt1{vm + kMt1}, Req{vm + kReq},
      bes{vm + kBes}, be0{vm + kBe0}, et1{vm + kEt1}, fz{vm + kFz}, fy{vm + kFy},
      fax{vm + kFax};
  float* red = vm + kRowFields * m;

  // ---- load; Ruiz equilibration of [P, A_in] (qp.py::_ruiz) ------------
  load_rows(Ps, ld, P0, n, n, [](int, int, float a) { return a; });
  load_rows(As, ld, A0 + h * n, mi, n, [](int, int, float a) { return a; });
  for (int i = thread_index(); i < n; i += kThreads) d[i] = 1.f;
  for (int r = thread_index(); r < mi; r += kThreads) e[r] = 1.f;
  __syncthreads();
  for (int it = 0; it < p.scale_iters; ++it) {
    // column maxima over Ps and As, row maxima over As
    spread<true, R>(n, n + mi,
                    [&](int j, int i) {
                      return fabsf(i < n ? Ps[i * ld + j] : As[(i - n) * ld + j]);
                    },
                    [&](int j, float c) {
                      vt1[j] = 1.f / sqrtf(clip(c, 1e-8f, 1e8f));
                      d[j] *= vt1[j];
                    });
    spread_rows<true>(mi, n, [&](int r, int j) { return fabsf(As[r * ld + j]); },
                      [&](int r, float c) {
                        mt1[r] = 1.f / sqrtf(clip(c, 1e-8f, 1e8f));
                        e[r] *= mt1[r];
                      });
    __syncthreads();
    for (int i = grid_row(); i < n; i += kSide)
      for (int j = grid_col(); j < n; j += kSide) Ps[i * ld + j] = vt1[i] * Ps[i * ld + j] * vt1[j];
    for (int r = grid_row(); r < mi; r += kSide)
      for (int j = grid_col(); j < n; j += kSide) As[r * ld + j] = mt1[r] * As[r * ld + j] * vt1[j];
    __syncthreads();
  }
  // scaled problem from the originals, as qp.py does
  load_rows(Ps, ld, P0, n, n, [&](int i, int j, float a) { return d[i] * a * d[j]; });
  load_rows(As, ld, A0 + h * n, mi, n,
            [&](int r, int j, float a) { return e[r] * a * d[j]; });
  for (int i = thread_index(); i < n; i += kThreads) {
    qs[i] = d[i] * q0[i];
    x[i] = p.wx[b * n + i];  // the warm start, scaled below
  }
  for (int r = thread_index(); r < mi; r += kThreads) {
    ls[r] = e[r] * l0[h + r];
    us[r] = e[r] * u0[h + r];
    zz[r] = p.wz[b * m + h + r];
    yy[r] = p.wy[b * m + h + r];
  }
  PHASE(1);

  // ---- equality elimination (scaled) ------------------------------------
  if (ne > 0) {
    // rows [0, h) and [m - t, m) of A are the equalities, b_e = l there
    load_rows(Es, ld, A0, h, n, [&](int, int j, float a) { return a * d[j]; });
    load_rows(Es + h * ld, ld, A0 + (m - t) * n, t, n,
              [&](int, int j, float a) { return a * d[j]; });
    for (int r = thread_index(); r < ne; r += kThreads) be0[r] = l0[r < h ? r : (m - t) + (r - h)];
    __syncthreads();
    spread_rows<false>(ne, n, [&](int r, int j) { return Es[r * ld + j] * Es[r * ld + j]; },
                       [&](int r, float s) {
                         Req[r] = rsqrtf(s + 1e-12f);
                         bes[r] = Req[r] * be0[r];
                       });
    __syncthreads();
    for (int r = grid_row(); r < ne; r += kSide)
      for (int j = grid_col(); j < n; j += kSide) Es[r * ld + j] *= Req[r];
    __syncthreads();
    PHASE(2);

    // Gram G = Es Es^T + 1e-6 I and its Jacobi-prescaled NS inverse
    // (linalg.spd_inverse_ns, 24 + 2 iterations)
    const float* Gi;  // the inverse, row stride ldgi
    int ldgi;
    if (ne <= kGramWarp) {
      product<1, 1, false, true>(
          ne, ne, n, Es, ld, Es, ld, false,
          [&](int r, int c, int i, int j, float s) {
            Gw[i * kGramWarp + j] = s + 1e-6f * delta(r, c, i, j);
          });
      if (thread_index() < 32) gram_ns_warp(Gw, Xw, Tw, et1, ne, p.gram_iters);
      __syncthreads();
      Gi = Gw;
      ldgi = kGramWarp;
    } else {
      // block-wide: G in T, the iterate in X, the temporary in K
      product<R, R, false, true>(
          ne, ne, n, Es, ld, Es, ld, false,
          [&](int r, int c, int i, int j, float s) {
            T[i * lde + j] = s + 1e-6f * delta(r, c, i, j);
          });
      for (int r = thread_index(); r < ne; r += kThreads)
        et1[r] = rsqrtf(nanmax(T[r * lde + r], 1e-30f));
      __syncthreads();
      for (int r = grid_row(); r < ne; r += kSide)
        for (int s = grid_col(); s < ne; s += kSide) {
          T[r * lde + s] = et1[r] * T[r * lde + s] * et1[s];
          X[r * lde + s] = 0.f;
        }
      __syncthreads();
      float cs[1] = {-INFINITY};
      spread<false, R>(ne, ne, [&](int s, int r) { return fabsf(T[r * lde + s]); },
                       [&](int, float a) { cs[0] = nanmax(cs[0], a); });
      block_reduce(cs, red, 0u);
      const float g0 = 1.f / nanmax(cs[0], 1e-30f);
      for (int r = thread_index(); r < ne; r += kThreads) X[r * lde + r] = g0;
      __syncthreads();
      ns_block<R>(T, X, K, ne, lde, p.gram_iters);
      for (int r = grid_row(); r < ne; r += kSide)
        for (int s = grid_col(); s < ne; s += kSide)
          T[r * lde + s] = et1[r] * X[r * lde + s] * et1[s];
      __syncthreads();
      Gi = T;
      ldgi = lde;
    }
    PHASE(3);
    // E^+ = Es^T Ginv, then the NS pseudo-inverse refinement
    // E^+ <- E^+ (2I - Es E^+); the temporary in X (row stride lde)
    product_fit<R, true, false>(n, ne, ne, Es, ld, Gi, ldgi, false,
                                [&](int, int, int i, int j, float s) { EpT[i * lde + j] = s; });
    for (int it = 0; it < p.pinv_iters; ++it) {
      product_fit<R, false, false>(
          ne, ne, n, Es, ld, EpT, lde, false,
          [&](int r, int c, int i, int j, float s) {
            X[i * lde + j] = 2.f * delta(r, c, i, j) - s;
          });
      product_fit<R, false, false>(n, ne, ne, EpT, lde, X, lde, true,
                                   [&](int, int, int i, int j, float s) { EpT[i * lde + j] = s; });
    }
    PHASE(4);
    // Pn = I - E^+ Es
    product<R, R, false, false>(
        n, n, ne, EpT, lde, Es, ld, false,
        [&](int r, int c, int i, int j, float s) {
          Pn[i * ld + j] = delta(r, c, i, j) - s;
        });
    // x_p = E^+ b + E^+ (b - Es E^+ b)
    spread<false, R>(n, ne, [&](int i, int r) { return EpT[i * lde + r] * bes[r]; },
                     [&](int i, float s) { xp[i] = s; });
    __syncthreads();
    spread_rows<false>(ne, n, [&](int r, int j) { return Es[r * ld + j] * xp[j]; },
                       [&](int r, float s) { et1[r] = bes[r] - s; });
    __syncthreads();
    spread<false, R>(n, ne, [&](int i, int r) { return EpT[i * lde + r] * et1[r]; },
                     [&](int i, float s) { xp[i] += s; });
    __syncthreads();
    spread_rows<false>(mi, n, [&](int r, int j) { return As[r * ld + j] * xp[j]; },
                       [&](int r, float s) {
                         axp[r] = s;
                         ls[r] -= s;
                         us[r] -= s;
                         zz[r] = e[r] * zz[r] - s;
                         yy[r] = yy[r] / nanmax(e[r], 1e-30f);
                       });
    spread<false, R>(n, n, [&](int i, int j) { return Ps[i * ld + j] * xp[j]; },
                     [&](int i, float s) {
                       vt1[i] = qs[i] + s;
                       vt2[i] = x[i] / d[i] - xp[i];
                     });
    __syncthreads();
    spread<false, R>(n, n, [&](int i, int j) { return Pn[i * ld + j] * vt1[j]; },
                     [&](int i, float s) { qeff[i] = s; });
    spread<false, R>(n, n, [&](int i, int j) { return Pn[i * ld + j] * vt2[j]; },
                     [&](int i, float s) { x[i] = s; });
  } else {
    for (int i = thread_index(); i < n; i += kThreads) {
      qeff[i] = qs[i];
      x[i] = x[i] / d[i];
    }
    for (int r = thread_index(); r < mi; r += kThreads) {
      zz[r] = e[r] * zz[r];
      yy[r] = yy[r] / nanmax(e[r], 1e-30f);
    }
  }
  __syncthreads();
  PHASE(5);

  // ---- per-row rho (qp.py::_rho_vec) and the carried scale --------------
  const float rho_scale = clip(p.wr[block_index()], p.rho_scale_min, 1.f);
  auto rho_of = [&](int r) {
    float base = (us[r] - ls[r]) < 1e-8f ? p.rho * 1e3f : p.rho;
    if (ls[r] < -1e12f && us[r] > 1e12f) base = p.rho * 1e-6f;
    return base * rho_scale;
  };
  for (int r = thread_index(); r < mi; r += kThreads) {
    rhov[r] = rho_of(r);
    mt1[r] = rhov[r] * zz[r] - yy[r];
  }
  // (A^T diag(rho))^T = diag(rho) A, rounded as qp.py rounds A^T * rho
  for (int r = grid_row(); r < mi; r += kSide) {
    const float rr = rho_of(r);
    for (int j = grid_col(); j < n; j += kSide) T[r * ld + j] = As[r * ld + j] * rr;
  }
  __syncthreads();

  // ---- KKT matrix --------------------------------------------------------
  // M0 = Ps + (As^T diag(rho)) As; the diagonal gives pin, or without
  // equalities the Jacobi scale of the NS cold start
  float tr[1] = {0.f};
  product<R, R, true, false>(n, n, mi, T, ld, As, ld, false,
                             [&](int r, int c, int i, int j, float s) {
                               const float pij = Ps[i * ld + j];
                               const float w = ne > 0 ? pij + s
                                                      : (pij + p.sigma * delta(r, c, i, j)) + s;
                               K[i * ld + j] = w;
                               if (r == c && i == j) {
                                 tr[0] += w;
                                 vt1[i] = 1.f / nanmax(w, 1e-30f);  // dinv
                                 vt2[i] = sqrtf(vt1[i]);
                               }
                             });
  if (ne > 0) {
    block_reduce(tr, red, 1u);
    const float pin = p.eq_pin * (tr[0] / n);
    product<R, R, false, false>(n, n, n, Pn, ld, K, ld, false,
                                [&](int, int, int i, int j, float s) { T[i * ld + j] = s; });
    product<R, R, false, false>(n, n, n, T, ld, Pn, ld, false,
                                [&](int r, int c, int i, int j, float s) {
                                  const float dij = delta(r, c, i, j);
                                  const float w =
                                      (s + p.sigma * dij) + pin * (dij - Pn[i * ld + j]);
                                  K[i * ld + j] = w;
                                  if (r == c && i == j) {
                                    vt1[i] = 1.f / nanmax(w, 1e-30f);
                                    vt2[i] = sqrtf(vt1[i]);
                                  }
                                });
  }
  PHASE(6);

  // ---- guarded warm Newton-Schulz inverse (qp.py::_ns_warm) -------------
  load_rows(X, ld, p.wK + size_t(block_index()) * n * n, n, n,
            [](int, int, float a) { return a; });
  __syncthreads();
  product<R, R, false, false>(
      n, n, n, X, ld, K, ld, false,
      [&](int r, int c, int i, int j, float s) {
        T[i * ld + j] = fabsf(delta(r, c, i, j) - s);
      });
  // ||I - X K||_1, ||I - X K||_inf and ||D K D||_1
  float nrm[3] = {-INFINITY, -INFINITY, -INFINITY};
  spread<false, R>(n, n, [&](int j, int i) { return T[i * ld + j]; },
                   [&](int, float s) { nrm[0] = nanmax(nrm[0], s); });
  spread<false, R>(n, n, [&](int i, int j) { return T[i * ld + j]; },
                   [&](int, float s) { nrm[1] = nanmax(nrm[1], s); });
  spread<false, R>(n, n, [&](int j, int i) { return fabsf(K[i * ld + j]) * vt2[i] * vt2[j]; },
                   [&](int, float s) { nrm[2] = nanmax(nrm[2], s); });
  block_reduce(nrm, red, 0u);
  float err = sqrtf(nrm[0] * nrm[1]);
  if (!isfinite(err)) err = 2.f;
  const float knorm = nanmax(nrm[2], 1e-30f);
  int ns_iters = p.warm_iters;
  if (!(err < 0.9f)) {  // the cold start D^2 / ||D K D||_1
    for (int i = grid_row(); i < n; i += kSide)
      for (int j = grid_col(); j < n; j += kSide) X[i * ld + j] = i == j ? vt1[i] / knorm : 0.f;
    if (p.cold_iters >= 0) ns_iters = p.cold_iters;
    __syncthreads();
  }
  PHASE(7);
  ns_block<R>(K, X, T, n, ld, ns_iters);
  PHASE(8);

  // Kinv, or the cold start where it is not finite; then written out
  int bad = 0;
  for (int i = grid_row(); i < n; i += kSide)
    for (int j = grid_col(); j < n; j += kSide) bad |= !isfinite(X[i * ld + j]);
  if (__syncthreads_or(bad)) {
    for (int i = grid_row(); i < n; i += kSide)
      for (int j = grid_col(); j < n; j += kSide) X[i * ld + j] = i == j ? vt1[i] / knorm : 0.f;
    __syncthreads();
  }
  float* Kout = p.K + size_t(block_index()) * n * n;
  for (int idx = thread_index(); idx < n * n; idx += kThreads) {
    const int i = idx / n;
    Kout[idx] = X[i * ld + idx - i * n];
  }

  // The ADMM loop's fixed matrices: x_t = Pn Kinv rhs (Kinv alone without
  // equalities) in registers, and z_t = A x_t = (As Pn Kinv) rhs in T, so
  // an iteration takes two mat-vec phases
  const float* PK = X;
  if (ne > 0) {
    product<R, R, false, false>(n, n, n, Pn, ld, X, ld, false,
                                [&](int, int, int i, int j, float s) { K[i * ld + j] = s; });
    PK = K;
  }
  // one product covers VN rows: more take blocks of VN (the loop kept off
  // the common path holds the kernel at 64 registers without spills)
  if (mi <= VN)
    product_fit<R, false, false>(mi, n, n, As, ld, PK, ld, false,
                                 [&](int, int, int i, int j, float s) { T[i * ld + j] = s; });
  else
    for (int r0 = 0; r0 < mi; r0 += VN)
      product<R, R, false, false>(
          mi - r0, n, n, As + r0 * ld, ld, PK, ld, false,
          [&](int, int, int i, int j, float s) { T[(r0 + i) * ld + j] = s; });
  float pk[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = grid_row() + kSide * r, j = grid_col() + kSide * c;
      pk[r][c] = i < n && j < n ? PK[i * ld + j] : 0.f;
    }
  PHASE(9);

  // ---- ADMM (single rho chunk) -------------------------------------------
  // mt1 holds rho z - y; the reducing lane of each row applies its update
  const float alpha = p.alpha, sigma = p.sigma;
  for (int it = 0; it < p.iters; ++it) {
    spread<false, R>(n, mi, [&](int j, int r) { return As[r * ld + j] * mt1[r]; },
                     [&](int j, float s) { vt1[j] = sigma * x[j] - qeff[j] + s; });
    __syncthreads();
    reg_mv(pk, vt1, n, [&](int i, float s) { x[i] = alpha * s + (1.f - alpha) * x[i]; });
    spread_rows<false>(mi, n, [&](int r, int j) { return T[r * ld + j] * vt1[j]; },
                       [&](int r, float s) {
                         const float zr = alpha * s + (1.f - alpha) * zz[r];
                         const float zn = clip(zr + yy[r] / rhov[r], ls[r], us[r]);
                         const float yn = yy[r] + rhov[r] * (zr - zn);
                         yy[r] = yn;
                         zz[r] = zn;
                         mt1[r] = rhov[r] * zn - yn;
                       });
    __syncthreads();
  }
  PHASE(10);

  // ---- scaled residuals -> carried rho scale -----------------------------
  spread_rows<false>(mi, n, [&](int r, int j) { return As[r * ld + j] * x[j]; },
                     [&](int r, float s) { mt1[r] = s; });  // Ax
  spread<false, R>(n, n, [&](int i, int j) { return Ps[i * ld + j] * x[j]; },
                   [&](int i, float s) { vt1[i] = s; });  // Px
  spread<false, R>(n, mi, [&](int j, int r) { return As[r * ld + j] * yy[r]; },
                   [&](int j, float s) { vt2[j] = s; });  // A^T y
  __syncthreads();
  // max |Ax - z|, |Ax|, |z|, |Px|, |A^T y|, |q|, |stat|
  float rs[7] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY,
                -INFINITY, -INFINITY, -INFINITY};
  for (int r = thread_index(); r < mi; r += kThreads) {
    rs[0] = nanmax(rs[0], fabsf(mt1[r] - zz[r]));
    rs[1] = nanmax(rs[1], fabsf(mt1[r]));
    rs[2] = nanmax(rs[2], fabsf(zz[r]));
  }
  for (int i = thread_index(); i < n; i += kThreads) {
    vt3[i] = vt1[i] + qeff[i] + vt2[i];
    rs[3] = nanmax(rs[3], fabsf(vt1[i]));
    rs[4] = nanmax(rs[4], fabsf(vt2[i]));
    rs[5] = nanmax(rs[5], fabsf(qeff[i]));
    if (ne == 0) rs[6] = nanmax(rs[6], fabsf(vt3[i]));
  }
  if (ne > 0) {
    __syncthreads();
    spread<false, R>(n, n, [&](int i, int j) { return Pn[i * ld + j] * vt3[j]; },
                     [&](int, float s) { rs[6] = nanmax(rs[6], fabsf(s)); });
  }
  block_reduce(rs, red, 0u);
  const float prim_s = rs[0] / (nanmax(rs[1], rs[2]) + 1.f);
  const float dual_s = rs[6] / (nanmax(nanmax(rs[3], rs[4]), rs[5]) + 1.f);
  float factor = clip(sqrtf(prim_s / nanmax(dual_s, 1e-12f)), 0.1f, 10.f);
  if (!(nanmax(prim_s, dual_s) > p.rho_adapt_tol)) factor = 1.f;
  const float rho_out = clip(rho_scale * factor, p.rho_scale_min, 1e2f);

  // ---- unscale + equality-multiplier recovery ----------------------------
  // the final x goes to vt2; full-length z / y to fz / fy
  if (ne > 0) {
    for (int i = thread_index(); i < n; i += kThreads) {
      vt1[i] = x[i] + xp[i];  // xs
      vt2[i] = d[i] * vt1[i];
    }
    __syncthreads();
    // the same lane reduces row i of both: P xs + q + A^T y
    spread<false, R>(n, n, [&](int i, int j) { return Ps[i * ld + j] * vt1[j]; },
                     [&](int i, float s) { vt3[i] = s; });
    spread<false, R>(n, mi, [&](int j, int r) { return As[r * ld + j] * yy[r]; },
                     [&](int j, float s) { vt3[j] = vt3[j] + qs[j] + s; });
    __syncthreads();
    spread_rows<false>(ne, n, [&](int r, int j) { return EpT[j * lde + r] * vt3[j]; },
                       [&](int r, float s) {
                         const int row = r < h ? r : (m - t) + (r - h);
                         fz[row] = be0[r];
                         fy[row] = Req[r] * -s;
                       });
    for (int r = thread_index(); r < mi; r += kThreads) {
      fz[h + r] = (zz[r] + axp[r]) / nanmax(e[r], 1e-30f);
      fy[h + r] = e[r] * yy[r];
    }
  } else {
    for (int i = thread_index(); i < n; i += kThreads) vt2[i] = d[i] * x[i];
    for (int r = thread_index(); r < mi; r += kThreads) {
      fz[r] = zz[r] / nanmax(e[r], 1e-30f);
      fy[r] = e[r] * yy[r];
    }
  }
  __syncthreads();

  // ---- z clip, relative residuals and objective on the original problem --
  const size_t bf = block_index();
  const float* xo = vt2;
  const float* P0f = p.P + bf * n * n;
  const float* A0f = p.A + bf * m * n;
  const float* q0f = p.q + bf * n;
  spread_rows<false>(m, n, [&](int r, int j) { return __ldg(A0f + r * n + j) * xo[j]; },
                     [&](int r, float s) {
                       fax[r] = s;
                       if (p.z_clip) fz[r] = clip(s, p.l[bf * m + r], p.u[bf * m + r]);
                     });
  spread<false, R>(n, n, [&](int i, int j) { return __ldg(P0f + i * n + j) * xo[j]; },
                   [&](int i, float s) { vt1[i] = s; });  // P0 x
  spread<false, R>(n, m, [&](int j, int r) { return __ldg(A0f + r * n + j) * fy[r]; },
                   [&](int j, float s) { vt3[j] = s; });  // A0^T y
  __syncthreads();
  // max |Ax - z|, |Ax|, |z|, |P x + q + A^T y|, |P x|, |A^T y|, |q|; objective
  float fr[8] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY,
                 -INFINITY, -INFINITY, -INFINITY, 0.f};
  for (int r = thread_index(); r < m; r += kThreads) {
    fr[0] = nanmax(fr[0], fabsf(fax[r] - fz[r]));
    fr[1] = nanmax(fr[1], fabsf(fax[r]));
    fr[2] = nanmax(fr[2], fabsf(fz[r]));
  }
  for (int j = thread_index(); j < n; j += kThreads) {
    fr[3] = nanmax(fr[3], fabsf(vt1[j] + q0f[j] + vt3[j]));
    fr[4] = nanmax(fr[4], fabsf(vt1[j]));
    fr[5] = nanmax(fr[5], fabsf(vt3[j]));
    fr[6] = nanmax(fr[6], fabsf(q0f[j]));
    fr[7] += 0.5f * xo[j] * vt1[j] + q0f[j] * xo[j];
  }
  block_reduce(fr, red, 1u << 7);

  for (int i = thread_index(); i < n; i += kThreads) p.x[bf * n + i] = xo[i];
  for (int r = thread_index(); r < m; r += kThreads) {
    p.z[bf * m + r] = fz[r];
    p.y[bf * m + r] = fy[r];
  }
  if (thread_index() == 0) {
    p.r[bf] = rho_out;
    p.prim[bf] = fr[0] / (nanmax(fr[1], fr[2]) + 1.f);
    p.dual[bf] = fr[3] / (nanmax(nanmax(fr[4], fr[5]), fr[6]) + 1.f);
    p.obj[bf] = fr[7];
  }
  PHASE(11);
}

template <int R>
int launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  // the shared-memory opt-in, once per device and size
  static int set_for[16] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 16 || set_for[dev] < (int)smem) {
    err = cudaFuncSetAttribute(level_qp_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 16) set_for[dev] = (int)smem;
  }
  level_qp_kernel<R><<<B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef LEVEL_QP_PHASES
// The phase clocks of the last launch's block 0 (16 values), then zeroed.
extern "C" int level_qp_phase_clocks(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, level_qp_clocks, sizeof(long long) * 16);
  if (err != cudaSuccess) return (int)err;
  static const long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(level_qp_clocks, zero, sizeof(zero));
}
#endif

extern "C" int level_qp_smem_floats(int n, int m, int h, int t) {
  return Layout(n, m, h, t).floats(m);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int level_qp_launch(
    const float* P, const float* q, const float* A, const float* l,
    const float* u, const float* wx, const float* wz, const float* wy,
    const float* wK, const float* wr, float* x, float* z, float* y, float* K,
    float* r, float* prim, float* dual, float* obj, int B, int n, int m, int h,
    int t, int iters, int warm_iters, int cold_iters, int scale_iters,
    int pinv_iters, int gram_iters, float rho, float sigma, float alpha,
    float rho_adapt_tol, float rho_scale_min, float eq_pin, int z_clip,
    void* stream) {
  if (B == 0) return 0;
  if (n < 1 || n > kSide * kMaxR || h < 0 || t < 0 || h + t > n || m - h - t < 1)
    return (int)cudaErrorInvalidValue;
  Params p{P, q, A, l, u, wx, wz, wy, wK, wr, x, z, y, K, r, prim, dual, obj,
           n, m, h, t, iters, warm_iters, cold_iters, scale_iters, pinv_iters,
           gram_iters, rho, sigma, alpha, rho_adapt_tol, rho_scale_min, eq_pin,
           z_clip};
  const size_t smem = sizeof(float) * level_qp_smem_floats(n, m, h, t);
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile_r(n)) {
    case 3: return launch<3>(p, B, smem, s);
    case 4: return launch<4>(p, B, smem, s);
    case 6: return launch<6>(p, B, smem, s);
    default: return launch<kMaxR>(p, B, smem, s);
  }
}
