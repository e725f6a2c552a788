// Whole-level ADMM QP solve, one thread block per problem (CUDA, sm_90a).
//
// Replaces qppvm_tpu/opt/pallas_qp.py::_level_kernel, the TPU kernel that
// solves one priority level of the whole-body-control cascade for every
// item of a batch. The semantics are those of qppvm_tpu/opt/qp.py::solve
// restricted to the deployed real-time profile (rho_updates = 0,
// polish_rounds = 0, Newton-Schulz inverses, warm-started KKT inverse):
//   Ruiz equilibration of the inequality rows; elimination of head / tail
//   equality rows (row-normalised Gram matrix, its Jacobi-prescaled NS
//   inverse, NS pseudo-inverse refinement, projector Pn, particular
//   solution x_p); per-row rho; K = Pn M0 Pn + (sigma + pin) I - pin Pn;
//   the warm NS inverse behind the contraction guard with the
//   Jacobi-prescaled cold start and its own cold budget; fixed-count ADMM
//   at relaxation alpha; scaled residuals -> carried rho scale; unscaling,
//   equality-multiplier recovery, z clip, relative residuals, objective.
//
// What bounds it on an H100: the dense n x n products of the KKT build and
// the Newton-Schulz iterations (about 2 n^3 FMAs each, some 20 of them per
// solve at n = 44), each reading both operands from shared memory. Device
// memory is touched twice per problem: the inputs once, the outputs once.
// The design follows from that:
//   * one block per QP (grid = B), the whole working set (P, Pn, K, the NS
//     iterate, two temporaries, the scaled rows, E and E^+, the vectors)
//     resident in dynamic shared memory for the entire solve: about 54 KB
//     at n = 44, m = 18, so the kernel opts in above the 48 KB default;
//   * the block's threads split the output entries of each small product
//     and accumulate with plain f32 FMAs; reductions go through warp
//     shuffles and shared memory;
//   * each block takes its own branch of the warm / cold guard, exactly the
//     per-problem lax.cond of qp.py, so unlike the TPU kernel no lane is
//     frozen at another lane's iteration count;
//   * every product is a true product X (2I - K X) (no contraction through a
//     transposed operand), so NS iterates are not re-symmetrised; the
//     reference does not symmetrise either.
// Not done yet (later work): wgmma / tensor-core products, TMA loads, and
// several problems per block to lift occupancy at large n.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float *P, *q, *A, *l, *u, *wx, *wz, *wy, *wK, *wr;
  float *x, *z, *y, *K, *r, *prim, *dual, *obj;
  int n, m, h, t;
  int iters, warm_iters, cold_iters, scale_iters, pinv_iters, gram_iters;
  float rho, sigma, alpha, rho_adapt_tol, rho_scale_min, eq_pin;
  int z_clip;
};

// max that propagates NaN from either side, like jnp.max / torch.amax
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// min(max(x, lo), hi) propagating NaN, like jnp.clip / torch.clamp
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// Block-wide sum or max; every thread must call it and gets the result.
__device__ float block_reduce(float v, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? nanmax(v, w) : v + w;
  }
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = is_max ? nanmax(r, red[i]) : r + red[i];
  return r;
}

// Row-major products in shared memory; outputs never alias inputs.
// C[M x N] = A[M x K] B[K x N]
__device__ void mm(float* C, const float* A, const float* B, int M, int K,
                   int N) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(A[i * K + k], B[k * N + j], s);
    C[idx] = s;
  }
  __syncthreads();
}

// C[M x N] = A^T B with A [K x M]
__device__ void mm_tn(float* C, const float* A, const float* B, int M, int K,
                      int N) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(A[k * M + i], B[k * N + j], s);
    C[idx] = s;
  }
  __syncthreads();
}

// C[M x N] = A B^T with B [N x K]
__device__ void mm_nt(float* C, const float* A, const float* B, int M, int K,
                      int N) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(A[i * K + k], B[j * K + k], s);
    C[idx] = s;
  }
  __syncthreads();
}

// y[M] = A[M x K] x
__device__ void mv(float* y, const float* A, const float* x, int M, int K) {
  for (int i = threadIdx.x; i < M; i += kThreads) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(A[i * K + k], x[k], s);
    y[i] = s;
  }
  __syncthreads();
}

// y[N] = A^T x with A [K x N]
__device__ void mtv(float* y, const float* A, const float* x, int K, int N) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(A[k * N + j], x[k], s);
    y[j] = s;
  }
  __syncthreads();
}

// M <- 2I - M (square, in place)
__device__ void two_i_minus(float* M, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    M[idx] = (i == j ? 2.f : 0.f) - M[idx];
  }
  __syncthreads();
}

// X <- diag(dg)
__device__ void set_diag(float* X, const float* dg, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    X[idx] = i == j ? dg[i] : 0.f;
  }
  __syncthreads();
}

// `iters` Newton-Schulz steps X <- X (2I - K X); returns the buffer holding
// the result (X or out, which are swapped each step).
__device__ float* ns_steps(const float* K, float* X, float* tmp, float* out,
                           int n, int iters) {
  for (int it = 0; it < iters; ++it) {
    mm(tmp, K, X, n, n, n);
    two_i_minus(tmp, n);
    mm(out, X, tmp, n, n, n);
    float* s = X;
    X = out;
    out = s;
  }
  return X;
}

__device__ float vec_absmax(const float* v, int len, float* red) {
  float a = -INFINITY;
  for (int i = threadIdx.x; i < len; i += kThreads) a = nanmax(a, fabsf(v[i]));
  return block_reduce(a, red, true);
}

__global__ void __launch_bounds__(kThreads) level_qp_kernel(Params p) {
  extern __shared__ float sm[];
  const int n = p.n, m = p.m, h = p.h, t = p.t;
  const int ne = h + t, mi = m - ne;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;

  const float* P0 = p.P + b * n * n;
  const float* q0 = p.q + b * n;
  const float* A0 = p.A + b * m * n;
  const float* l0 = p.l + b * m;
  const float* u0 = p.u + b * m;
  const float* wx = p.wx + b * n;
  const float* wz = p.wz + b * m;
  const float* wy = p.wy + b * m;
  const float* wK = p.wK + b * n * n;

  // shared layout; level_qp_smem_floats below gives its size
  float* Ps = sm;             // scaled P          n x n
  float* Pn = Ps + n * n;     // projector         n x n
  float* K = Pn + n * n;      // KKT matrix        n x n
  float* X = K + n * n;       // NS iterate        n x n
  float* T1 = X + n * n;      // temporaries       n x n
  float* T2 = T1 + n * n;
  float* As = T2 + n * n;     // scaled inequality rows  mi x n
  float* Es = As + mi * n;    // normalised equality rows ne x n
  float* EpT = Es + ne * n;   // pseudo-inverse E^+       n x ne
  float* v = EpT + n * ne;
  float *d = v, *qs = v + n, *qeff = v + 2 * n, *xp = v + 3 * n;
  float *x = v + 4 * n, *vt1 = v + 5 * n, *vt2 = v + 6 * n, *vt3 = v + 7 * n;
  v += 8 * n;
  float *e = v, *ls = v + mi, *us = v + 2 * mi, *zz = v + 3 * mi;
  float *yy = v + 4 * mi, *rhov = v + 5 * mi, *axp = v + 6 * mi;
  float *mt1 = v + 7 * mi, *mt2 = v + 8 * mi;
  v += 9 * mi;
  float *Req = v, *bes = v + ne, *be0 = v + 2 * ne, *nu = v + 3 * ne;
  float *et1 = v + 4 * ne;
  v += 5 * ne;
  float *fz = v, *fy = v + m, *fax = v + 2 * m;
  v += 3 * m;
  float* red = v;

  // ---- load; Ruiz equilibration of [P, A_in] (qp.py::_ruiz) ------------
  for (int i = tid; i < n * n; i += kThreads) Ps[i] = P0[i];
  for (int i = tid; i < mi * n; i += kThreads) As[i] = A0[h * n + i];
  for (int i = tid; i < n; i += kThreads) d[i] = 1.f;
  for (int r = tid; r < mi; r += kThreads) e[r] = 1.f;
  __syncthreads();
  for (int it = 0; it < p.scale_iters; ++it) {
    for (int j = tid; j < n; j += kThreads) {
      float c = -INFINITY;
      for (int i = 0; i < n; ++i) c = nanmax(c, fabsf(Ps[i * n + j]));
      for (int r = 0; r < mi; ++r) c = nanmax(c, fabsf(As[r * n + j]));
      vt1[j] = 1.f / sqrtf(clip(c, 1e-8f, 1e8f));
    }
    for (int r = tid; r < mi; r += kThreads) {
      float c = -INFINITY;
      for (int j = 0; j < n; ++j) c = nanmax(c, fabsf(As[r * n + j]));
      mt1[r] = 1.f / sqrtf(clip(c, 1e-8f, 1e8f));
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) d[i] *= vt1[i];
    for (int r = tid; r < mi; r += kThreads) e[r] *= mt1[r];
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, j = idx - i * n;
      Ps[idx] = vt1[i] * Ps[idx] * vt1[j];
    }
    for (int idx = tid; idx < mi * n; idx += kThreads) {
      const int r = idx / n, j = idx - r * n;
      As[idx] = mt1[r] * As[idx] * vt1[j];
    }
    __syncthreads();
  }
  // scaled problem from the originals, as qp.py does
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    Ps[idx] = d[i] * P0[idx] * d[j];
  }
  for (int idx = tid; idx < mi * n; idx += kThreads) {
    const int r = idx / n, j = idx - r * n;
    As[idx] = e[r] * A0[(h + r) * n + j] * d[j];
  }
  for (int i = tid; i < n; i += kThreads) qs[i] = d[i] * q0[i];
  for (int r = tid; r < mi; r += kThreads) {
    ls[r] = e[r] * l0[h + r];
    us[r] = e[r] * u0[h + r];
  }
  __syncthreads();

  // ---- equality elimination (scaled) ------------------------------------
  if (ne > 0) {
    // rows [0, h) and [m - t, m) of A are the equalities, b_e = l there
    for (int idx = tid; idx < ne * n; idx += kThreads) {
      const int r = idx / n, j = idx - r * n;
      const int row = r < h ? r : (m - t) + (r - h);
      Es[idx] = A0[row * n + j] * d[j];
    }
    for (int r = tid; r < ne; r += kThreads)
      be0[r] = l0[r < h ? r : (m - t) + (r - h)];
    __syncthreads();
    for (int r = tid; r < ne; r += kThreads) {
      float s = 0.f;
      for (int j = 0; j < n; ++j) s += Es[r * n + j] * Es[r * n + j];
      Req[r] = 1.f / sqrtf(s + 1e-12f);
    }
    __syncthreads();
    for (int idx = tid; idx < ne * n; idx += kThreads) Es[idx] *= Req[idx / n];
    for (int r = tid; r < ne; r += kThreads) bes[r] = Req[r] * be0[r];
    __syncthreads();

    // Gram G = Es Es^T + 1e-6 I, inverted by the Jacobi-prescaled NS of
    // linalg.spd_inverse_ns (24 + 2 iterations)
    mm_nt(T1, Es, Es, ne, n, ne);
    for (int r = tid; r < ne; r += kThreads) {
      T1[r * ne + r] += 1e-6f;
      et1[r] = 1.f / sqrtf(fmaxf(T1[r * ne + r], 1e-30f));
    }
    __syncthreads();
    for (int idx = tid; idx < ne * ne; idx += kThreads) {
      const int r = idx / ne, s = idx - r * ne;
      T1[idx] = et1[r] * T1[idx] * et1[s];
    }
    __syncthreads();
    float cs = -INFINITY;
    for (int s = tid; s < ne; s += kThreads) {
      float a = 0.f;
      for (int r = 0; r < ne; ++r) a += fabsf(T1[r * ne + s]);
      cs = nanmax(cs, a);
    }
    const float g0 = 1.f / fmaxf(block_reduce(cs, red, true), 1e-30f);
    for (int idx = tid; idx < ne * ne; idx += kThreads) {
      const int r = idx / ne, s = idx - r * ne;
      X[idx] = r == s ? g0 : 0.f;
    }
    __syncthreads();
    float* G = ns_steps(T1, X, T2, K, ne, p.gram_iters);
    for (int idx = tid; idx < ne * ne; idx += kThreads) {
      const int r = idx / ne, s = idx - r * ne;
      T2[idx] = et1[r] * G[idx] * et1[s];  // Ginv (G is X or K, not T2)
    }
    __syncthreads();
    mm_tn(EpT, Es, T2, n, ne, ne);  // E^+ = Es^T Ginv

    // NS pseudo-inverse refinement E^+ <- E^+ (2I - Es E^+)
    for (int it = 0; it < p.pinv_iters; ++it) {
      mm(T1, Es, EpT, ne, n, ne);
      two_i_minus(T1, ne);
      mm(T2, EpT, T1, n, ne, ne);
      for (int i = tid; i < n * ne; i += kThreads) EpT[i] = T2[i];
      __syncthreads();
    }
    mm(Pn, EpT, Es, n, ne, n);
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, j = idx - i * n;
      Pn[idx] = (i == j ? 1.f : 0.f) - Pn[idx];
    }
    __syncthreads();
    mv(xp, EpT, bes, n, ne);
    mv(et1, Es, xp, ne, n);
    for (int r = tid; r < ne; r += kThreads) et1[r] = bes[r] - et1[r];
    __syncthreads();
    mv(vt1, EpT, et1, n, ne);
    for (int i = tid; i < n; i += kThreads) xp[i] += vt1[i];
    __syncthreads();
    mv(axp, As, xp, mi, n);
    mv(vt1, Ps, xp, n, n);
    for (int i = tid; i < n; i += kThreads) vt1[i] = qs[i] + vt1[i];
    __syncthreads();
    mv(qeff, Pn, vt1, n, n);
    for (int i = tid; i < n; i += kThreads) vt2[i] = wx[i] / d[i] - xp[i];
    for (int r = tid; r < mi; r += kThreads) {
      ls[r] -= axp[r];
      us[r] -= axp[r];
      zz[r] = e[r] * wz[h + r] - axp[r];
      yy[r] = wy[h + r] / fmaxf(e[r], 1e-30f);
    }
    __syncthreads();
    mv(x, Pn, vt2, n, n);
  } else {
    for (int i = tid; i < n; i += kThreads) {
      qeff[i] = qs[i];
      x[i] = wx[i] / d[i];
    }
    for (int r = tid; r < mi; r += kThreads) {
      zz[r] = e[r] * wz[r];
      yy[r] = wy[r] / fmaxf(e[r], 1e-30f);
    }
    __syncthreads();
  }

  // ---- per-row rho (qp.py::_rho_vec) and the carried scale --------------
  const float rho_scale = clip(p.wr[b], p.rho_scale_min, 1.f);
  for (int r = tid; r < mi; r += kThreads) {
    float base = (us[r] - ls[r]) < 1e-8f ? p.rho * 1e3f : p.rho;
    if (ls[r] < -1e12f && us[r] > 1e12f) base = p.rho * 1e-6f;
    rhov[r] = base * rho_scale;
  }
  __syncthreads();

  // ---- KKT matrix --------------------------------------------------------
  // M0 = Ps + (As^T diag(rho)) As
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    float s = 0.f;
    for (int r = 0; r < mi; ++r) s = fmaf(As[r * n + i] * rhov[r], As[r * n + j], s);
    K[idx] = ne > 0 ? Ps[idx] + s : (Ps[idx] + (i == j ? p.sigma : 0.f)) + s;
  }
  __syncthreads();
  if (ne > 0) {
    float tr = 0.f;
    for (int i = tid; i < n; i += kThreads) tr += K[i * n + i];
    const float pin = p.eq_pin * (block_reduce(tr, red, false) / n);
    mm(T1, Pn, K, n, n, n);
    mm(T2, T1, Pn, n, n, n);
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, j = idx - i * n;
      const float dij = i == j ? 1.f : 0.f;
      K[idx] = (T2[idx] + p.sigma * dij) + pin * (dij - Pn[idx]);
    }
    __syncthreads();
  }

  // ---- guarded warm Newton-Schulz inverse (qp.py::_ns_warm) -------------
  for (int i = tid; i < n * n; i += kThreads) X[i] = wK[i];
  __syncthreads();
  mm(T1, X, K, n, n, n);
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    T1[idx] = fabsf((i == j ? 1.f : 0.f) - T1[idx]);
  }
  __syncthreads();
  float colmax = -INFINITY, rowmax = -INFINITY, knorm = -INFINITY;
  for (int j = tid; j < n; j += kThreads) {
    float c = 0.f, rs = 0.f;
    for (int i = 0; i < n; ++i) {
      c += T1[i * n + j];
      rs += T1[j * n + i];
    }
    colmax = nanmax(colmax, c);
    rowmax = nanmax(rowmax, rs);
    vt1[j] = 1.f / fmaxf(K[j * n + j], 1e-30f);  // dinv
    vt2[j] = sqrtf(vt1[j]);
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    float c = 0.f;
    for (int i = 0; i < n; ++i) c += fabsf(K[i * n + j]) * vt2[i] * vt2[j];
    knorm = nanmax(knorm, c);
  }
  colmax = block_reduce(colmax, red, true);
  rowmax = block_reduce(rowmax, red, true);
  knorm = block_reduce(knorm, red, true);
  float err = sqrtf(colmax * rowmax);
  if (!isfinite(err)) err = 2.f;
  for (int i = tid; i < n; i += kThreads) vt3[i] = vt1[i] / fmaxf(knorm, 1e-30f);
  __syncthreads();
  const bool warm_ok = err < 0.9f;
  int ns_iters = p.warm_iters;
  if (!warm_ok) {
    set_diag(X, vt3, n);
    if (p.cold_iters >= 0) ns_iters = p.cold_iters;
  }
  float* Kinv = ns_steps(K, X, T1, T2, n, ns_iters);
  int bad = 0;
  for (int i = tid; i < n * n; i += kThreads) bad |= !isfinite(Kinv[i]);
  if (__syncthreads_or(bad)) set_diag(Kinv, vt3, n);

  // ---- ADMM (single rho chunk) -------------------------------------------
  const float alpha = p.alpha, sigma = p.sigma;
  const float* xt = ne > 0 ? vt3 : vt2;
  for (int it = 0; it < p.iters; ++it) {
    for (int r = tid; r < mi; r += kThreads) mt1[r] = rhov[r] * zz[r] - yy[r];
    __syncthreads();
    mtv(vt1, As, mt1, mi, n);
    for (int i = tid; i < n; i += kThreads) vt1[i] = sigma * x[i] - qeff[i] + vt1[i];
    __syncthreads();
    mv(vt2, Kinv, vt1, n, n);
    if (ne > 0) mv(vt3, Pn, vt2, n, n);  // keep drift out of null(Pn)
    mv(mt2, As, xt, mi, n);
    for (int i = tid; i < n; i += kThreads)
      x[i] = alpha * xt[i] + (1.f - alpha) * x[i];
    for (int r = tid; r < mi; r += kThreads) {
      const float zr = alpha * mt2[r] + (1.f - alpha) * zz[r];
      const float zn = clip(zr + yy[r] / rhov[r], ls[r], us[r]);
      yy[r] = yy[r] + rhov[r] * (zr - zn);
      zz[r] = zn;
    }
    __syncthreads();
  }

  // ---- scaled residuals -> carried rho scale -----------------------------
  mv(mt1, As, x, mi, n);    // Ax
  mv(vt1, Ps, x, n, n);     // Px
  mtv(vt2, As, yy, mi, n);  // A^T y
  for (int r = tid; r < mi; r += kThreads) mt2[r] = mt1[r] - zz[r];
  for (int i = tid; i < n; i += kThreads) vt3[i] = vt1[i] + qeff[i] + vt2[i];
  __syncthreads();
  const float prim_s = vec_absmax(mt2, mi, red) /
      (fmaxf(vec_absmax(mt1, mi, red), vec_absmax(zz, mi, red)) + 1.f);
  const float dual_den = fmaxf(fmaxf(vec_absmax(vt1, n, red),
                                     vec_absmax(vt2, n, red)),
                               vec_absmax(qeff, n, red)) + 1.f;
  const float* stat = vt3;
  if (ne > 0) {
    mv(vt1, Pn, vt3, n, n);
    stat = vt1;
  }
  const float dual_s = vec_absmax(stat, n, red) / dual_den;
  float factor = clip(sqrtf(prim_s / fmaxf(dual_s, 1e-12f)), 0.1f, 10.f);
  if (!(nanmax(prim_s, dual_s) > p.rho_adapt_tol)) factor = 1.f;
  const float rho_out = clip(rho_scale * factor, p.rho_scale_min, 1e2f);

  // ---- unscale + equality-multiplier recovery ----------------------------
  // the final x goes to vt2; full-length z / y to fz / fy
  if (ne > 0) {
    for (int i = tid; i < n; i += kThreads) vt1[i] = x[i] + xp[i];  // xs
    __syncthreads();
    mv(vt3, Ps, vt1, n, n);
    mtv(vt2, As, yy, mi, n);
    for (int i = tid; i < n; i += kThreads) vt3[i] = vt3[i] + qs[i] + vt2[i];
    __syncthreads();
    mtv(nu, EpT, vt3, n, ne);  // (E^+)^T (P xs + q + A^T y)
    for (int i = tid; i < n; i += kThreads) vt2[i] = d[i] * vt1[i];
    for (int r = tid; r < mi; r += kThreads) {
      fz[h + r] = (zz[r] + axp[r]) / fmaxf(e[r], 1e-30f);
      fy[h + r] = e[r] * yy[r];
    }
    for (int r = tid; r < ne; r += kThreads) {
      const int row = r < h ? r : (m - t) + (r - h);
      fz[row] = be0[r];
      fy[row] = Req[r] * -nu[r];
    }
  } else {
    for (int i = tid; i < n; i += kThreads) vt2[i] = d[i] * x[i];
    for (int r = tid; r < mi; r += kThreads) {
      fz[r] = zz[r] / fmaxf(e[r], 1e-30f);
      fy[r] = e[r] * yy[r];
    }
  }
  __syncthreads();

  // ---- z clip, relative residuals and objective on the original problem --
  const float* xo = vt2;
  for (int r = tid; r < m; r += kThreads) {
    float s = 0.f;
    for (int j = 0; j < n; ++j) s = fmaf(A0[r * n + j], xo[j], s);
    fax[r] = s;
    if (p.z_clip) fz[r] = clip(s, l0[r], u0[r]);
  }
  for (int j = tid; j < n; j += kThreads) {
    float s = 0.f, a = 0.f;
    for (int i = 0; i < n; ++i) s = fmaf(P0[j * n + i], xo[i], s);
    for (int r = 0; r < m; ++r) a = fmaf(A0[r * n + j], fy[r], a);
    vt1[j] = s;  // P0 x
    vt3[j] = a;  // A0^T y
  }
  __syncthreads();
  float pr = -INFINITY, ax = -INFINITY, zx = -INFINITY;
  for (int r = tid; r < m; r += kThreads) {
    pr = nanmax(pr, fabsf(fax[r] - fz[r]));
    ax = nanmax(ax, fabsf(fax[r]));
    zx = nanmax(zx, fabsf(fz[r]));
  }
  pr = block_reduce(pr, red, true);
  ax = block_reduce(ax, red, true);
  zx = block_reduce(zx, red, true);
  float st = -INFINITY, px = -INFINITY, aty = -INFINITY, qx = -INFINITY;
  float ob = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    st = nanmax(st, fabsf(vt1[j] + q0[j] + vt3[j]));
    px = nanmax(px, fabsf(vt1[j]));
    aty = nanmax(aty, fabsf(vt3[j]));
    qx = nanmax(qx, fabsf(q0[j]));
    ob += 0.5f * xo[j] * vt1[j] + q0[j] * xo[j];
  }
  st = block_reduce(st, red, true);
  px = block_reduce(px, red, true);
  aty = block_reduce(aty, red, true);
  qx = block_reduce(qx, red, true);
  ob = block_reduce(ob, red, false);

  for (int i = tid; i < n; i += kThreads) p.x[b * n + i] = xo[i];
  for (int r = tid; r < m; r += kThreads) {
    p.z[b * m + r] = fz[r];
    p.y[b * m + r] = fy[r];
  }
  for (int i = tid; i < n * n; i += kThreads) p.K[b * n * n + i] = Kinv[i];
  if (tid == 0) {
    p.r[b] = rho_out;
    p.prim[b] = pr / (fmaxf(ax, zx) + 1.f);
    p.dual[b] = st / (fmaxf(fmaxf(px, aty), qx) + 1.f);
    p.obj[b] = ob;
  }
}

}  // namespace

extern "C" int level_qp_smem_floats(int n, int m, int h, int t) {
  const int ne = h + t, mi = m - ne;
  return 6 * n * n + mi * n + 2 * ne * n + 8 * n + 9 * mi + 5 * ne + 3 * m +
         kWarps;
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
  Params p{P, q, A, l, u, wx, wz, wy, wK, wr, x, z, y, K, r, prim, dual, obj,
           n, m, h, t, iters, warm_iters, cold_iters, scale_iters, pinv_iters,
           gram_iters, rho, sigma, alpha, rho_adapt_tol, rho_scale_min, eq_pin,
           z_clip};
  const size_t smem = sizeof(float) * level_qp_smem_floats(n, m, h, t);
  cudaError_t err = cudaFuncSetAttribute(
      level_qp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  level_qp_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
