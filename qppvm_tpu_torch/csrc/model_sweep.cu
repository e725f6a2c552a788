// The model update's recursive sweeps over the kinematic tree in one launch:
// forward kinematics, the nonlinear term h(q, qd) and the classical bias
// accelerations of every link origin (CUDA, sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves these level loops to XLA,
// which fuses each into a few programs; run eagerly, the same recursions
// (kinematics.fk, kinematics.propagate_va twice, rnea's backward index_add
// sweep) cost about a thousand small launches a tick, and the host's time to
// issue them set the tick's pace. Per batch item it computes what
//   kin = kinematics.fk(model, state)
//   h = dynamics.nonlinear_term(model, state)       (RNEA, udot 0, gravity)
//   bias = kinematics.bias_accelerations(model, state)
// compute, in float32 with the plain path's formulas (accurate sinf / cosf,
// no fast-math intrinsics; the compiler's default FMA contraction):
//   1. joint-local transforms from q, axis, E_tree, p_tree (revolute and
//      prismatic);
//   2. world R, p and S_ang = R axis of every link;
//   3. one forward sweep carrying the body-frame velocity v, the
//      acceleration with the gravity base acceleration [0; -R_b^T g] (for h)
//      and the acceleration with a zero base acceleration (for the bias);
//   4. the backward force sweep: tau_i = S_i . f_i, the base's wrench on a
//      floating model (armature drops out at udot 0);
//   5. bias_i = [R a_lin + (R w) x (R v_lin); R a_ang], linear-first.
//
// What bounds it on an H100: neither operations nor bytes. The humanoid (nj
// 32, 10 depth levels) needs about 22 kFLOP and 3.2 KB read and written an
// item: at B 1024, 1.0 us of memory traffic and 0.3 us of float32 work. A
// link's quantities need its parent's, so each item is a chain of 2 x
// levels dependent steps; latency bounds it, and at B 1 one item is all the
// card has. The design:
//   * one warp per item, four items a block; the block's threads first copy
//     the topology (a few hundred int32) into shared memory, then each warp
//     runs alone with __syncwarp between levels;
//   * lane l owns links l and l + 32 (nj <= 64): it computes their joint
//     transforms into registers before the sweeps, and at each depth level
//     the lanes whose links lie at that depth work at once;
//   * a link's R, p, v and both accelerations go to the warp's shared memory
//     for its children; the base is slot nj, the parent of every root link,
//     so the root needs no branch. The force a link passes up lies there
//     too, and each parent sums its children's in ascending index order (no
//     atomics): the result is the same from run to run;
//   * the model's tensors are read by pointer, so a model with other
//     inertias on the same tree needs nothing rebuilt; only the outputs go to
//     device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;                 // items a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 2;                 // links a lane owns
constexpr int kMaxNj = 32 * kSlots;
// floats a link keeps in shared memory, and their offsets: world rotation
// (row-major) and origin, body velocity, acceleration with and without the
// gravity base acceleration, the force passed to the parent (angular-first)
constexpr int kR = 0, kP = 9, kV = 12, kAH = 18, kAB = 24, kFP = 30;
constexpr int kLink = 36;
constexpr int kRevolute = 0;

__host__ __device__ inline int topo_ints(int nj) { return 5 * nj + 2; }
__host__ __device__ inline int topo_floats(int nj) {
  return (topo_ints(nj) + 3) / 4 * 4;     // keeps the float arrays aligned
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// y = M x and y = M^T x for a row-major 3 x 3 M
__device__ __forceinline__ void mv3(const float* M, const float* x, float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = M[3 * i] * x[0] + M[3 * i + 1] * x[1] + M[3 * i + 2] * x[2];
}
__device__ __forceinline__ void mtv3(const float* M, const float* x,
                                     float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = M[i] * x[0] + M[3 + i] * x[1] + M[6 + i] * x[2];
}

// X m for the motion transform of a child frame (E, p): [E w; E (lin - p x w)]
__device__ __forceinline__ void xform_apply(const float* E, const float* p,
                                            const float* m, float* out) {
  float pw[3], d[3];
  cross3(p, m, pw);
  d[0] = m[3] - pw[0];
  d[1] = m[4] - pw[1];
  d[2] = m[5] - pw[2];
  mv3(E, m, out);
  mv3(E, d, out + 3);
}

// v x m for motion vectors
__device__ __forceinline__ void cross_motion(const float* v, const float* m,
                                             float* out) {
  float a[3], b[3];
  cross3(v, m, out);
  cross3(v + 3, m, a);
  cross3(v, m + 3, b);
  out[3] = a[0] + b[0];
  out[4] = a[1] + b[1];
  out[5] = a[2] + b[2];
}

// f = I a + v x* (I v) for a row-major 6 x 6 spatial inertia I
__device__ __forceinline__ void body_force(const float* __restrict__ I,
                                           const float* a, const float* v,
                                           float* f) {
  float Iv[6], a1[3], a2[3];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float s = 0.f, t = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float Irc = __ldg(I + 6 * r + c);
      s += Irc * a[c];
      t += Irc * v[c];
    }
    f[r] = s;
    Iv[r] = t;
  }
  cross3(v, Iv, a1);          // w x n
  cross3(v + 3, Iv + 3, a2);  // lin x f_lin
  f[0] += a1[0] + a2[0];
  f[1] += a1[1] + a2[1];
  f[2] += a1[2] + a2[2];
  cross3(v, Iv + 3, a1);      // w x f_lin
  f[3] += a1[0];
  f[4] += a1[1];
  f[5] += a1[2];
}

// topology (int32, nj links; the base is node nj):
//   parent[nj]        a root link's parent is nj
//   type[nj]          0 revolute, 1 prismatic
//   depth[nj]
//   child_start[nj+2] link i's children are child[child_start[i] ..
//   child[nj]         child_start[i + 1]), ascending; node nj's: the roots
__global__ void __launch_bounds__(kThreads)
model_sweep_kernel(const float* __restrict__ q, const float* __restrict__ qd,
                   const float* __restrict__ base_rot,
                   const float* __restrict__ base_pos,
                   const float* __restrict__ base_vel,
                   const float* __restrict__ axis,
                   const float* __restrict__ E_tree,
                   const float* __restrict__ p_tree,
                   const float* __restrict__ inertia,
                   const float* __restrict__ base_inertia,
                   const float* __restrict__ gravity,
                   const int* __restrict__ topo, int B, int nj, int n_levels,
                   int floating, float* __restrict__ R_out,
                   float* __restrict__ p_out, float* __restrict__ S_out,
                   float* __restrict__ h_out, float* __restrict__ bias_out) {
  extern __shared__ float smem[];
  int* tp = reinterpret_cast<int*>(smem);
  for (int k = threadIdx.x; k < topo_ints(nj); k += kThreads) tp[k] = topo[k];
  __syncthreads();
  const int* parent = tp;
  const int* jtype = tp + nj;
  const int* depth = tp + 2 * nj;
  const int* child_start = tp + 3 * nj;
  const int* child = tp + 4 * nj + 2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;   // whole warps only: no block barrier follows
  float* L = smem + topo_floats(nj) + warp * kLink * (nj + 1);
  const int nv = floating ? nj + 6 : nj;
  const float* Rb = base_rot + 9 * b;

  if (lane == 0) {   // the base's slot
    float* s = L + kLink * nj;
    for (int k = 0; k < 9; ++k) s[kR + k] = Rb[k];
    for (int k = 0; k < 3; ++k) s[kP + k] = base_pos[3 * b + k];
    for (int k = 0; k < 6; ++k) {
      s[kV + k] = floating ? base_vel[6 * b + k] : 0.f;
      s[kAB + k] = 0.f;
    }
    float g[3] = {gravity[0], gravity[1], gravity[2]}, Rtg[3];
    mtv3(Rb, g, Rtg);
    for (int k = 0; k < 3; ++k) {
      s[kAH + k] = 0.f;
      s[kAH + 3 + k] = -Rtg[k];
    }
  }

  // joint-local transforms of the lane's links: E (child from parent), p
  float E[kSlots][9], pl[kSlots][3], f[kSlots][6];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    if (j >= nj) continue;
    const float* ax = axis + 3 * j;
    const float* Et = E_tree + 9 * j;
    const float qj = q[b * nj + j];
    if (jtype[j] == kRevolute) {
      // R_rot = I + s K + (1 - c) K K rotates by +q; E = R_rot^T E_tree
      const float c = cosf(qj), sn = sinf(qj);
      const float K[9] = {0.f, -ax[2], ax[1], ax[2], 0.f, -ax[0],
                          -ax[1], ax[0], 0.f};
      float Rr[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const float KK = K[3 * r] * K[cc] + K[3 * r + 1] * K[3 + cc]
                           + K[3 * r + 2] * K[6 + cc];
          Rr[3 * r + cc] = (r == cc ? 1.f : 0.f) + sn * K[3 * r + cc]
                           + (1.f - c) * KK;
        }
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          E[s][3 * r + cc] = Rr[r] * Et[cc] + Rr[3 + r] * Et[3 + cc]
                             + Rr[6 + r] * Et[6 + cc];
#pragma unroll
      for (int k = 0; k < 3; ++k) pl[s][k] = p_tree[3 * j + k];
    } else {
      // E = E_tree, p = p_tree + E_tree^T (axis q)
      const float aq[3] = {ax[0] * qj, ax[1] * qj, ax[2] * qj};
      float Ea[3];
      mtv3(Et, aq, Ea);
#pragma unroll
      for (int k = 0; k < 9; ++k) E[s][k] = Et[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) pl[s][k] = p_tree[3 * j + k] + Ea[k];
    }
  }
  __syncwarp();

  // forward sweep, root level first
  for (int d = 0; d < n_levels; ++d) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane + 32 * s;
      if (j >= nj || depth[j] != d) continue;
      const float* P = L + kLink * parent[j];
      float* C = L + kLink * j;
      const float* ax = axis + 3 * j;
      const bool rev = jtype[j] == kRevolute;
      const float qdj = qd[b * nj + j];
      // fk: R = R_par E^T, p = p_par + R_par p_loc, S_ang = R axis
      float R[9], Rpl[3], Sa[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          R[3 * r + cc] = P[kR + 3 * r] * E[s][3 * cc]
                          + P[kR + 3 * r + 1] * E[s][3 * cc + 1]
                          + P[kR + 3 * r + 2] * E[s][3 * cc + 2];
      mv3(P + kR, pl[s], Rpl);
      const float a3[3] = {ax[0], ax[1], ax[2]};
      mv3(R, a3, Sa);
      float* Ro = R_out + (size_t)(b * nj + j) * 9;
      float* po = p_out + (size_t)(b * nj + j) * 3;
      float* So = S_out + (size_t)(b * nj + j) * 3;
#pragma unroll
      for (int k = 0; k < 9; ++k) C[kR + k] = Ro[k] = R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        C[kP + k] = po[k] = P[kP + k] + Rpl[k];
        So[k] = Sa[k];
      }
      // v = X v_par + S qd; a = X a_par + v x (S qd), for both a
      float vj[6], v[6], ah[6], ab[6], cm[6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        vj[k] = rev ? a3[k] * qdj : 0.f;
        vj[3 + k] = rev ? 0.f : a3[k] * qdj;
      }
      xform_apply(E[s], pl[s], P + kV, v);
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] += vj[k];
      cross_motion(v, vj, cm);
      xform_apply(E[s], pl[s], P + kAH, ah);
      xform_apply(E[s], pl[s], P + kAB, ab);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        ah[k] += cm[k];
        ab[k] += cm[k];
        C[kV + k] = v[k];
        C[kAH + k] = ah[k];
        C[kAB + k] = ab[k];
      }
      body_force(inertia + 36 * j, ah, v, f[s]);
      // bias = [R a_lin + (R w) x (R v_lin); R a_ang]
      float ww[3], vw[3], aa[3], al[3], wxv[3];
      mv3(R, v, ww);
      mv3(R, v + 3, vw);
      mv3(R, ab, aa);
      mv3(R, ab + 3, al);
      cross3(ww, vw, wxv);
      float* bo = bias_out + (size_t)(b * nj + j) * 6;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bo[k] = al[k] + wxv[k];
        bo[3 + k] = aa[k];
      }
    }
    __syncwarp();
  }

  // backward sweep, deepest level first: a link adds its children's forces
  // (computed one level earlier), projects onto its axis and passes
  // X^T f = [E^T n + p x (E^T f_lin); E^T f_lin] to its parent
  const int off = floating ? 6 : 0;
  for (int d = n_levels - 1; d >= 0; --d) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane + 32 * s;
      if (j >= nj || depth[j] != d) continue;
      float ft[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) ft[k] = f[s][k];
      int c_end = child_start[j + 1];
#ifdef MODEL_SWEEP_DROP_SIBLING   // planted fault: a parent, or the base
      // below, with two or more children loses the last one's force
      if (c_end - child_start[j] > 1) --c_end;
#endif
      for (int c = child_start[j]; c < c_end; ++c) {
        const float* fc = L + kLink * child[c] + kFP;
#pragma unroll
        for (int k = 0; k < 6; ++k) ft[k] += fc[k];
      }
      const float* ax = axis + 3 * j;
      const int o = jtype[j] == kRevolute ? 0 : 3;
      h_out[(size_t)b * nv + off + j] =
          ax[0] * ft[o] + ax[1] * ft[o + 1] + ax[2] * ft[o + 2];
      float lin[3], n[3], pxl[3];
      mtv3(E[s], ft + 3, lin);
      mtv3(E[s], ft, n);
      cross3(pl[s], lin, pxl);
      float* C = L + kLink * j;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        C[kFP + k] = n[k] + pxl[k];
        C[kFP + 3 + k] = lin[k];
      }
    }
    __syncwarp();
  }

  if (floating && lane == 0) {   // the base: its own force plus the roots'
    const float* s = L + kLink * nj;
    float fb[6];
    body_force(base_inertia, s + kAH, s + kV, fb);
    int c_end = child_start[nj + 1];
#ifdef MODEL_SWEEP_DROP_SIBLING
    if (c_end - child_start[nj] > 1) --c_end;
#endif
    for (int c = child_start[nj]; c < c_end; ++c) {
      const float* fc = L + kLink * child[c] + kFP;
      for (int k = 0; k < 6; ++k) fb[k] += fc[k];
    }
    for (int k = 0; k < 6; ++k) h_out[(size_t)b * nv + k] = fb[k];
  }
}

}  // namespace

// Largest number of links the kernel takes.
extern "C" int model_sweep_max_nj() { return kMaxNj; }

// Dynamic shared memory a block needs for nj links.
extern "C" int model_sweep_smem_bytes(int nj) {
  return (int)sizeof(float) * (topo_floats(nj) + kWarps * kLink * (nj + 1));
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Every array is contiguous float32 (topo int32) on the card: q, qd (B, nj),
// base_rot (B, 3, 3), base_pos (B, 3), base_vel (B, 6) (read only when
// floating), axis (nj, 3), E_tree (nj, 3, 3), p_tree (nj, 3), inertia
// (nj, 6, 6), base_inertia (6, 6), gravity (3); outputs R (B, nj, 3, 3),
// p (B, nj, 3), S_ang (B, nj, 3), h (B, nv), bias (B, nj, 6).
extern "C" int model_sweep_launch(
    const float* q, const float* qd, const float* base_rot,
    const float* base_pos, const float* base_vel, const float* axis,
    const float* E_tree, const float* p_tree, const float* inertia,
    const float* base_inertia, const float* gravity, const int* topo, int B,
    int nj, int n_levels, int floating, float* R, float* p, float* S_ang,
    float* h, float* bias, void* stream) {
  if (B == 0) return 0;
  if (nj < 1 || nj > kMaxNj || n_levels < 1 || n_levels > nj)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kWarps - 1) / kWarps;
  model_sweep_kernel<<<blocks, kThreads, model_sweep_smem_bytes(nj),
                       (cudaStream_t)stream>>>(
      q, qd, base_rot, base_pos, base_vel, axis, E_tree, p_tree, inertia,
      base_inertia, gravity, topo, B, nj, n_levels, floating, R, p, S_ang, h,
      bias);
  return (int)cudaGetLastError();
}
