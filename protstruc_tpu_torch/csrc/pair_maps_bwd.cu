// Backward of the trRosetta pair maps (K2) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel protstruc_tpu/ops/pallas_pairwise.py: _bwd_kernel,
// launched by _maps_bwd_pallas.  Given the cotangents of the six maps of K1
// (pair_maps.cu), each f32 (B, L, L), it computes dxyz (B, L, A, 3): nonzero
// in the N, CA, CB and O slots, exact zeros elsewhere.
//
// The algebra is the TPU kernel's, written out by hand (the TPU kernel took
// jax.vjp of a polynomial primal inside the kernel), in the order the plain
// version (ops/pair_maps.py: _maps_bwd_plain) evaluates it:
//  * the primal is polynomial only: squared distances q, the dihedral
//    triples (x, w, h) with x = n0 . n1, w = (n0 x n1) . b1 (the unreduced y:
//    y = w / sqrt(h)), h = b1 . b1, and the angle's (s2, t) = (|ba x bc|^2,
//    ba . bc).  No atan2 is evaluated: its adjoint is rational;
//  * the chain rules of the transcendental heads divide only where a pair is
//    not degenerate, with an exact 1/sqrtf (no rsqrt) and every divide
//    guarded twice.  Degeneracy is exact coordinate equality on the inputs,
//    never a test on a derived value (a cross product of a vector with itself
//    is exactly 0 only without FMA contraction; here -fmad=false holds it, and
//    the equality test does not depend on it).  The masks include the
//    b == c term that K1's forward pins lack;
//  * the pullback of the primal is reverse mode by hand: each product hands
//    the cotangent times the other factor back, so NaN coordinates give NaN
//    gradients on the same entries as the JAX package.
//
// Reduction.  Every pair (i, j) adds to 9 floats of residue i (N, CA, CB)
// and 9 of residue j (CA, CB, O).  The TPU kernel carried both sums across
// its sequential grid.  Here a 32 (j) x 8 (i) thread block walks 32 i-rows in
// 4 passes: the i-side of each row is summed over the block's 32 j by a warp
// butterfly and written as one partial per (b, j-tile, i); the j-side stays in
// registers over the 4 passes and is summed over the 8 warps in shared memory,
// one partial per (b, i-tile, j).  A second kernel sums the partials of each
// residue over the tiles in index order and writes dxyz.  No atomics: the
// result is the same bits from run to run.
//
// What bounds it on an H100: the cotangent reads, 24 B per pair when all six
// maps are requested (1.61 GB at B=256, L=512, about 0.48 ms at 3.35 TB/s),
// against about 590 FP32 operations per pair (about 0.59 ms at 67 TFLOP/s):
// the two are close.  A map whose cotangent is absent costs neither its read
// nor its arithmetic (bit k of `mask`).  Ragged L is masked in the kernel; the
// kernels allocate nothing and do not synchronise; the partials are scratch
// the caller allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "pair_maps.cuh"

namespace {

constexpr int kTileJ = 32;                 // threads along j: one warp per i-row
constexpr int kWarps = 8;                  // warps (i-rows in flight) per block
constexpr int kPasses = 4;                 // i-rows per warp
constexpr int kTileI = kWarps * kPasses;   // i-rows per block
constexpr int kSide = 9;                   // floats per residue and side
constexpr int kReduceThreads = 128;

__device__ __forceinline__ V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return V3{s * a.x, s * a.y, s * a.z}; }

// acc[3 * slot .. 3 * slot + 2] += v
__device__ __forceinline__ void acc3(float* acc, int slot, V3 v) {
  acc[3 * slot] += v.x;
  acc[3 * slot + 1] += v.y;
  acc[3 * slot + 2] += v.z;
}

// cotangent of a squared distance from that of the distance: 0.5 g / sqrt(q)
__device__ __forceinline__ float d_dist(float g, float q) {
  bool pos = q > 0.0f;
  return pos ? g * 0.5f / sqrtf(pos ? q : 1.0f) : 0.0f;
}

// pullback of q = |u - v|^2: the cotangent of u (that of v is its negative)
__device__ __forceinline__ V3 pull_q(float gq, V3 u, V3 v) {
  return scale(gq + gq, sub(u, v));
}

// dihedral a-b-c-d: the cotangent g of atan2(w / sqrt(h), x) pulled back to
// a, b, c and d (ct[0..3]) through the primal (x, w, h)
__device__ __forceinline__ void pull_dihedral(float g, V3 a, V3 b, V3 c, V3 d, bool deg,
                                              V3* ct) {
  const V3 b0 = sub(a, b), b1 = sub(c, b), b2 = sub(d, c);
  const V3 n0 = cross(b0, b1), n1 = cross(b2, b1);
  const V3 m = cross(n0, n1);
  const float x = dot(n0, n1), w = dot(m, b1), h = dot(b1, b1);

  // guarded adjoints of phi = atan2(y, x), y = w h^(-1/2)
  const bool hpos = h > 0.0f;
  const float s = 1.0f / sqrtf(hpos ? h : 1.0f);
  const float y = w * s;
  const float denom = x * x + y * y;
  const bool ok = hpos && denom > 0.0f && !deg;
  const float inv = 1.0f / (ok ? denom : 1.0f);
  const float gx = ok ? -g * y * inv : 0.0f;
  const float gy = ok ? g * x * inv : 0.0f;
  const float gw = gy * s;
  const float gh = -0.5f * gy * w * s * s * s;

  // reverse mode through x = n0 . n1, w = (n0 x n1) . b1, h = b1 . b1
  const V3 ct_m = scale(gw, b1);
  const V3 ct_n0 = add(scale(gx, n1), cross(n1, ct_m));
  const V3 ct_n1 = add(scale(gx, n0), cross(ct_m, n0));
  const V3 ct_b1 = add(add(add(scale(gw, m), scale(gh + gh, b1)), cross(ct_n0, b0)),
                       cross(ct_n1, b2));
  const V3 ct_b0 = cross(b1, ct_n0);
  const V3 ct_b2 = cross(b1, ct_n1);
  ct[0] = ct_b0;
  ct[1] = sub(neg(ct_b0), ct_b1);
  ct[2] = sub(ct_b1, ct_b2);
  ct[3] = ct_b2;
}

// planar angle a-b-c, atan2(sqrt(s2), t): the cotangent g pulled back to a,
// b and c (ct[0..2])
__device__ __forceinline__ void pull_angle(float g, V3 a, V3 b, V3 c, bool deg, V3* ct) {
  const V3 ba = sub(a, b), bc = sub(c, b);
  const V3 cr = cross(ba, bc);
  const float s2 = dot(cr, cr), t = dot(ba, bc);

  const float s = sqrtf(s2 > 0.0f ? s2 : 0.0f);
  const float r2 = s2 + t * t;
  const bool ok = r2 > 0.0f && !deg;
  const float inv = 1.0f / (ok ? r2 : 1.0f);
  const float gt = ok ? -g * s * inv : 0.0f;
  const float gs = ok ? g * t * inv : 0.0f;
  const bool pos = s2 > 0.0f && !deg;
  const float gs2 = pos ? gs * 0.5f / sqrtf(pos ? s2 : 1.0f) : 0.0f;

  const V3 ct_cr = scale(gs2 + gs2, cr);
  const V3 ct_ba = add(scale(gt, bc), cross(bc, ct_cr));
  const V3 ct_bc = add(scale(gt, ba), cross(ct_cr, ba));
  ct[0] = ct_ba;
  ct[1] = sub(neg(ct_ba), ct_bc);
  ct[2] = ct_bc;
}

// One pair's contributions: ai += (N_i, CA_i, CB_i), aj += (CA_j, CB_j, O_j).
// g[k] is map k's cotangent at the pair (read only where bit k is set).
__device__ __forceinline__ void pair_bwd(const float* ri, const float* rj, int mask,
                                         const float* g, float* ai, float* aj) {
  const V3 n_i = load3(ri, kN), ca_i = load3(ri, kCA), cb_i = load3(ri, kCB);
  const V3 ca_j = load3(rj, kCA), cb_j = load3(rj, kCB), o_j = load3(rj, kO);
  V3 ct[4];
  if (mask & kDCa) {
    V3 c = pull_q(d_dist(g[0], dot(sub(ca_i, ca_j), sub(ca_i, ca_j))), ca_i, ca_j);
    acc3(ai, 1, c);
    acc3(aj, 0, neg(c));
  }
  if (mask & kDCb) {
    V3 c = pull_q(d_dist(g[1], dot(sub(cb_i, cb_j), sub(cb_i, cb_j))), cb_i, cb_j);
    acc3(ai, 2, c);
    acc3(aj, 1, neg(c));
  }
  if (mask & kDNo) {
    V3 c = pull_q(d_dist(g[2], dot(sub(n_i, o_j), sub(n_i, o_j))), n_i, o_j);
    acc3(ai, 0, c);
    acc3(aj, 2, neg(c));
  }
  if (mask & kOmega) {  // dihedral(CA_i, CB_i, CA_j, CB_j)
    bool deg = (eq(ca_i, ca_j) && eq(cb_i, cb_j)) || eq(ca_j, cb_j) || eq(ca_i, cb_i) ||
               eq(cb_i, ca_j);
    pull_dihedral(g[3], ca_i, cb_i, ca_j, cb_j, deg, ct);
    acc3(ai, 1, ct[0]);
    acc3(ai, 2, ct[1]);
    acc3(aj, 0, ct[2]);
    acc3(aj, 1, ct[3]);
  }
  if (mask & kTheta) {  // dihedral(N_i, CA_i, CB_i, CB_j)
    bool deg = (eq(n_i, cb_i) && eq(ca_i, cb_j)) || eq(cb_i, cb_j) || eq(n_i, ca_i) ||
               eq(ca_i, cb_i);
    pull_dihedral(g[4], n_i, ca_i, cb_i, cb_j, deg, ct);
    acc3(ai, 0, ct[0]);
    acc3(ai, 1, ct[1]);
    acc3(ai, 2, ct[2]);
    acc3(aj, 1, ct[3]);
  }
  if (mask & kPhi) {  // angle(CA_i, CB_i, CB_j)
    bool deg = eq(ca_i, cb_i) || eq(cb_j, cb_i);
    pull_angle(g[5], ca_i, cb_i, cb_j, deg, ct);
    acc3(ai, 1, ct[0]);
    acc3(ai, 2, ct[1]);
    acc3(aj, 1, ct[2]);
  }
}

// grid (j-tiles, i-tiles, B).  part_i: (B, nJT, 9, L), the i-side summed over
// each j-tile; part_j: (B, nIT, 9, L), the j-side summed over each i-tile.
__global__ void __launch_bounds__(kTileJ * kWarps)
pair_maps_bwd_kernel(const float* __restrict__ xyz, int L, int A, int mask,
                     const float* __restrict__ g_ca, const float* __restrict__ g_cb,
                     const float* __restrict__ g_no, const float* __restrict__ g_om,
                     const float* __restrict__ g_th, const float* __restrict__ g_ph,
                     float* __restrict__ part_i, float* __restrict__ part_j) {
  __shared__ float si[kTileI * kSlotFloats];
  __shared__ float sj[kTileJ * kSlotFloats];
  __shared__ float red[kWarps][kSide][kTileJ];

  const int b = blockIdx.z;
  const int n_jt = gridDim.x, n_it = gridDim.y;
  const int i0 = blockIdx.y * kTileI;
  const int j0 = blockIdx.x * kTileJ;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileJ + tx;
  const int64_t res_stride = (int64_t)A * 3;
  const float* base = xyz + (int64_t)b * L * res_stride;

  stage_slots(sj, base, j0, kTileJ, L, res_stride, tid, kTileJ * kWarps);
  stage_slots(si, base, i0, kTileI, L, res_stride, tid, kTileJ * kWarps);
  __syncthreads();

  const int j = j0 + tx;
  const float* const gs[6] = {g_ca, g_cb, g_no, g_om, g_th, g_ph};
  float aj[kSide] = {};
#pragma unroll 1
  for (int p = 0; p < kPasses; ++p) {
    const int il = ty + kWarps * p;
    const int i = i0 + il;
    float ai[kSide] = {};
    if (i < L && j < L) {
      const int64_t o = ((int64_t)b * L + i) * L + j;
      float g[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) g[k] = (mask >> k) & 1 ? gs[k][o] : 0.0f;
      pair_bwd(si + il * kSlotFloats, sj + tx * kSlotFloats, mask, g, ai, aj);
    }
    // i-side: butterfly sum over the warp's 32 j, the same order in every lane
#pragma unroll
    for (int k = 0; k < kSide; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ai[k] += __shfl_xor_sync(0xffffffffu, ai[k], off);
    }
    if (tx == 0 && i < L) {
#pragma unroll
      for (int k = 0; k < kSide; ++k)
        part_i[(((int64_t)b * n_jt + blockIdx.x) * kSide + k) * L + i] = ai[k];
    }
  }
  // j-side: sum over the block's 8 warps in shared memory, in warp order
#pragma unroll
  for (int k = 0; k < kSide; ++k) red[ty][k][tx] = aj[k];
  __syncthreads();
  for (int q = tid; q < kSide * kTileJ; q += kTileJ * kWarps) {
    const int k = q / kTileJ, jl = q % kTileJ;
    if (j0 + jl >= L) continue;
    float s = red[0][k][jl];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][k][jl];
    part_j[(((int64_t)b * n_it + blockIdx.y) * kSide + k) * L + j0 + jl] = s;
  }
}

// grid (ceil(L / 128), B): residue r of batch entry b sums its partials over
// the tiles in index order and writes its A x 3 gradient entries.
__global__ void __launch_bounds__(kReduceThreads)
pair_maps_bwd_reduce(const float* __restrict__ part_i, const float* __restrict__ part_j,
                     int L, int A, int n_jt, int n_it, float* __restrict__ dxyz) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * kReduceThreads + threadIdx.x;
  if (r >= L) return;
  float si[kSide], sj[kSide];
#pragma unroll
  for (int k = 0; k < kSide; ++k) {
    const float* pi = part_i + ((int64_t)b * n_jt * kSide + k) * L + r;
    const float* pj = part_j + ((int64_t)b * n_it * kSide + k) * L + r;
    float s = 0.0f;
    for (int t = 0; t < n_jt; ++t) s += pi[(int64_t)t * kSide * L];
    si[k] = s;
    s = 0.0f;
    for (int t = 0; t < n_it; ++t) s += pj[(int64_t)t * kSide * L];
    sj[k] = s;
  }
  float* out = dxyz + ((int64_t)b * L + r) * A * 3;
  for (int q = 0; q < A * 3; ++q) out[q] = 0.0f;
  // i-side: N, CA, CB; j-side: CA, CB, O
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[3 * kN + c] = si[c];
    out[3 * kCA + c] = si[3 + c] + sj[c];
    out[3 * kCB + c] = si[6 + c] + sj[3 + c];
    out[3 * kO + c] = sj[6 + c];
  }
}

}  // namespace

// Sizes of the scratch ps_pair_maps_bwd_f32 needs, in floats: part_i and
// part_j (both 0 for B or L of 0).
extern "C" void ps_pair_maps_bwd_scratch(int B, int L, long long* n_part_i, long long* n_part_j) {
  const long long n_jt = (L + kTileJ - 1) / kTileJ, n_it = (L + kTileI - 1) / kTileI;
  *n_part_i = (long long)B * n_jt * kSide * L;
  *n_part_j = (long long)B * n_it * kSide * L;
}

// xyz: contiguous f32 (B, L, A, 3) with A >= 5, on `device`.  Each cotangent
// whose bit is set in `mask` (bit k: map k of d_ca, d_cb, d_no, omega,
// theta, phi) is a contiguous f32 (B, L, L) buffer; the others may be null.
// part_i and part_j are f32 scratch of the sizes ps_pair_maps_bwd_scratch
// gives; dxyz a contiguous f32 (B, L, A, 3) buffer, written in full.  Launches
// both kernels on `stream` and returns cudaGetLastError() (0 = launched).
// The calling thread's current device is the same after the call.
extern "C" int ps_pair_maps_bwd_f32(int device, const float* xyz, int B, int L, int A, int mask,
                                    const float* g_ca, const float* g_cb, const float* g_no,
                                    const float* g_om, const float* g_th, const float* g_ph,
                                    float* part_i, float* part_j, float* dxyz, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  const int n_jt = (L + kTileJ - 1) / kTileJ, n_it = (L + kTileI - 1) / kTileI;
  cudaStream_t s = (cudaStream_t)stream;
  pair_maps_bwd_kernel<<<dim3(n_jt, n_it, B), dim3(kTileJ, kWarps), 0, s>>>(
      xyz, L, A, mask, g_ca, g_cb, g_no, g_om, g_th, g_ph, part_i, part_j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pair_maps_bwd_reduce<<<dim3((L + kReduceThreads - 1) / kReduceThreads, B), kReduceThreads, 0,
                         s>>>(part_i, part_j, L, A, n_jt, n_it, dxyz);
  return (int)cudaGetLastError();
}
