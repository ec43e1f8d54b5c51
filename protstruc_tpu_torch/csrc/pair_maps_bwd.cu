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
// The walk.  K2 runs the strided walk of the tile skeleton of K1 and K3
// (csrc/pair_maps.cuh pair_tiles, planned by ops/pair_maps.bwd_plan and
// handed to the launch as a PairPlan): tiles of kPairTileI i-rows by
// kPairTileJ j-columns of one batch entry, numbered t = (b * tiles_i + ti) *
// tiles_j + tj, block k taking t = k, k + grid, ..., so B is bounded by
// nothing but int64.  A block of kPairWarps warps stages the tile's atoms
// once (i-side N, CA, CB; j-side CA, CB, O); warp w walks the rows w, w +
// kPairWarps, ..., and lane l owns the kPairsJ columns j0 + l + 32 q (q = 0
// .. kPairsJ - 1), so that each cotangent load of a warp is 128 contiguous
// bytes.  A thread builds residue i's terms once a row (BwdI: theta's arms
// b0, b1, n0, h and 1/sqrt(h), omega's and phi's CA_i - CB_i, the i-only
// equality tests), then takes its pairs one at a time: the hoist moves work,
// it does not change the operation order.
//
// Reduction.  Every pair (i, j) adds to 9 floats of residue i (N, CA, CB)
// and 9 of residue j (CA, CB, O).  No atomics, fixed orders:
//  * i-side: a lane sums its pairs of the row in q order (map by map into one
//    running sum), then an xor butterfly (16, 8, 4, 2, 1) sums the warp's 32
//    lanes, the same bits in every lane; lane 0 writes one partial per
//    (tile, residue i);
//  * j-side: each pair's 9 floats (summed map by map) are added to the
//    warp's column accumulators in shared memory, in row order; at the end
//    of the tile the block sums its warps in warp order and writes one
//    partial per (tile, residue j);
//  * a second kernel sums each residue's partials over the tiles in tile-index
//    order (i-side over tj, j-side over ti) and writes dxyz.
// The result is the same bits from run to run.
//
// What bounds it on an H100: the cotangent reads, 24 B per pair when all six
// maps are requested (1.61 GB at B=256, L=512, about 0.48 ms at 3.35 TB/s),
// against about 528 FP32 operations per pair (about 0.53 ms at 67 TFLOP/s;
// with -fmad=false no multiply and add fuse, so the issue rate halves that
// peak) and the guarded divides and square roots, each a sequence of
// instructions.  A map whose cotangent is absent costs neither its read nor
// its arithmetic (bit k of `mask`).  Ragged L is masked in the kernel; the
// kernels allocate nothing and do not synchronise; the partials are scratch
// the caller allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "pair_maps.cuh"

namespace {

constexpr int kSide = 9;                          // floats per residue and side
constexpr int kReduceThreads = 128;
constexpr int kErrPlan = -3;                      // the plan is not one this kernel can take

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

// The terms of a dihedral a-b-c-d's adjoint that do not depend on d: its arms
// b0 = a - b and b1 = c - b, n0 = b0 x b1, h = b1 . b1 and s = h^(-1/2)
// (guarded).  Theta's depend on residue i alone and are built once a row.
struct Arms {
  V3 b0, b1, n0;
  float s;
  bool hpos;
};

__device__ __forceinline__ Arms arms(V3 b0, V3 b1) {
  Arms r;
  r.b0 = b0;
  r.b1 = b1;
  r.n0 = cross(b0, b1);
  const float h = dot(b1, b1);
  r.hpos = h > 0.0f;
  r.s = 1.0f / sqrtf(r.hpos ? h : 1.0f);
  return r;
}

// dihedral a-b-c-d, its arms given and b2 = d - c: the cotangent g of
// atan2(w / sqrt(h), x) pulled back to a, b, c and d (ct[0..3]) through the
// primal x = n0 . n1, w = (n0 x n1) . b1, h = b1 . b1
__device__ __forceinline__ void pull_dihedral(float g, const Arms& A, V3 b2, bool deg, V3* ct) {
  const V3 n1 = cross(b2, A.b1);
  const V3 m = cross(A.n0, n1);
  const float x = dot(A.n0, n1), w = dot(m, A.b1);

  // guarded adjoints of phi = atan2(y, x), y = w h^(-1/2)
  const float s = A.s;
  const float y = w * s;
  const float denom = x * x + y * y;
  const bool ok = A.hpos && denom > 0.0f && !deg;
  const float inv = 1.0f / (ok ? denom : 1.0f);
  const float gx = ok ? -g * y * inv : 0.0f;
  const float gy = ok ? g * x * inv : 0.0f;
  const float gw = gy * s;
  const float gh = -0.5f * gy * w * s * s * s;

  // reverse mode through x = n0 . n1, w = (n0 x n1) . b1, h = b1 . b1
  const V3 ct_m = scale(gw, A.b1);
  const V3 ct_n0 = add(scale(gx, n1), cross(n1, ct_m));
  const V3 ct_n1 = add(scale(gx, A.n0), cross(ct_m, A.n0));
  const V3 ct_b1 = add(add(add(scale(gw, m), scale(gh + gh, A.b1)), cross(ct_n0, A.b0)),
                       cross(ct_n1, b2));
  const V3 ct_b0 = cross(A.b1, ct_n0);
  const V3 ct_b2 = cross(A.b1, ct_n1);
  ct[0] = ct_b0;
  ct[1] = sub(neg(ct_b0), ct_b1);
  ct[2] = sub(ct_b1, ct_b2);
  ct[3] = ct_b2;
}

// planar angle between the arms ba = a - b and bc = c - b, atan2(sqrt(s2),
// t): the cotangent g pulled back to a, b and c (ct[0..2])
__device__ __forceinline__ void pull_angle(float g, V3 ba, V3 bc, bool deg, V3* ct) {
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

// Residue i's atoms and the terms of its pairs' adjoints that depend on it
// alone, built once a row (the same expressions each pair would evaluate).
struct BwdI {
  V3 n, ca, cb;
  V3 cab;    // CA_i - CB_i: omega's b0, phi's ba
  Arms th;   // theta's arms N_i - CA_i, CB_i - CA_i
  bool eq_ca_cb, eq_n_cb, eq_n_ca;
};

__device__ __forceinline__ BwdI bwd_i(V3 n, V3 ca, V3 cb, int mask) {
  BwdI s{};
  s.n = n, s.ca = ca, s.cb = cb;
  if (mask & (kOmega | kPhi)) s.cab = sub(ca, cb);
  if (mask & kTheta) {
    s.th = arms(sub(n, ca), sub(cb, ca));
    s.eq_n_cb = eq(n, cb);
    s.eq_n_ca = eq(n, ca);
  }
  s.eq_ca_cb = eq(ca, cb);
  return s;
}

// One pair's contributions: ai += (N_i, CA_i, CB_i), aj += (CA_j, CB_j, O_j).
// g[k] is map k's cotangent at the pair (read only where bit k is set).
__device__ __forceinline__ void pair_bwd(const BwdI& I, V3 ca_j, V3 cb_j, V3 o_j, int mask,
                                         const float* g, float* ai, float* aj) {
  V3 ct[4];
  if (mask & kDCa) {
    V3 c = pull_q(d_dist(g[0], dot(sub(I.ca, ca_j), sub(I.ca, ca_j))), I.ca, ca_j);
    acc3(ai, 1, c);
    acc3(aj, 0, neg(c));
  }
  if (mask & kDCb) {
    V3 c = pull_q(d_dist(g[1], dot(sub(I.cb, cb_j), sub(I.cb, cb_j))), I.cb, cb_j);
    acc3(ai, 2, c);
    acc3(aj, 1, neg(c));
  }
  if (mask & kDNo) {
    V3 c = pull_q(d_dist(g[2], dot(sub(I.n, o_j), sub(I.n, o_j))), I.n, o_j);
    acc3(ai, 0, c);
    acc3(aj, 2, neg(c));
  }
  if (mask & kOmega) {  // dihedral(CA_i, CB_i, CA_j, CB_j)
    bool deg = (eq(I.ca, ca_j) && eq(I.cb, cb_j)) || eq(ca_j, cb_j) || I.eq_ca_cb ||
               eq(I.cb, ca_j);
    pull_dihedral(g[3], arms(I.cab, sub(ca_j, I.cb)), sub(cb_j, ca_j), deg, ct);
    acc3(ai, 1, ct[0]);
    acc3(ai, 2, ct[1]);
    acc3(aj, 0, ct[2]);
    acc3(aj, 1, ct[3]);
  }
  if (mask & kTheta) {  // dihedral(N_i, CA_i, CB_i, CB_j)
    bool deg = (I.eq_n_cb && eq(I.ca, cb_j)) || eq(I.cb, cb_j) || I.eq_n_ca || I.eq_ca_cb;
    pull_dihedral(g[4], I.th, sub(cb_j, I.cb), deg, ct);
    acc3(ai, 0, ct[0]);
    acc3(ai, 1, ct[1]);
    acc3(ai, 2, ct[2]);
    acc3(aj, 1, ct[3]);
  }
  if (mask & kPhi) {  // angle(CA_i, CB_i, CB_j)
    bool deg = I.eq_ca_cb || eq(cb_j, I.cb);
    pull_angle(g[5], I.cab, sub(cb_j, I.cb), deg, ct);
    acc3(ai, 1, ct[0]);
    acc3(ai, 2, ct[1]);
    acc3(aj, 1, ct[2]);
  }
}

// The tiles of plan p.  part_i: (B, tiles_j, 9, L), residue i's side summed
// over each tile's j; part_j: (B, tiles_i, 9, L), residue j's side summed
// over each tile's i.  Held to 80 registers (a few bytes spill), so that
// three blocks (24 warps) share an SM: the kernel is bound by issuing its
// arithmetic, and at two blocks (no spills) or four it ran slower
// (experiments/pair_tile_probe.py; PERF.md).
__global__ void __launch_bounds__(kPairThreads, 3)
pair_maps_bwd_kernel(const float* __restrict__ xyz, int B, int L, int A, int mask, PairPlan p,
                     const float* __restrict__ g_ca, const float* __restrict__ g_cb,
                     const float* __restrict__ g_no, const float* __restrict__ g_om,
                     const float* __restrict__ g_th, const float* __restrict__ g_ph,
                     float* __restrict__ part_i, float* __restrict__ part_j) {
  __shared__ float sacc[kPairWarps][kSide][kPairTileJ];  // each warp's j-side sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* const gs[6] = {g_ca, g_cb, g_no, g_om, g_th, g_ph};
  float(*const acc)[kPairTileJ] = sacc[warp];
  // zero once; the end of each tile zeroes what it read (the walk's first
  // barrier orders this before any row)
  for (int k = tid; k < kPairWarps * kSide * kPairTileJ; k += kPairThreads)
    (&sacc[0][0][0])[k] = 0.0f;

  const auto row = [&](const float* ri, const float* sjl, const PairTile& t, int i) {
    const BwdI I = bwd_i(load3(ri, 0), load3(ri, 1), load3(ri, 2), mask);
    const int64_t o = (t.b * L + i) * L + t.j0 + lane;
    float ai[kSide] = {};
#pragma unroll 1
    for (int q = 0; q < kPairsJ; ++q) {
      const int c = 32 * q + lane;
      if (t.j0 + c >= L) break;
      float g[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) g[k] = (mask >> k) & 1 ? gs[k][o + 32 * q] : 0.0f;
      const float* sc = sjl + 32 * q;
      const V3 ca_j{sc[0], sc[kJStride], sc[2 * kJStride]};
      const V3 cb_j{sc[3 * kJStride], sc[4 * kJStride], sc[5 * kJStride]};
      const V3 o_j{sc[6 * kJStride], sc[7 * kJStride], sc[8 * kJStride]};
      float aj[kSide] = {};
      pair_bwd(I, ca_j, cb_j, o_j, mask, g, ai, aj);
#pragma unroll
      for (int k = 0; k < kSide; ++k) acc[k][c] += aj[k];
    }
    // i-side: butterfly sum over the warp's 32 lanes, the same bits in every lane
#pragma unroll
    for (int k = 0; k < kSide; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ai[k] += __shfl_xor_sync(0xffffffffu, ai[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kSide; ++k)
        part_i[((t.b * p.tiles_j + t.tj) * kSide + k) * L + i] = ai[k];
    }
  };
  // j-side: sum over the block's warps, in warp order (columns past L were
  // never added to and stay 0)
  const auto tile_end = [&](const PairTile& t) {
    for (int e = tid; e < kSide * kPairTileJ; e += kPairThreads) {
      const int k = e / kPairTileJ, c = e % kPairTileJ;
      if (t.j0 + c >= L) continue;
      float s = sacc[0][k][c];
      sacc[0][k][c] = 0.0f;
#pragma unroll
      for (int w = 1; w < kPairWarps; ++w) {
        s += sacc[w][k][c];
        sacc[w][k][c] = 0.0f;
      }
      part_j[((t.b * p.tiles_i + t.ti) * kSide + k) * L + t.j0 + c] = s;
    }
  };
  pair_tiles<3, true>(xyz, B, L, A, p, mask, row, tile_end);
}

// Residue (b, r) of B x L, kReduceThreads a block, flat: sums its partials
// over the tiles in index order and writes its A x 3 gradient entries.
__global__ void __launch_bounds__(kReduceThreads)
pair_maps_bwd_reduce(const float* __restrict__ part_i, const float* __restrict__ part_j, int B,
                     int L, int A, PairPlan p, float* __restrict__ dxyz) {
  const int64_t n = (int64_t)B * L;
  for (int64_t e = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * kReduceThreads) {
    const int64_t b = e / L;
    const int r = (int)(e % L);
    float si[kSide], sj[kSide];
#pragma unroll
    for (int k = 0; k < kSide; ++k) {
      const float* pi = part_i + (b * p.tiles_j * kSide + k) * L + r;
      const float* pj = part_j + (b * p.tiles_i * kSide + k) * L + r;
      float s = 0.0f;
      for (int t = 0; t < p.tiles_j; ++t) s += pi[(int64_t)t * kSide * L];
      si[k] = s;
      s = 0.0f;
      for (int t = 0; t < p.tiles_i; ++t) s += pj[(int64_t)t * kSide * L];
      sj[k] = s;
    }
    float* out = dxyz + e * A * 3;
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
}

}  // namespace

// xyz: contiguous f32 (B, L, A, 3) with A >= 5, on `device`.  Each cotangent
// whose bit is set in `mask` (bit k: map k of d_ca, d_cb, d_no, omega,
// theta, phi) is a contiguous f32 (B, L, L) buffer; the others may be null.
// part_i and part_j are f32 scratch of B * tiles_j * 9 * L and B * tiles_i *
// 9 * L floats (the plan's tile counts); dxyz a contiguous f32 (B, L, A, 3)
// buffer, written in full.  `plan` is the walk of ops/pair_maps.bwd_plan.
// Launches both kernels on `stream` and returns cudaGetLastError() (0 =
// launched), or -3 for a plan this kernel cannot take.  The calling thread's
// current device is the same after the call.
extern "C" int ps_pair_maps_bwd_f32(int device, const float* xyz, int B, int L, int A, int mask,
                                    const float* g_ca, const float* g_cb, const float* g_no,
                                    const float* g_om, const float* g_th, const float* g_ph,
                                    float* part_i, float* part_j, float* dxyz, PairPlan plan,
                                    void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  if (!plan_fits(plan, L) || plan.vector) return kErrPlan;   // K2 stores no runs
  cudaStream_t s = (cudaStream_t)stream;
  pair_maps_bwd_kernel<<<plan.grid, kPairThreads, 0, s>>>(xyz, B, L, A, mask, plan, g_ca, g_cb,
                                                          g_no, g_om, g_th, g_ph, part_i, part_j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = ((int64_t)B * L + kReduceThreads - 1) / kReduceThreads;
  pair_maps_bwd_reduce<<<(int)min(blocks, (int64_t)0x7fffffff), kReduceThreads, 0, s>>>(
      part_i, part_j, B, L, A, plan, dxyz);
  return (int)cudaGetLastError();
}
