// trRosetta pair maps (K1) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel protstruc_tpu/ops/pallas_pairwise.py:
// _make_trrosetta_kernel, launched by pairwise_maps_pallas.  It computes what
// that kernel computes, one output element per (b, i, j):
//
//   d_ca  = |CA_i - CA_j|          omega = dihedral(CA_i, CB_i, CA_j, CB_j)
//   d_cb  = |CB_i - CB_j|          theta = dihedral(N_i, CA_i, CB_i, CB_j)
//   d_no  = |N_i - O_j|            phi   = angle(CA_i, CB_i, CB_j)
//
// for the maps selected by a bitmask, into (B, L, L) planes of f32, or of
// bf16 (pairwise_maps_pallas(out_dtype=bfloat16): computed in f32, each value
// rounded to nearest even once, as a cast of the f32 planes rounds it).
//
// Numerics (held to the plain PyTorch version, ops/pair_maps.py):
//  * distances are sqrt of the summed squares;
//  * omega/theta use the scalar-triple-product form y = -|b1| (n0 . b2),
//    x = n0 . n1, and phi = atan2(|ba x bc|, ba . bc), NaN where |ba| or
//    |bc| is 0;
//  * degenerate pairs are found by exact coordinate equality on the inputs
//    and pinned to 0, so no degenerate value rests on the sign of zero or on
//    FMA contraction.  NaN coordinates compare unequal, so missing atoms keep
//    their NaN.  The "+ 0.0f" turns -0 into +0 before atan2f all the same;
//  * atan2f and sqrtf from libdevice (no --use_fast_math).  The TPU kernel's
//    minimax atan2 existed only because Mosaic cannot lower atan2;
//  * built with -fmad=false: every product and sum rounds once, in the order
//    the plain version evaluates them, so the f32 planes are bitwise equal to
//    the plain version's even where a dihedral is ill-conditioned.  The terms
//    of residue i alone (theta's n0 and |b1|, CA_i - CB_i, the i-only
//    equality tests) are built once a row (pair_maps.cuh PairI): the same
//    expressions, so the same bits.
//
// What bounds it on an H100: by bytes, the writes (six f32 maps are 24 B a
// pair, 1.61 GB at B=256, L=512: 0.48 ms at 3.35 TB/s; bf16 half that).  In
// fact the instructions: with every product and sum its own instruction
// (-fmad=false) and libdevice's exactly rounded sqrtf (5 a pair) and atan2f
// (3 a pair, each with a divide), the six maps take several hundred
// instructions a pair, and a version that stores nothing takes as long as
// the full one (PERF.md).  So the design spends its registers on warps: it
// runs the tile skeleton of pair_maps.cuh (a 256-thread block walks 128 (j)
// x 32 (i) tiles, stages each tile's atoms once, builds each row's i-side
// once), evaluates a row's four pairs map by map as four independent chains,
// reads the j atoms a map needs from shared memory, and stores each map's
// four values as one 16-byte (f32) or 8-byte (bf16) store where L is a
// multiple of 4; 64 registers, 4 blocks an SM.  The first version (a 32 x 8
// block, one pair a thread, 4-byte stores) took 1.46 ms.  Ragged edges are
// masked; nothing is padded.  The kernel allocates nothing and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "pair_maps.cuh"

namespace {

__device__ __forceinline__ void store_run(float* p, const float (&v)[kPairsJ], int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kPairsJ; ++q)
      if (q < n) p[q] = v[q];
  }
}

__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&v)[kPairsJ], int n,
                                          bool vec) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  } else {
#pragma unroll
    for (int q = 0; q < kPairsJ; ++q)
      if (q < n) p[q] = __float2bfloat16_rn(v[q]);
  }
}

// one map's value of one pair
struct ValueStore {
  float* v;
  __device__ __forceinline__ void operator()(int, float x) const { *v = x; }
};

// The selected maps of one row's run of pairs, map by map: each map's
// kPairsJ pairs are independent chains, stored as one run.  Map by map, a
// thread needs only one map's values and the atoms that map reads.
template <typename T>
struct MapsRow {
  int mask;
  T* planes[6];
  __device__ __forceinline__ void operator()(const PairI& I, const float* sjl, int64_t o, int n,
                                             bool vec, bool) const {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int bit = 1 << k;
      if (!(mask & bit)) continue;
      V3 ca[kPairsJ] = {}, cb[kPairsJ] = {}, ox[kPairsJ] = {};
      if (bit & (kDCa | kOmega)) load_j_atom(sjl, 0, ca);
      if (bit & (kDCb | kOmega | kTheta | kPhi)) load_j_atom(sjl, 1, cb);
      if (bit & kDNo) load_j_atom(sjl, 2, ox);
      float v[kPairsJ];
#pragma unroll
      for (int q = 0; q < kPairsJ; ++q)
        pair_maps_pair(I, pair_j(ca[q], cb[q], ox[q], bit), bit, Atan2f{}, ValueStore{&v[q]});
      store_run(planes[k] + o, v, n, vec);
    }
  }
};

// 64 registers a thread, 4 blocks (32 warps) an SM: the arithmetic is what
// bounds K1, and more warps hide more of its latency (PERF.md)
// Rows from xyz (B, Li, A, 3), columns from xyz_j (B, Lj, A, 3); the square
// launch passes xyz twice and Li = Lj = L.
template <typename T>
__global__ void __launch_bounds__(kPairThreads, 4)
pair_maps_kernel(const float* __restrict__ xyz, const float* __restrict__ xyz_j, int B, int Li,
                 int Lj, int A, PairPlan plan, MapsRow<T> row) {
  pair_tiles<3>(xyz, xyz_j, B, Li, Lj, A, plan, row.mask, row);
}

template <typename T>
int launch(int device, const float* xyz, const float* xyz_j, int B, int Li, int Lj, int A,
           int mask, T* d_ca, T* d_cb, T* d_no, T* omega, T* theta, T* phi, PairPlan plan,
           void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  MapsRow<T> row{mask, {d_ca, d_cb, d_no, omega, theta, phi}};
  for (int k = 0; k < 6; ++k)
    if (((mask >> k) & 1) && reinterpret_cast<uintptr_t>(row.planes[k]) % 16) return -2;
  if (B <= 0 || Li <= 0 || Lj <= 0) return (int)cudaSuccess;
  if (!plan_fits(plan, Li, Lj)) return -3;
  pair_maps_kernel<T><<<plan.grid, kPairThreads, 0, (cudaStream_t)stream>>>(xyz, xyz_j, B, Li,
                                                                           Lj, A, plan, row);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz: contiguous f32 (B, L, A, 3) with A >= 5, on `device`.  Each selected
// map pointer is a contiguous (B, L, L) buffer starting on a 16-byte
// boundary; unselected ones may be null.  `plan` is the walk
// ops/pair_maps.py tile_plan lays out for (B, L).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched), -2 for a misaligned plane or -3
// for a plan the kernel cannot take (pair_maps.cuh plan_fits).  The calling
// thread's current device is the same after the call.
extern "C" int ps_pair_maps_f32(int device, const float* xyz, int B, int L, int A,
                                int mask, float* d_ca, float* d_cb, float* d_no,
                                float* omega, float* theta, float* phi, PairPlan plan,
                                void* stream) {
  return launch(device, xyz, xyz, B, L, L, A, mask, d_ca, d_cb, d_no, omega, theta, phi, plan,
                stream);
}

// The same maps as bf16 planes (ps_pair_maps_f32's values rounded to
// nearest even).
extern "C" int ps_pair_maps_bf16(int device, const float* xyz, int B, int L, int A,
                                 int mask, __nv_bfloat16* d_ca, __nv_bfloat16* d_cb,
                                 __nv_bfloat16* d_no, __nv_bfloat16* omega,
                                 __nv_bfloat16* theta, __nv_bfloat16* phi, PairPlan plan,
                                 void* stream) {
  return launch(device, xyz, xyz, B, L, L, A, mask, d_ca, d_cb, d_no, omega, theta, phi, plan,
                stream);
}

// The rectangular mode (pairwise_maps_pallas(xyz_j=...)): rows i from xyz
// (B, Li, A, 3), columns j from xyz_j (B, Lj, A, 3), both contiguous f32
// with the same A, into (B, Li, Lj) planes of f32 (`bf16` 0) or bf16
// (`bf16` 1).  `plan` is ops/pair_maps.py tile_plan(B, Li, Lj).  The pins
// are coordinate-equality tests as in the square launch, so a row block of
// the square maps (xyz_j = the whole xyz, xyz its rows) has its bits.
extern "C" int ps_pair_maps_rect(int device, int bf16, const float* xyz, const float* xyz_j,
                                 int B, int Li, int Lj, int A, int mask, void* d_ca, void* d_cb,
                                 void* d_no, void* omega, void* theta, void* phi, PairPlan plan,
                                 void* stream) {
  if (bf16)
    return launch(device, xyz, xyz_j, B, Li, Lj, A, mask, (__nv_bfloat16*)d_ca,
                  (__nv_bfloat16*)d_cb, (__nv_bfloat16*)d_no, (__nv_bfloat16*)omega,
                  (__nv_bfloat16*)theta, (__nv_bfloat16*)phi, plan, stream);
  return launch(device, xyz, xyz_j, B, Li, Lj, A, mask, (float*)d_ca, (float*)d_cb,
                (float*)d_no, (float*)omega, (float*)theta, (float*)phi, plan, stream);
}
