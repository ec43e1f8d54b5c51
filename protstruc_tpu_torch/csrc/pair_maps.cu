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
// for the maps selected by a bitmask, into f32 (B, L, L) planes.
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
//    the plain version evaluates them, so the two agree to the rounding of
//    atan2f even where a dihedral is ill-conditioned (near-collinear atoms).
//
// What bounds it on an H100: the writes.  Six f32 maps are 24 B per pair,
// 1.61 GB at B=256, L=512 (about 0.48 ms at 3.35 TB/s), against a few hundred
// FP32 operations per pair (about 0.3 ms at 67 TFLOP/s).  The input is 60 B
// per residue and is read once per tile.  So the design keeps the stores
// dense and coalesced: a 32 (j) x 8 (i) thread block stages its i-rows' and
// j-columns' 15 floats (atom slots 0-4: N, CA, C, O, CB) in shared memory
// straight from xyz (B, L, A, 3), with no packing pass, and each warp then
// writes 32 consecutive floats (128 B) of one row of every requested map.
// Ragged edges are masked here; nothing is padded to the tile grid.  The
// kernel allocates nothing and does not synchronise.  This first version,
// one output per thread, runs at about a third of that write floor: a fixed
// per-block cost dominates (PERF.md has the times).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "pair_maps.cuh"

namespace {

constexpr int kTileJ = 32;           // threads along j: one warp per i-row
constexpr int kTileI = 8;            // i-rows per block

// the six maps' (B, L, L) planes (null where unselected); store(k, v) writes
// map k at offset o
struct PlaneStore {
  float* planes[6];
  int64_t o;
  __device__ __forceinline__ void operator()(int k, float v) const { planes[k][o] = v; }
};

__global__ void __launch_bounds__(kTileJ * kTileI)
pair_maps_kernel(const float* __restrict__ xyz, int L, int A, int mask,
                 float* __restrict__ d_ca, float* __restrict__ d_cb,
                 float* __restrict__ d_no, float* __restrict__ omega,
                 float* __restrict__ theta, float* __restrict__ phi) {
  __shared__ float si[kTileI * kSlotFloats];
  __shared__ float sj[kTileJ * kSlotFloats];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileI;
  const int j0 = blockIdx.x * kTileJ;
  const int tid = threadIdx.y * kTileJ + threadIdx.x;
  const int64_t res_stride = (int64_t)A * 3;
  const float* base = xyz + (int64_t)b * L * res_stride;

  stage_slots(sj, base, j0, kTileJ, L, res_stride, tid, kTileJ * kTileI);
  stage_slots(si, base, i0, kTileI, L, res_stride, tid, kTileJ * kTileI);
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= L || j >= L) return;

  pair_maps_at(si + threadIdx.y * kSlotFloats, sj + threadIdx.x * kSlotFloats, mask, Atan2f{},
               PlaneStore{{d_ca, d_cb, d_no, omega, theta, phi}, ((int64_t)b * L + i) * L + j});
}

}  // namespace

// xyz: contiguous f32 (B, L, A, 3) with A >= 5, on `device`.  Each selected
// map pointer is a contiguous f32 (B, L, L) buffer; unselected ones may be
// null.  Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The calling thread's current device is the same after the call.
extern "C" int ps_pair_maps_f32(int device, const float* xyz, int B, int L, int A,
                                int mask, float* d_ca, float* d_cb, float* d_no,
                                float* omega, float* theta, float* phi,
                                void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  dim3 block(kTileJ, kTileI);
  dim3 grid((L + kTileJ - 1) / kTileJ, (L + kTileI - 1) / kTileI, B);
  pair_maps_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      xyz, L, A, mask, d_ca, d_cb, d_no, omega, theta, phi);
  return (int)cudaGetLastError();
}
