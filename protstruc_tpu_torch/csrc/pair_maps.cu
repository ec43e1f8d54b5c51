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
#include <math.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kTileJ = 32;           // threads along j: one warp per i-row
constexpr int kTileI = 8;            // i-rows per block
constexpr int kSlotFloats = 5 * 3;   // atom slots 0-4, xyz each

// atom slots on the residue's atom axis (vocab.py ATOM)
constexpr int kN = 0, kCA = 1, kO = 3, kCB = 4;

// bit k selects map k in this order: d_ca, d_cb, d_no, omega, theta, phi
constexpr int kDCa = 1, kDCb = 2, kDNo = 4, kOmega = 8, kTheta = 16, kPhi = 32;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* s, int slot) {
  return V3{s[3 * slot], s[3 * slot + 1], s[3 * slot + 2]};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ bool eq(V3 a, V3 b) { return a.x == b.x && a.y == b.y && a.z == b.z; }
__device__ __forceinline__ float dist(V3 a, V3 b) {
  V3 d = sub(a, b);
  return sqrtf(dot(d, d));
}

// signed dihedral a-b-c-d through the scalar-triple-product identity
// ((b0 x b1) x (b2 x b1)) . b1 = -(b1 . b1) ((b0 x b1) . b2)
__device__ __forceinline__ float dihedral(V3 a, V3 b, V3 c, V3 d) {
  V3 b0 = sub(a, b), b1 = sub(c, b), b2 = sub(d, c);
  V3 n0 = cross(b0, b1), n1 = cross(b2, b1);
  float x = dot(n0, n1) + 0.0f;
  float y = -sqrtf(dot(b1, b1)) * dot(n0, b2) + 0.0f;
  return atan2f(y, x);
}

// planar angle at b; NaN on a zero-length arm (the phi-map diagonal)
__device__ __forceinline__ float planar_angle(V3 a, V3 b, V3 c) {
  V3 ba = sub(a, b), bc = sub(c, b);
  V3 cr = cross(ba, bc);
  float ang = atan2f(sqrtf(dot(cr, cr)), dot(ba, bc));
  bool zero = dot(bc, bc) == 0.0f || dot(ba, ba) == 0.0f;
  return zero ? __int_as_float(0x7fc00000) : ang;
}

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

  // stage slots 0-4 of the block's residues; rows past L read as 0 and are
  // never written out
  for (int k = tid; k < kTileJ * kSlotFloats; k += kTileJ * kTileI) {
    int r = j0 + k / kSlotFloats;
    sj[k] = r < L ? base[r * res_stride + k % kSlotFloats] : 0.0f;
  }
  for (int k = tid; k < kTileI * kSlotFloats; k += kTileJ * kTileI) {
    int r = i0 + k / kSlotFloats;
    si[k] = r < L ? base[r * res_stride + k % kSlotFloats] : 0.0f;
  }
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= L || j >= L) return;

  const float* ri = si + threadIdx.y * kSlotFloats;
  const float* rj = sj + threadIdx.x * kSlotFloats;
  const V3 n_i = load3(ri, kN), ca_i = load3(ri, kCA), cb_i = load3(ri, kCB);
  const V3 ca_j = load3(rj, kCA), cb_j = load3(rj, kCB), o_j = load3(rj, kO);

  const int64_t o = ((int64_t)b * L + i) * L + j;

  if (mask & kDCa) d_ca[o] = dist(ca_i, ca_j);
  if (mask & kDCb) d_cb[o] = dist(cb_i, cb_j);
  if (mask & kDNo) d_no[o] = dist(n_i, o_j);
  if (mask & kOmega) {
    bool deg = (eq(ca_i, ca_j) && eq(cb_i, cb_j)) || eq(ca_j, cb_j) || eq(ca_i, cb_i);
    omega[o] = deg ? 0.0f : dihedral(ca_i, cb_i, ca_j, cb_j);
  }
  if (mask & kTheta) {
    bool deg = (eq(n_i, cb_i) && eq(ca_i, cb_j)) || eq(cb_i, cb_j) || eq(n_i, ca_i);
    theta[o] = deg ? 0.0f : dihedral(n_i, ca_i, cb_i, cb_j);
  }
  if (mask & kPhi) phi[o] = planar_angle(ca_i, cb_i, cb_j);
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
