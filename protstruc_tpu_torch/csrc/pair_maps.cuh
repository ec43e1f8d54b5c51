// The per-pair arithmetic of the trRosetta pair maps, shared by K1
// (pair_maps.cu), its backward K2 (pair_maps_bwd.cu) and the roofline probes
// (pair_maps_probe.cu), so that every library evaluates one copy of it.  The
// libraries that include it are built with -fmad=false (ops/cuda_lib.py):
// each product and sum rounds once, in the order the plain PyTorch versions
// (ops/pair_maps.py) evaluate them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlotFloats = 5 * 3;   // atom slots 0-4 (N, CA, C, O, CB), xyz each

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

// K1's atan2: libdevice's atan2f (the TPU kernel's minimax atan2 existed only
// because Mosaic cannot lower atan2)
struct Atan2f {
  __device__ __forceinline__ float operator()(float y, float x) const { return atan2f(y, x); }
};

// signed dihedral a-b-c-d through the scalar-triple-product identity
// ((b0 x b1) x (b2 x b1)) . b1 = -(b1 . b1) ((b0 x b1) . b2)
template <class Atan2>
__device__ __forceinline__ float dihedral(V3 a, V3 b, V3 c, V3 d, Atan2 atan2_) {
  V3 b0 = sub(a, b), b1 = sub(c, b), b2 = sub(d, c);
  V3 n0 = cross(b0, b1), n1 = cross(b2, b1);
  float x = dot(n0, n1) + 0.0f;   // + 0.0f turns -0 into +0 before atan2
  float y = -sqrtf(dot(b1, b1)) * dot(n0, b2) + 0.0f;
  return atan2_(y, x);
}

// planar angle at b; NaN on a zero-length arm (the phi-map diagonal)
template <class Atan2>
__device__ __forceinline__ float planar_angle(V3 a, V3 b, V3 c, Atan2 atan2_) {
  V3 ba = sub(a, b), bc = sub(c, b);
  V3 cr = cross(ba, bc);
  float ang = atan2_(sqrtf(dot(cr, cr)), dot(ba, bc));
  bool zero = dot(bc, bc) == 0.0f || dot(ba, ba) == 0.0f;
  return zero ? __int_as_float(0x7fc00000) : ang;
}

// K1's maps of one (i, j) pair, those `mask` selects, each handed to
// store(k, value) with k the map's bit position.  ri and rj hold residue i's
// and residue j's atom slots 0-4.  Degenerate pairs are found by exact
// coordinate equality on the inputs and pinned to 0; NaN coordinates compare
// unequal, so missing atoms keep their NaN.
template <class Atan2, class Store>
__device__ __forceinline__ void pair_maps_at(const float* ri, const float* rj, int mask,
                                             Atan2 atan2_, Store store) {
  const V3 n_i = load3(ri, kN), ca_i = load3(ri, kCA), cb_i = load3(ri, kCB);
  const V3 ca_j = load3(rj, kCA), cb_j = load3(rj, kCB), o_j = load3(rj, kO);
  if (mask & kDCa) store(0, dist(ca_i, ca_j));
  if (mask & kDCb) store(1, dist(cb_i, cb_j));
  if (mask & kDNo) store(2, dist(n_i, o_j));
  if (mask & kOmega) {
    bool deg = (eq(ca_i, ca_j) && eq(cb_i, cb_j)) || eq(ca_j, cb_j) || eq(ca_i, cb_i);
    store(3, deg ? 0.0f : dihedral(ca_i, cb_i, ca_j, cb_j, atan2_));
  }
  if (mask & kTheta) {
    bool deg = (eq(n_i, cb_i) && eq(ca_i, cb_j)) || eq(cb_i, cb_j) || eq(n_i, ca_i);
    store(4, deg ? 0.0f : dihedral(n_i, ca_i, cb_i, cb_j, atan2_));
  }
  if (mask & kPhi) store(5, planar_angle(ca_i, cb_i, cb_j, atan2_));
}

// Stage atom slots 0-4 of `n` residues from r0 of one batch entry's xyz
// (L, A, 3) into shared memory, straight from the strided layout (no packing
// pass); residues past L read as 0 and are never written out.
__device__ __forceinline__ void stage_slots(float* dst, const float* base, int r0, int n, int L,
                                            int64_t res_stride, int tid, int nthreads) {
  for (int k = tid; k < n * kSlotFloats; k += nthreads) {
    int r = r0 + k / kSlotFloats;
    dst[k] = r < L ? base[r * res_stride + k % kSlotFloats] : 0.0f;
  }
}

}  // namespace
