// Fused model-input features (K3) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel protstruc_tpu/ops/pallas_pairwise.py:
// _make_model_kernel, launched by model_features_pallas.  One pass over
// (B, L, L) emits exactly what the FoldModel trunk embeds and its loss reads:
//
//   bins[b, i, j]      int32 distogram bin of d_cb = |CB_i - CB_j|:
//                      int(min(d * ratio, n_bins - 1)), ratio = n_bins / max_dist
//                      rounded once to f32 by the caller, NaN d -> max_dist;
//   ang[b, i, j, 0:6]  [sin w, cos w, sin t, cos t, sin phi, cos phi] with
//                      w = dihedral(CA_i, CB_i, CA_j, CB_j),
//                      t = dihedral(N_i, CA_i, CB_i, CB_j),
//                      phi = angle(CA_i, CB_i, CB_j), in f32 or bf16.
//
// There is no atan2: sin and cos of atan2(y, x) are y / r and x / r with
// r = sqrt(x^2 + y^2), taken here as y * rsqrtf(r^2).  Pins, as in the TPU
// kernel: a degenerate w or t (found by exact coordinate equality on the
// inputs, K1's tests) gives (0, 1); a NaN or zero-length one gives (0, 0);
// phi's sine is |ba x bc| and its cosine ba . bc over the same rsqrt.
//
// Numerics: built with -fmad=false (cuda_lib.NVCC_FLAGS), so every product
// and sum rounds once, in the order the plain version (ops/model_features.py)
// evaluates it: the cross products of residues that share an atom cancel
// exactly only without contraction.  The terms of residue i alone (theta's
// n0 and -|b1|, CA_i - CB_i, the i-only equality tests) are built once a row
// (pair_maps.cuh PairI), the same expressions, so the same bits.  rsqrtf is
// within 2 ulp; the card gate holds each plane to its plain version within
// 1e-5 (f32) or one bf16 ulp.
//
// The ang output is (B, L, L, 6), the layout the trunk's Dense reads: the
// TPU kernel wrote (B, 6, L, L) and the JAX package then moved the axis.
//
// What bounds it on an H100: the writes, 16 B per pair in bf16 (4 B of bins,
// 12 B of planes), 1.07 GB at B=256, L=512: 0.32 ms at 3.35 TB/s.  The input
// is 36 B per residue.  As for K1, the instructions come close: two
// dihedrals and an angle a pair, each product and sum its own instruction,
// with a sqrtf and rsqrtf or two each.  K3 runs K1's tile skeleton
// (pair_maps.cuh): a 256-thread block walks 128 (j) x 32 (i) tiles, each
// thread four consecutive pairs of four rows, the i-side built once a row,
// and stores a row's four pairs as one 16-byte store of bins and 16-byte
// stores of their 24 plane values (three in bf16, six in f32, the f32 ones
// through shared memory) where L is a multiple of 4.  Ragged edges are
// masked, nothing is padded.  No allocation, no sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "pair_maps.cuh"

namespace {

// (sin, cos) of a dihedral from n0 = b0 x b1 and -|b1|, by the
// scalar-triple-product identity
__device__ __forceinline__ void sincos_n0(V3 n0, V3 b1, V3 b2, float neg_len_b1, bool deg,
                                          float* s, float* co) {
  V3 n1 = cross(b2, b1);
  float x = dot(n0, n1);
  float y = neg_len_b1 * dot(n0, b2);
  float r2 = x * x + y * y;
  bool pos = r2 > 0.0f;  // false for NaN
  float inv = rsqrtf(pos ? r2 : 1.0f);
  bool ok = pos && !deg;
  *s = ok ? y * inv : 0.0f;
  *co = ok ? x * inv : (deg ? 1.0f : 0.0f);
}

// the dihedral's (sin, cos) from its arms b0 = a - b, b1 = c - b, b2 = d - c
__device__ __forceinline__ void sincos_arms(V3 b0, V3 b1, V3 b2, bool deg, float* s, float* co) {
  sincos_n0(cross(b0, b1), b1, b2, -sqrtf(dot(b1, b1)), deg, s, co);
}

// one pair's bin and its six planes
__device__ __forceinline__ void features_pair(const PairI& I, const PairJ& J, int n_bins,
                                              float ratio, float max_dist, int32_t* bin,
                                              float (&v)[6]) {
  V3 dcb = sub(I.cb, J.cb);
  float d = sqrtf(dot(dcb, dcb));
  d = isnan(d) ? max_dist : d;
  *bin = (int32_t)fminf(d * ratio, (float)(n_bins - 1));

  bool deg_o = (eq(I.ca, J.ca) && eq(I.cb, J.cb)) || J.eq_ca_cb || I.eq_ca_cb;
  sincos_arms(I.cab, sub(J.ca, I.cb), J.ob2, deg_o, &v[0], &v[1]);
  V3 bc = sub(J.cb, I.cb);
  bool deg_t = (I.eq_n_cb && eq(I.ca, J.cb)) || eq(I.cb, J.cb) || I.eq_n_ca;
  sincos_n0(I.tn0, I.tb1, bc, I.tnh, deg_t, &v[2], &v[3]);

  V3 cr = cross(I.cab, bc);
  float s2 = dot(cr, cr);
  float dt = dot(I.cab, bc);
  float r2 = s2 + dt * dt;
  bool okp = r2 > 0.0f;
  float inv = rsqrtf(okp ? r2 : 1.0f);
  v[4] = okp ? sqrtf(s2 > 0.0f ? s2 : 0.0f) * inv : 0.0f;
  v[5] = okp ? dt * inv : 0.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// plane value e of a run's 24 (4 pairs x 6, pair-major)
#define K3_V(e) v[(e) / 6][(e) % 6]

// A run's 24 plane values as 16-byte pieces: six in f32, three in bf16.
__device__ __forceinline__ void pack_run(const float (&v)[kPairsJ][6], uint4 (&p)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
    p[k] = make_uint4(__float_as_uint(K3_V(4 * k)), __float_as_uint(K3_V(4 * k + 1)),
                      __float_as_uint(K3_V(4 * k + 2)), __float_as_uint(K3_V(4 * k + 3)));
}

__device__ __forceinline__ void pack_run(const float (&v)[kPairsJ][6], uint4 (&p)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p[k] = make_uint4(pack_bf16(K3_V(8 * k), K3_V(8 * k + 1)), pack_bf16(K3_V(8 * k + 2), K3_V(8 * k + 3)),
                      pack_bf16(K3_V(8 * k + 4), K3_V(8 * k + 5)), pack_bf16(K3_V(8 * k + 6), K3_V(8 * k + 7)));
}

#undef K3_V

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The pairs of one row's run, pair by pair (each pair's six planes are one
// contiguous stretch of the output), with the j atoms read from the stage.
// Stores: one 16-byte store of bins; the planes as 16-byte pieces, written
// straight from the lane in bf16 (three pieces, 48 bytes apart from lane to
// lane) and, in f32, where the warp's runs are one stretch (`wide`), through
// a shared buffer so that each store of the warp writes 512 contiguous
// bytes: six pieces 96 bytes apart from lane to lane scattered the stores
// too thinly (PERF.md).
template <typename T>
struct FeaturesRow {
  static constexpr int kPieces = kPairsJ * 6 * (int)sizeof(T) / 16;
  static constexpr bool kTranspose = sizeof(T) == 4;
  int n_bins;
  float ratio, max_dist;
  int32_t* bins;
  T* ang;
  __device__ __forceinline__ void operator()(const PairI& I, const float* sjl, int64_t o, int n,
                                             bool vec, bool wide) const {
    int32_t bn[kPairsJ];
    float v[kPairsJ][6];
#pragma unroll
    for (int q = 0; q < kPairsJ; ++q) {
      const V3 ca = load_j_one(sjl, 0, q), cb = load_j_one(sjl, 1, q);
      features_pair(I, pair_j(ca, cb, ca, kAllMaps), n_bins, ratio, max_dist, &bn[q], v[q]);
    }
    if (!vec) {
#pragma unroll
      for (int q = 0; q < kPairsJ; ++q) {
        if (q >= n) break;
        bins[o + q] = bn[q];
#pragma unroll
        for (int k = 0; k < 6; ++k) ang[(o + q) * 6 + k] = cast_out<T>(v[q][k]);
      }
      return;
    }
    *reinterpret_cast<int4*>(bins + o) = make_int4(bn[0], bn[1], bn[2], bn[3]);
    uint4 piece[kPieces];
    pack_run(v, piece);
    uint4* dst = reinterpret_cast<uint4*>(ang + o * 6);
    if constexpr (kTranspose) {
      if (wide) {
        __shared__ uint4 buf[kPairWarps][32 * kPieces];
        const int lane = threadIdx.x & 31;
        uint4* wb = buf[threadIdx.x >> 5];
#pragma unroll
        for (int k = 0; k < kPieces; ++k) wb[lane * kPieces + k] = piece[k];
        __syncwarp();
        dst -= lane * kPieces;   // the warp's first run
#pragma unroll
        for (int k = 0; k < kPieces; ++k) dst[lane + 32 * k] = wb[lane + 32 * k];
        __syncwarp();
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < kPieces; ++k) dst[k] = piece[k];
  }
};

// bf16: 64 registers, 4 blocks an SM; f32: 80 registers, 3 blocks (its
// stores, not its arithmetic, wanted fewer warps; PERF.md)
template <typename T>
__global__ void __launch_bounds__(kPairThreads, sizeof(T) == 2 ? 4 : 3)
model_features_kernel(const float* __restrict__ xyz, int B, int L, int A, PairPlan plan,
                      FeaturesRow<T> row) {
  pair_tiles<2>(xyz, B, L, A, plan, kAllMaps, row);
}

template <typename T>
int launch(const float* xyz, int B, int L, int A, int n_bins, float ratio, float max_dist,
           int32_t* bins, void* ang, PairPlan plan, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(bins) % 16 || reinterpret_cast<uintptr_t>(ang) % 16) return -2;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  if (!plan_fits(plan, L)) return -3;
  FeaturesRow<T> row{n_bins, ratio, max_dist, bins, (T*)ang};
  model_features_kernel<T><<<plan.grid, kPairThreads, 0, st>>>(xyz, B, L, A, plan, row);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz: contiguous f32 (B, L, A, 3) with A >= 5 on `device`; bins: contiguous
// int32 (B, L, L); ang: contiguous (B, L, L, 6) of ang_dtype (0 f32, 1 bf16);
// both on 16-byte boundaries.  ratio = f32(n_bins / max_dist).  `plan` is
// the walk ops/pair_maps.py tile_plan lays out for (B, L).  Launches on
// `stream`; returns cudaGetLastError() (0 = launched), -1 for an unknown
// ang_dtype, -2 for a misaligned output, -3 for a plan the kernel cannot
// take (pair_maps.cuh plan_fits).
extern "C" int ps_model_features(int device, const float* xyz, int B, int L, int A, int n_bins,
                                 float ratio, float max_dist, int ang_dtype, int32_t* bins,
                                 void* ang, PairPlan plan, void* stream) {
  if (ang_dtype != 0 && ang_dtype != 1) return -1;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t st = (cudaStream_t)stream;
  if (ang_dtype == 0) return launch<float>(xyz, B, L, A, n_bins, ratio, max_dist, bins, ang, plan, st);
  return launch<__nv_bfloat16>(xyz, B, L, A, n_bins, ratio, max_dist, bins, ang, plan, st);
}
