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
// evaluates them: the cross products of residues that share an atom cancel
// exactly only without contraction.  rsqrtf is within 2 ulp; the card gate
// holds each plane to its plain version within 1e-5 (f32) or one bf16 ulp.
//
// The ang output is (B, L, L, 6), the layout the trunk's Dense reads: the
// TPU kernel wrote (B, 6, L, L) and the JAX package then moved the axis.
//
// What bounds it on an H100: the writes, 16 B per pair in bf16 (4 B of bins,
// 12 B of planes), 1.07 GB at B=256, L=512: 0.32 ms at 3.35 TB/s.  The input
// is 60 B per residue.  As in K1, a 32 (j) x 8 (i) block stages the N, CA and
// CB coordinates of its i-rows and j-columns in shared memory straight from
// xyz (B, L, A, 3) and each thread writes one pair; a warp's stores cover 32
// consecutive pairs of one row, 128 B of bins and 384 B (bf16) of planes.
// Ragged edges are masked, nothing is padded.  No allocation, no sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kTileJ = 32;
constexpr int kTileI = 8;
constexpr int kSlotFloats = 9;  // N, CA, CB: xyz each

// atom slots on the residue's atom axis (vocab.py ATOM)
constexpr int kN = 0, kCA = 1, kCB = 4;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* s, int k) {
  return V3{s[3 * k], s[3 * k + 1], s[3 * k + 2]};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ bool eq(V3 a, V3 b) { return a.x == b.x && a.y == b.y && a.z == b.z; }

// (sin, cos) of the dihedral a-b-c-d by the scalar-triple-product identity
__device__ __forceinline__ void sincos_dihedral(V3 a, V3 b, V3 c, V3 d, bool deg,
                                                float* s, float* co) {
  V3 b0 = sub(a, b), b1 = sub(c, b), b2 = sub(d, c);
  V3 n0 = cross(b0, b1), n1 = cross(b2, b1);
  float x = dot(n0, n1);
  float y = -sqrtf(dot(b1, b1)) * dot(n0, b2);
  float r2 = x * x + y * y;
  bool pos = r2 > 0.0f;  // false for NaN
  float inv = rsqrtf(pos ? r2 : 1.0f);
  bool ok = pos && !deg;
  *s = ok ? y * inv : 0.0f;
  *co = ok ? x * inv : (deg ? 1.0f : 0.0f);
}

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kTileJ * kTileI)
model_features_kernel(const float* __restrict__ xyz, int L, int A, int n_bins, float ratio,
                      float max_dist, int32_t* __restrict__ bins, T* __restrict__ ang) {
  __shared__ float si[kTileI * kSlotFloats];
  __shared__ float sj[kTileJ * kSlotFloats];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileI;
  const int j0 = blockIdx.x * kTileJ;
  const int tid = threadIdx.y * kTileJ + threadIdx.x;
  const int64_t res_stride = (int64_t)A * 3;
  const float* base = xyz + (int64_t)b * L * res_stride;

  // staged float f of a residue: atom N, CA or CB (f / 3), component f % 3
  for (int k = tid; k < kTileJ * kSlotFloats; k += kTileJ * kTileI) {
    int r = j0 + k / kSlotFloats, f = k % kSlotFloats;
    int slot = f / 3 == 2 ? kCB : (f / 3 == 1 ? kCA : kN);
    sj[k] = r < L ? base[r * res_stride + 3 * slot + f % 3] : 0.0f;
  }
  for (int k = tid; k < kTileI * kSlotFloats; k += kTileJ * kTileI) {
    int r = i0 + k / kSlotFloats, f = k % kSlotFloats;
    int slot = f / 3 == 2 ? kCB : (f / 3 == 1 ? kCA : kN);
    si[k] = r < L ? base[r * res_stride + 3 * slot + f % 3] : 0.0f;
  }
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= L || j >= L) return;

  const float* ri = si + threadIdx.y * kSlotFloats;
  const float* rj = sj + threadIdx.x * kSlotFloats;
  const V3 n_i = load3(ri, 0), ca_i = load3(ri, 1), cb_i = load3(ri, 2);
  const V3 ca_j = load3(rj, 1), cb_j = load3(rj, 2);

  const int64_t o = ((int64_t)b * L + i) * L + j;

  V3 dcb = sub(cb_i, cb_j);
  float d = sqrtf(dot(dcb, dcb));
  d = isnan(d) ? max_dist : d;
  bins[o] = (int32_t)fminf(d * ratio, (float)(n_bins - 1));

  float v[6];
  bool deg_o = (eq(ca_i, ca_j) && eq(cb_i, cb_j)) || eq(ca_j, cb_j) || eq(ca_i, cb_i);
  sincos_dihedral(ca_i, cb_i, ca_j, cb_j, deg_o, &v[0], &v[1]);
  bool deg_t = (eq(n_i, cb_i) && eq(ca_i, cb_j)) || eq(cb_i, cb_j) || eq(n_i, ca_i);
  sincos_dihedral(n_i, ca_i, cb_i, cb_j, deg_t, &v[2], &v[3]);

  V3 ba = sub(ca_i, cb_i), bc = sub(cb_j, cb_i);
  V3 cr = cross(ba, bc);
  float s2 = dot(cr, cr);
  float dt = dot(ba, bc);
  float r2 = s2 + dt * dt;
  bool okp = r2 > 0.0f;
  float inv = rsqrtf(okp ? r2 : 1.0f);
  v[4] = okp ? sqrtf(s2 > 0.0f ? s2 : 0.0f) * inv : 0.0f;
  v[5] = okp ? dt * inv : 0.0f;

  T* out = ang + o * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = cast_out<T>(v[k]);
}

}  // namespace

// xyz: contiguous f32 (B, L, A, 3) with A >= 5 on `device`; bins: contiguous
// int32 (B, L, L); ang: contiguous (B, L, L, 6) of ang_dtype (0 f32, 1 bf16).
// ratio = f32(n_bins / max_dist).  Launches on `stream`; returns
// cudaGetLastError() (0 = launched), or -1 for an unknown ang_dtype.
extern "C" int ps_model_features(int device, const float* xyz, int B, int L, int A, int n_bins,
                                 float ratio, float max_dist, int ang_dtype, int32_t* bins,
                                 void* ang, void* stream) {
  if (ang_dtype != 0 && ang_dtype != 1) return -1;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  dim3 block(kTileJ, kTileI);
  dim3 grid((L + kTileJ - 1) / kTileJ, (L + kTileI - 1) / kTileI, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (ang_dtype == 0)
    model_features_kernel<float><<<grid, block, 0, st>>>(xyz, L, A, n_bins, ratio, max_dist, bins,
                                                         (float*)ang);
  else
    model_features_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        xyz, L, A, n_bins, ratio, max_dist, bins, (__nv_bfloat16*)ang);
  return (int)cudaGetLastError();
}
