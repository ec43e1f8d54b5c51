// Roofline probes of the pair-map kernel K1 for Hopper (sm_90a), plain C
// interface for ctypes.  Measurement kernels only: nothing on a main path
// launches them (protstruc_tpu_torch/experiments/kernel_probe.py does).
//
// Replaces the TPU probes of experiments/kernel_probe.py: run_variant (P1),
// run_packed_variant (P2) and tile_sweep (P3).  Each variant keeps K1's
// skeleton (a TJ (j) x TI (i) thread block staging atom slots 0-4 of its
// residues in shared memory, ragged edges masked) and changes one thing:
//  * full: K1's own arithmetic (pair_maps.cuh, the code K1 runs);
//  * write-only: |CA_i - CA_j| stored to every selected output: K1's stores
//    with about a twentieth of its arithmetic;
//  * opt-d{9,11,13,15}[-fdiv]: K1 with the TPU kernel's odd minimax
//    polynomial atan2 of that degree in place of atan2f, the ratio by an
//    exact divide, or by min * rsqrtf(max^2) with -fdiv
//    (_make_opt_kernel(deg, fdiv, rsqrt_dist=False, drop_nan_where=False));
//  * the layout: the selected maps' separate (B, L, L) planes, or one
//    plane-major (B, 6, L, L) tensor (P2), set by the caller's plane pointers
//    and batch stride;
//  * the block: TJ threads along j, TI along i, each thread PPT pairs down i
//    (P2's j-widths 32/64/128, P3's shapes around K1's 32 x 8 x 1).
// full against write-only splits K1's time into stores and arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "pair_maps.cuh"

namespace {

struct Planes {
  float* p[6];
};

struct PlaneStore {
  Planes out;
  int64_t o;
  __device__ __forceinline__ void operator()(int k, float v) const { out.p[k][o] = v; }
};

// the odd minimax polynomials of the TPU probe (experiments/kernel_probe.py:
// _make_opt_kernel), coefficients rounded from double as JAX rounds them
template <int Deg>
struct Poly;
template <>
struct Poly<9> {
  static constexpr int n = 5;
  __device__ static float c(int k) {
    constexpr double v[n] = {9.998663318e-01, -3.303047936e-01, 1.801592832e-01,
                             -8.515630106e-02, 2.084508111e-02};
    return (float)v[k];
  }
};
template <>
struct Poly<11> {
  static constexpr int n = 6;
  __device__ static float c(int k) {
    constexpr double v[n] = {9.999772197e-01, -3.326228327e-01, 1.935403833e-01,
                             -1.164264699e-01, 5.264731915e-02, -1.171911837e-02};
    return (float)v[k];
  }
};
template <>
struct Poly<13> {
  static constexpr int n = 7;
  __device__ static float c(int k) {
    constexpr double v[n] = {9.999961117e-01, -3.331736824e-01, 1.980781622e-01,
                             -1.323334264e-01, 7.962366137e-02, -3.360419960e-02,
                             6.811783856e-03};
    return (float)v[k];
  }
};
template <>
struct Poly<15> {
  static constexpr int n = 8;
  __device__ static float c(int k) {
    constexpr double v[n] = {9.999999228e-01, -3.333223262e-01, 1.997402858e-01,
                             -1.404782123e-01, 1.000220526e-01, -6.087448222e-02,
                             2.533170106e-02, -5.021063911e-03};
    return (float)v[k];
  }
};

template <int Deg, bool FastDiv>
struct PolyAtan2 {
  __device__ __forceinline__ float operator()(float y, float x) const {
    const float ax = fabsf(x), ay = fabsf(y);
    const float maxv = fmaxf(ax, ay), minv = fminf(ax, ay);
    float t;
    if (FastDiv) {
      const float safe = maxv == 0.0f ? 1.0f : maxv;
      t = minv * rsqrtf(safe * safe);
    } else {
      t = minv / (maxv == 0.0f ? 1.0f : maxv);
    }
    const float zz = t * t;
    float p = Poly<Deg>::c(Poly<Deg>::n - 1);
#pragma unroll
    for (int k = Poly<Deg>::n - 2; k >= 0; --k) p = p * zz + Poly<Deg>::c(k);
    p = p * t;
    float r = ay > ax ? 1.5707963267948966f - p : p;
    r = x < 0.0f ? 3.141592653589793f - r : r;
    r = y < 0.0f ? -r : r;
    return isnan(x) || isnan(y) ? __int_as_float(0x7fc00000) : r;
  }
};

template <class Atan2>
struct MapsOp {
  __device__ __forceinline__ void operator()(const float* ri, const float* rj, int mask,
                                             Planes out, int64_t o) const {
    pair_maps_at(ri, rj, mask, Atan2{}, PlaneStore{out, o});
  }
};

struct WriteOnlyOp {
  __device__ __forceinline__ void operator()(const float* ri, const float* rj, int mask,
                                             Planes out, int64_t o) const {
    const float d = dist(load3(ri, kCA), load3(rj, kCA));
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if ((mask >> k) & 1) out.p[k][o] = d;
  }
};

template <class Op, int TJ, int TI, int PPT>
__global__ void __launch_bounds__(TJ * TI)
probe_kernel(const float* __restrict__ xyz, int L, int A, int mask, Planes out, int64_t bstride) {
  __shared__ float si[TI * PPT * kSlotFloats];
  __shared__ float sj[TJ * kSlotFloats];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * (TI * PPT);
  const int j0 = blockIdx.x * TJ;
  const int tid = threadIdx.y * TJ + threadIdx.x;
  const int64_t res_stride = (int64_t)A * 3;
  const float* base = xyz + (int64_t)b * L * res_stride;

  stage_slots(sj, base, j0, TJ, L, res_stride, tid, TJ * TI);
  stage_slots(si, base, i0, TI * PPT, L, res_stride, tid, TJ * TI);
  __syncthreads();

  const int j = j0 + threadIdx.x;
  if (j >= L) return;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int il = threadIdx.y + TI * p;
    const int i = i0 + il;
    if (i >= L) return;
    Op{}(si + il * kSlotFloats, sj + threadIdx.x * kSlotFloats, mask, out,
         (int64_t)b * bstride + (int64_t)i * L + j);
  }
}

template <class Op, int TJ, int TI, int PPT>
cudaError_t launch(const float* xyz, int B, int L, int A, int mask, const Planes& out,
                   int64_t bstride, cudaStream_t s) {
  dim3 grid((L + TJ - 1) / TJ, (L + TI * PPT - 1) / (TI * PPT), B);
  probe_kernel<Op, TJ, TI, PPT><<<grid, dim3(TJ, TI), 0, s>>>(xyz, L, A, mask, out, bstride);
  return cudaGetLastError();
}

// op 0 full, 1 write-only, 2 + 2 * d + f the polynomial atan2 of degree
// 9 + 2 d with f = 1 for the -fdiv ratio; blocks as the wrapper lists them
template <int TJ, int TI, int PPT>
cudaError_t dispatch_block(int op, const float* xyz, int B, int L, int A, int mask,
                           const Planes& out, int64_t bstride, cudaStream_t s) {
  if (op == 0) return launch<MapsOp<Atan2f>, TJ, TI, PPT>(xyz, B, L, A, mask, out, bstride, s);
  if (op == 1) return launch<WriteOnlyOp, TJ, TI, PPT>(xyz, B, L, A, mask, out, bstride, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_opt(int op, const float* xyz, int B, int L, int A, int mask,
                         const Planes& out, int64_t bstride, cudaStream_t s) {
  switch (op) {
#define PROBE_OPT(code, deg, fdiv) \
  case code:                       \
    return launch<MapsOp<PolyAtan2<deg, fdiv>>, 32, 8, 1>(xyz, B, L, A, mask, out, bstride, s);
    PROBE_OPT(2, 9, false)
    PROBE_OPT(3, 9, true)
    PROBE_OPT(4, 11, false)
    PROBE_OPT(5, 11, true)
    PROBE_OPT(6, 13, false)
    PROBE_OPT(7, 13, true)
    PROBE_OPT(8, 15, false)
    PROBE_OPT(9, 15, true)
#undef PROBE_OPT
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// xyz: contiguous f32 (B, L, A, 3) with A >= 5, on `device`.  Map k (bit k
// of `mask`: d_ca, d_cb, d_no, omega, theta, phi) is written at
// planes[k] + b * bstride + i * L + j; unselected planes may be null.  The
// block is (tj, ti) threads, ppt pairs each down i: 32x8x1 for every op;
// 64x4x1, 128x2x1, 32x4x1, 32x16x1, 32x8x2, 32x8x4 for ops 0 and 1 (op 0
// only at 64x4x1 and 128x2x1).  Returns cudaErrorInvalidValue for another
// combination, else cudaGetLastError() after the launch on `stream`.  The
// calling thread's current device is the same after the call.
extern "C" int ps_pair_maps_probe_f32(int device, int op, int tj, int ti, int ppt,
                                      const float* xyz, int B, int L, int A, int mask,
                                      float* p0, float* p1, float* p2, float* p3, float* p4,
                                      float* p5, long long bstride, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  const Planes out{{p0, p1, p2, p3, p4, p5}};
  cudaStream_t s = (cudaStream_t)stream;
  const int shape = tj * 10000 + ti * 100 + ppt;
  if (op >= 2) {
    if (shape != 320801) return (int)cudaErrorInvalidValue;
    return (int)dispatch_opt(op, xyz, B, L, A, mask, out, bstride, s);
  }
  switch (shape) {
    case 320801: return (int)dispatch_block<32, 8, 1>(op, xyz, B, L, A, mask, out, bstride, s);
    case 320401: return (int)dispatch_block<32, 4, 1>(op, xyz, B, L, A, mask, out, bstride, s);
    case 321601: return (int)dispatch_block<32, 16, 1>(op, xyz, B, L, A, mask, out, bstride, s);
    case 320802: return (int)dispatch_block<32, 8, 2>(op, xyz, B, L, A, mask, out, bstride, s);
    case 320804: return (int)dispatch_block<32, 8, 4>(op, xyz, B, L, A, mask, out, bstride, s);
    case 640401:
      if (op != 0) return (int)cudaErrorInvalidValue;
      return (int)launch<MapsOp<Atan2f>, 64, 4, 1>(xyz, B, L, A, mask, out, bstride, s);
    case 1280201:
      if (op != 0) return (int)cudaErrorInvalidValue;
      return (int)launch<MapsOp<Atan2f>, 128, 2, 1>(xyz, B, L, A, mask, out, bstride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
