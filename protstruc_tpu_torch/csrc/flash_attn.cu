// Flash pair-bias attention, forward (K8) and backward (K9), for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the TPU kernels protstruc_tpu/ops/flash_attn.py: _fwd_kernel
// (launched by _fwd_call) and _bwd_kernel (launched by _bwd_call).  The
// op is softmax(q k^T * scale + bias) v over the keys that `kmask` allows,
// per (batch, head):
//
//   K8, one block per (b*h, 64-query tile): loops over 64-key tiles with a
//       running max m, denominator l and a float32 accumulator (registers),
//       then writes out = acc / l and lse = m + log(l).  A query row with no
//       allowed key writes zeros and lse = +1e30, so K9 recomputes p = 0 there
//       and every gradient through the row is 0.  Masked logits use the
//       finite sentinel -1e30.
//   K9, one block per (b*h, 64-key tile): loops over 64-query tiles,
//       recomputes p = exp(s - lse), accumulates dv += p^T dO and
//       dk += ds^T q * scale in registers (so no atomics: each block owns its
//       keys), and streams ds = p * (dp - delta) out in the bias's dtype and
//       layout.  delta = sum(dO * out) and dq = ds k * scale are plain
//       PyTorch outside the kernel, as in the JAX package.
//
// Rounding points follow the TPU kernels: products accumulate in float32;
// p is cast to the value dtype before p v and p^T dO, ds to the query dtype
// before ds^T q; for float32 operands these casts are exact.  Float32
// operands use float32 FMA loops (no TF32).  scale = 1/sqrt(dh) multiplies.
//
// Layouts.  q, k, v and dO are read through (batch, position, head) element
// strides with a contiguous head dim, so q, k, v can be views into one qkv
// projection.  bias is read through (b, h, i, j) strides and ds is written
// with the same strides, so the (B, L, L, H) output of the pair-bias Dense is
// read in place as (B, H, L, L) and no copy of it is made.  out, dk, dv are
// contiguous (B, L, H, dh); lse and delta contiguous (B, H, L).  Ragged L is
// masked inside the kernels; nothing is padded.
//
// What bounds it on an H100.  At the [attn] shape (B=1, H=8, L=4096, dh=32,
// bf16) the forward must read the 268 MB bias (0.08 ms at 3.35 TB/s) and do
// 17 GFLOP; the backward reads the bias once more and writes ds (0.16 ms).
// This first version runs the products as FMA loops over tiles staged in
// shared memory (one shared load per FMA), so it is bound by shared-memory
// bandwidth, well above those floors; wgmma/mma tiles are a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // four threads per tile row
constexpr int kW = kBK + 1;    // padded score-tile row
constexpr float kNeg = -1e30f;
constexpr float kLseMasked = 1e30f;

// Element strides; the head dim is contiguous.  g is dO.
struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, gb, gl, gh;
  long long bb, bh, bi, bj;  // bias, and ds
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back (exact for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f<T>(from_f<T>(v)); }

// rows [r0, r0 + 64) of a (position, head-dim) slab into a padded float tile
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const T* base, long long stride, int r0,
                                           int L) {
  for (int e = threadIdx.x; e < 64 * DH; e += kThreads) {
    int rr = e / DH, d = e % DH, r = r0 + rr;
    dst[rr * (DH + 1) + d] = r < L ? to_f<T>(base[(long long)r * stride + d]) : 0.0f;
  }
}

// the (64 x 64) bias tile at (i0, j0) into a padded float tile (0 outside L)
template <typename T>
__device__ __forceinline__ void stage_bias(float* dst, const T* bias, const Strides& st, int i0,
                                           int j0, int L) {
  for (int e = threadIdx.x; e < kBQ * kBK; e += kThreads) {
    int rr = e / kBK, c = e % kBK, i = i0 + rr, j = j0 + c;
    dst[rr * kW + c] = (i < L && j < L) ? to_f<T>(bias[i * st.bi + j * st.bj]) : 0.0f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ bias, const uint8_t* __restrict__ kmask, int H, int L,
                 float scale, Strides st, T* __restrict__ out, float* __restrict__ lse) {
  constexpr int P = DH + 1;
  constexpr int C = DH / 4;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq = smem;            // [kBQ][P]
  float* sk = sq + kBQ * P;    // [kBK][P]
  float* sv = sk + kBK * P;    // [kBK][P]
  float* ss = sv + kBK * P;    // [kBQ][kW]: bias, then p
  __shared__ bool sallow[kBK];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * kBQ;
  const int r = threadIdx.x >> 2, quad = threadIdx.x & 3;
  const int i = i0 + r;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const T* biasb = bias + b * st.bb + h * st.bh;

  stage_rows<T, DH>(sq, qb, st.ql, i0, L);
  float m = kNeg, l = 0.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int j0 = 0; j0 < L; j0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, DH>(sk, kb, st.kl, j0, L);
    stage_rows<T, DH>(sv, vb, st.vl, j0, L);
    stage_bias<T>(ss, biasb, st, i0, j0, L);
    if (threadIdx.x < kBK) {
      int j = j0 + threadIdx.x;
      sallow[threadIdx.x] = j < L && kmask[(long long)b * L + j] != 0;
    }
    __syncthreads();

    // thread (r, quad) owns logits of query row r at keys quad + 4c
    float s[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) s[c] = 0.0f;
    for (int d = 0; d < DH; ++d) {
      float qd = sq[r * P + d];
#pragma unroll
      for (int c = 0; c < 16; ++c) s[c] += qd * sk[(quad + 4 * c) * P + d];
    }
    float tmax = kNeg;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      int col = quad + 4 * c;
      float x = sallow[col] ? s[c] * scale + ss[r * kW + col] : kNeg;
      s[c] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      int col = quad + 4 * c;
      float p = sallow[col] ? expf(s[c] - m_new) : 0.0f;
      psum += p;
      ss[r * kW + col] = round_to<T>(p);  // p in the value dtype for p v
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four threads share one warp

#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      float pj = ss[r * kW + j];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += pj * sv[j * P + quad + 4 * c];
    }
  }

  if (i < L) {
    const bool has_keys = l > 0.0f;
    T* o = out + (((long long)b * L + i) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < C; ++c) o[quad + 4 * c] = from_f<T>(has_keys ? acc[c] / l : 0.0f);
    if (quad == 0) lse[(long long)bh * L + i] = has_keys ? m + logf(l) : kLseMasked;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ bias, const uint8_t* __restrict__ kmask,
                 const T* __restrict__ g, const float* __restrict__ lse,
                 const float* __restrict__ delta, int H, int L, float scale, Strides st,
                 T* __restrict__ ds, T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int P = DH + 1;
  constexpr int C = DH / 4;
  extern __shared__ float smem[];
  float* sk = smem;            // [kBK][P]
  float* sv = sk + kBK * P;    // [kBK][P]
  float* sq = sv + kBK * P;    // [kBQ][P]
  float* sg = sq + kBQ * P;    // [kBQ][P] dO
  float* sp = sg + kBQ * P;    // [kBQ][kW]: bias, then p
  float* sd = sp + kBQ * kW;   // [kBQ][kW]: ds
  __shared__ float slse[kBQ], sdelta[kBQ];
  __shared__ bool sallow[kBK];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * kBK;
  const int r = threadIdx.x >> 2, quad = threadIdx.x & 3;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* gb = g + b * st.gb + h * st.gh;
  const T* biasb = bias + b * st.bb + h * st.bh;
  T* dsb = ds + b * st.bb + h * st.bh;

  stage_rows<T, DH>(sk, k + b * st.kb + h * st.kh, st.kl, j0, L);
  stage_rows<T, DH>(sv, v + b * st.vb + h * st.vh, st.vl, j0, L);
  if (threadIdx.x < kBK) {
    int j = j0 + threadIdx.x;
    sallow[threadIdx.x] = j < L && kmask[(long long)b * L + j] != 0;
  }
  float dka[C], dva[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dka[c] = dva[c] = 0.0f;

  for (int i0 = 0; i0 < L; i0 += kBQ) {
    __syncthreads();
    stage_rows<T, DH>(sq, qb, st.ql, i0, L);
    stage_rows<T, DH>(sg, gb, st.gl, i0, L);
    stage_bias<T>(sp, biasb, st, i0, j0, L);
    if (threadIdx.x < kBQ) {
      int i = i0 + threadIdx.x;
      slse[threadIdx.x] = i < L ? lse[(long long)bh * L + i] : kLseMasked;
      sdelta[threadIdx.x] = i < L ? delta[(long long)bh * L + i] : 0.0f;
    }
    __syncthreads();

    // scores: thread (r, quad) owns query row r at keys quad + 4c
    float s[16], dp[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) s[c] = dp[c] = 0.0f;
    for (int d = 0; d < DH; ++d) {
      float qd = sq[r * P + d], gd = sg[r * P + d];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        s[c] += qd * sk[(quad + 4 * c) * P + d];
        dp[c] += gd * sv[(quad + 4 * c) * P + d];
      }
    }
    const float li = slse[r], de = sdelta[r];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      int col = quad + 4 * c;
      // lse is +1e30 on fully-masked rows, so p underflows to exactly 0
      float p = sallow[col] ? expf(s[c] * scale + sp[r * kW + col] - li) : 0.0f;
      sd[r * kW + col] = p * (dp[c] - de);
      sp[r * kW + col] = round_to<T>(p);  // p in dO's dtype for dv
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kBQ * kBK; e += kThreads) {
      int rr = e / kBK, c = e % kBK, i = i0 + rr, j = j0 + c;
      if (i < L && j < L) dsb[i * st.bi + j * st.bj] = from_f<T>(sd[rr * kW + c]);
    }
    // accumulate: thread (r, quad) owns key row r at head-dim columns quad + 4c
    for (int ii = 0; ii < kBQ; ++ii) {
      float pv = sp[ii * kW + r];
      float dsv = round_to<T>(sd[ii * kW + r]);  // ds in q's dtype for dk
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dva[c] += pv * sg[ii * P + quad + 4 * c];
        dka[c] += dsv * sq[ii * P + quad + 4 * c];
      }
    }
  }

  const int j = j0 + r;
  if (j < L) {
    long long o = (((long long)b * L + j) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[o + quad + 4 * c] = from_f<T>(dka[c] * scale);
      dv[o + quad + 4 * c] = from_f<T>(dva[c]);
    }
  }
}

Strides make_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                 s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
}

template <typename T, int DH>
int fwd(int B, int H, int L, float scale, const void* q, const void* k, const void* v,
        const void* bias, const uint8_t* kmask, const Strides& st, void* out, float* lse,
        cudaStream_t stream) {
  const int smem = (3 * 64 * (DH + 1) + kBQ * kW) * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)bias,
                                         kmask, H, L, scale, st, (T*)out, lse);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int bwd(int B, int H, int L, float scale, const void* q, const void* k, const void* v,
        const void* bias, const uint8_t* kmask, const void* g, const float* lse,
        const float* delta, const Strides& st, void* ds, void* dk, void* dv,
        cudaStream_t stream) {
  const int smem = (4 * 64 * (DH + 1) + 2 * kBQ * kW) * (int)sizeof(float);
  auto kern = flash_bwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBK - 1) / kBK, B * H);
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)bias,
                                         kmask, (const T*)g, lse, delta, H, L, scale, st,
                                         (T*)ds, (T*)dk, (T*)dv);
  return (int)cudaGetLastError();
}

constexpr int kErrUnsupported = -1;

#define PS_DISPATCH(CALL)                                                   \
  switch (dh) {                                                             \
    case 16: return dtype == 0 ? CALL(float, 16) : CALL(__nv_bfloat16, 16); \
    case 32: return dtype == 0 ? CALL(float, 32) : CALL(__nv_bfloat16, 32); \
    default: return kErrUnsupported;                                        \
  }

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, k, v, bias and out alike); dh 16 or
// 32 (the widths the port's models give).  `strides` holds the 16 element strides of Strides
// (the dO entries are not read).  kmask: contiguous uint8 (B, L).  out:
// contiguous (B, L, H, dh); lse: contiguous f32 (B, H, L).  Returns
// cudaGetLastError() (0 = launched) or -1 for an unsupported dtype or dh.
extern "C" int ps_flash_fwd(int device, int dtype, int B, int H, int L, int dh, float scale,
                            const void* q, const void* k, const void* v, const void* bias,
                            const uint8_t* kmask, const long long* strides, void* out,
                            float* lse, void* stream) {
  if (dtype != 0 && dtype != 1) return kErrUnsupported;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaSuccess;
  const Strides st = make_strides(strides);
  cudaStream_t s = (cudaStream_t)stream;
#define PS_FWD(T, D) fwd<T, D>(B, H, L, scale, q, k, v, bias, kmask, st, out, lse, s)
  PS_DISPATCH(PS_FWD)
#undef PS_FWD
}

// As ps_flash_fwd, plus dO (through its strides), lse and delta (contiguous
// f32 (B, H, L)); writes ds with the bias's strides, dk and dv contiguous
// (B, L, H, dh).
extern "C" int ps_flash_bwd(int device, int dtype, int B, int H, int L, int dh, float scale,
                            const void* q, const void* k, const void* v, const void* bias,
                            const uint8_t* kmask, const void* g, const float* lse,
                            const float* delta, const long long* strides, void* ds, void* dk,
                            void* dv, void* stream) {
  if (dtype != 0 && dtype != 1) return kErrUnsupported;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaSuccess;
  const Strides st = make_strides(strides);
  cudaStream_t s = (cudaStream_t)stream;
#define PS_BWD(T, D) bwd<T, D>(B, H, L, scale, q, k, v, bias, kmask, g, lse, delta, st, ds, dk, dv, s)
  PS_DISPATCH(PS_BWD)
#undef PS_BWD
}
