// Fused triangle-multiplication kernels (K4-K7) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernels of protstruc_tpu/ops/tri_mul.py:
//   K4 _prologue_fwd_kernel (l.107)   K5 _prologue_bwd_kernel (l.121)
//   K6 _epilogue_fwd_kernel (l.267)   K7 _epilogue_bwd_kernel (l.279)
// Each computes what its Pallas body computes over the (N, C) pair rows, with
// the same rounding points as the plain versions in ops/tri_mul.py:
//  * LayerNorm statistics in f32, fast variance E[x^2] - mu^2, eps 1e-6;
//  * the product input is the LayerNorm output cast to the stream dtype T;
//    products accumulate in f32 and the bias is added in f32;
//  * in the backward, dpre (dag, dap, ... / dpre, du) is cast to T before the
//    back-projection and the weight-gradient product;
//  * bias and LayerNorm gradients are column sums of the f32 values; all
//    gradients are summed in f32 and cast to T once at the end.
//
// Matrix products run inside the kernels.  The resident rows passes (K4-K7),
// the wide route (K4-K7) and the weight-gradient pass (K5 and K7) use
// mma.sync on the tensor cores: bf16 m16n8k16 with f32 accumulators,
// float32 as 3xTF32 m16n8k8 (x = big + small, three TF32 products, small
// terms first; helpers in mma.cuh, shared with flash_attn.cu).
//
// Which route each kernel takes, a function of kind, dtype and C alone
// (make_plan; ps_tri_route reports it):
//
//   resident  K4 prologue_fwd_resident_kernel   bf16 C <= 128, float32 C <= 64
//             K5 prologue_bwd_resident_kernel   the same widths
//             K6 epilogue_fwd_resident_kernel   the same widths
//             K7 epilogue_bwd_resident_kernel   the same widths
//   wide      K4, K6: wide_ln_kernel, wide_gate_kernel<T, NA, true>
//             K5, K7: wide_ln_kernel, wide_gate_kernel<T, NA, false>,
//             wide_back_kernel, wide_ln_bwd_kernel
//             (the note above wide_ln_kernel)   bf16 C > 128, float32 C > 64
//                                               (C = 128 in the MoE blocks'
//                                               pair rows, [mfu-fused]'s
//                                               width in float32)
// The backward routes end in the weight-gradient pass and the reductions.
//
// Any width C >= 1 (the Pallas kernels take any C as one (C, C) block).  The
// tiles work on Cp = round_up(C, 16), the width the route is read at: a
// ragged C comes staged by the wrapper (ops/tri_mul.py) into zero-padded
// (N, Cp) rows and (Cp, Cp) weights, and the kernels are told C apart
// (Plan::cl).  Zero columns add nothing to a LayerNorm's sums, to a product
// or to a column sum, so only the LayerNorms' divisors (forward statistics,
// the backward's mean(dxh) and mean(dxh xhat)) take C; xhat past C is not
// zero, but its scale is, so dxh is zero there.  Columns past C of the
// outputs are left to the wrapper, which cuts them off.  The resident
// passes with a LayerNorm, and the resident weight-gradient pass, are built
// twice (kRagged): at a multiple of 16 (Cp = C, no copy) they run the code
// they ran before ragged widths were taken, the same SASS (one build reading
// cl at run time moves bf16 K6's registers from 128 to 124, PERF.md); at a
// ragged width their second build divides by cl (ln_divisor; the
// weight-gradient pass runs ln_smem_rows over cl).  The wide route's
// memory-bound LayerNorm kernels take the row width and the divisor as two
// ints, one build.
//
// The resident passes.  One persistent block an SM (8 warps, K4 and K6 16;
// grid min(tiles / warps, SMs)) copies its weights into shared memory once
// (cp.async, padded a row: K4 and K5 wag, wap, wbg, wbp, 136 KB in bf16 at
// C = 128; K6 and K7 wog, wo, 68 KB) and every warp walks its own 16-row
// tiles through a cp.async ring of its own: K5 and K7 two stages, the next
// tile's rows (K5 x, K7 x and p) in flight; K4 one stage of x, its 16 warps
// hiding each other's waits; K6 one stage of x and p, refilled with the
// next tile's rows as soon as s and t are in registers.  The forward half is
// shared: the LayerNorm statistics and s = LN(x) computed on the fragments in
// registers, s as the A fragments of s @ W (W read with ldmatrix.trans;
// float32 by hand), all of a chunk's products at once.  K4 applies the gates
// and the mask to the accumulator fragments and stores a and b as pairs; K6
// keeps s and t both (bf16 as packed A fragments, float32 as f32 values split
// to tf32 at each k step), forms g's and u's pre-activations a 16-column
// chunk at a time and stores out = g u as pairs.  K5 and K7 run the gate
// backward on the fragments, cast dpre (K7: dpre and du) to T once, store it
// to the scratch and, as registers, use it as the A fragment of dpre @ W^T,
// which reads the same copy of W (ldmatrix; float32 in the k order 0, 2, 4,
// 6, 1, 3, 5, 7).
// dsrc stays in registers (16 x C f32 a warp) and the LayerNorm backward and
// dx come from it.  K7 keeps one dsrc at a time: LN1's after the chunks, then
// dt = du @ Wo^T from du read back from the scratch, and LN2's; K7 rebuilds
// t = LN2(p)'s fragments from the ring a k step at a time (keeping s and t
// both in registers spilled).  Cotangents are read from global memory
// straight into the fragments' registers (shared memory holds the weights
// and the rings).  Column sums: warp shuffles over a fragment's rows, a
// per-lane running sum per chunk, then warp by warp into the block's vacc.
// Registers a thread (bf16 / float32, ptxas, PERF.md): K5 236 / 218 and K7
// 255 / 247, no spills, so 8 warps an SM; K4 110 / 124 and K6 128 / 128, 16
// warps.  Each takes 215,040 bytes of the 232,448 of shared memory a block
// may have (bf16, C = 128).
//
// What bounds them on an H100 at N = 4*512*512, C = 128, bf16 (the bytes each
// input read once and each output written once, at 3.35 TB/s; the products
// at 989 TFLOP/s): K4 and K6 0.81 GB, 0.24 ms (K4 137 GFLOP, 0.14 ms; K6
// 69 GFLOP, 0.07 ms); K5 412 GFLOP, 0.42 ms (about 2.4 GB with its dpre
// scratch, 0.7 ms); K7 1.34 GB, 0.40 ms (206 GFLOP, 0.21 ms), with the 0.54
// GB dpre/du scratch written and read back on top.  The resident rows passes run far from these: each warp's
// tile is a chain of dependent phases (ring wait, LayerNorm, products,
// cotangent loads, gate, back-projection, LayerNorm backward) and 8 warps an
// SM hide little of it; probes that drop one phase each (PERF.md) find no
// single part dominant (K6: the products, which reread both weights from
// shared memory for every 16-row tile, the LayerNorms and the gate's exp
// each about a quarter).  The weight-gradient pass is bound by its
// per-step ring.

// The Pallas backwards sum weight gradients into one block that the
// sequential TPU grid revisits.  Here blocks run in parallel, so:
//  * bias and LayerNorm gradients: each persistent block (grid fixed by the
//    SM count) sums its tiles' columns and writes one f32 partial; a second
//    kernel adds the partials in block order;
//  * weight gradients dW = s^T @ dpre: the rows kernel writes dpre (cast to
//    T) to a scratch buffer; wgrad_kernel gives each block a chunk of rows,
//    one job (K5: wag, wap, wbg, wbp; K7: wog, wo) and one output tile,
//    recomputes s from the pair rows, and sums s^T @ dpre on mma.sync into
//    an f32 partial; the same reduction kernel adds the chunks in order.  On
//    the resident route (C <= 128) the tile is all of C x C, so a row's
//    LayerNorm is computed once per job.  The wide route keeps s as a plane
//    in T and the pass reads its tile's columns of it instead (tiles of at
//    most 128 x 128).
// No atomics: the result is the same from run to run.  The kernels allocate
// nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-6f;
constexpr int kPadT = 8;     // row padding of T tiles, in elements
constexpr int kWgRows = 64;  // rows per step of the weight-gradient kernel, at most
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kErrUnsupportedC = -1;
constexpr int kErrBadArgs = -2;

// the rows passes a kernel takes (make_plan; ps_tri_route)
enum Route { kRouteResident = 0, kRouteWide = 1 };

enum Kind { kProFwd = 0, kProBwd = 1, kEpiFwd = 2, kEpiBwd = 3 };

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T fromf(float v);
template <> __device__ __forceinline__ float fromf<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 fromf<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// launch plan and shared-memory layout (computed alike on host and device)
// ---------------------------------------------------------------------------

struct Plan {
  int N, C;                // C: the width the tiles work on, round_up(cl, 16)
  int lds;                 // row stride of the resident weight-gradient pass's rows and s
  int njobs, tiles, chunks, chunk_rows, wg_tile, wg_rows;  // weight-gradient kernel
  int cl;                  // the logical width: the LayerNorms' divisor (in the padding
                           // before wg_smem, so Plan keeps its 72 bytes)
  size_t wg_smem;
  int resident, res_grid;  // the resident-weight rows pass (K4-K7) takes this shape
  size_t res_smem;
  long long work_floats;   // f32 scratch: grid*6*C vector partials + chunks*njobs*C*C (wide: HostPlan)
};

// What only the host reads of a call's plan: the route, the SM count and, on
// the wide route, the workspace's layout in floats: the row tiles' column
// sums (rtiles, 6, C), the weight-gradient chunks (chunks, njobs, C, C), the
// LayerNorm statistics (n_ln, 2, N: mean, 1/sigma), dsrc (N, C) and the
// LayerNorm planes in the stream dtype (n_ln, N, C).  Kept out of Plan,
// which the kernels take by value: a larger Plan changed the resident
// passes' code and made them slower (PERF.md section 6).
struct HostPlan {
  int route;   // kRouteResident or kRouteWide
  int nsm;     // the device's SMs
  int rtiles;  // wide route: 128-row tiles
  long long off_vpart, off_wpart, off_stats, off_dsrc, off_s;
};

// The LayerNorms' divisor in a resident pass or the resident weight-gradient
// pass: the tile width C at a multiple of 16 (the code those widths ran before
// a ragged width was taken), the logical width cl at a ragged one.
template <bool kRagged>
__device__ __forceinline__ int ln_divisor(const Plan& p) {
  if constexpr (kRagged) return p.cl;
  else return p.C;
}

struct Carver {
  uintptr_t base;
  size_t off;
  __host__ __device__ uintptr_t take(size_t bytes) {
    off = (off + 127) & ~size_t(127);
    const uintptr_t r = base + off;
    off += bytes;
    return r;
  }
};

__host__ __device__ inline int n_ln(int kind) { return kind >= kEpiFwd ? 2 : 1; }
__host__ __device__ inline int n_dpre(int kind) {
  return kind == kProBwd ? 4 : (kind == kEpiBwd ? 2 : 0);
}
__host__ __device__ inline bool is_bwd(int kind) { return kind == kProBwd || kind == kEpiBwd; }

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// Pointers of one rows-kernel launch.  Prologue: aux is the mask (N,),
// vec = lns, lnb, bag, bap, bbg, bbp and mat = wag, wap, wbg, wbp.
// Epilogue: aux is the product rows (N, C), vec = ln1s, ln1b, bog, ln2s,
// ln2b, bo and mat = wog, wo.
template <typename T>
struct RowArgs {
  const T* x;
  const T* aux;
  const T* vec[6];
  const T* mat[4];
  const T* ct[2];   // backward cotangents: da, db / do
  T* out[2];        // a, b / out / dx / dx, dp
  T* dpre;          // backward: (n_dpre, N, C) cast dpre for the weight gradients
  float* vec_part;  // backward: (grid, 6, C) per-block column sums
};

// ---------------------------------------------------------------------------
// resident-weight rows passes of K4-K7 (bf16 C <= 128, float32 C <= 64)
// ---------------------------------------------------------------------------

constexpr int kResWarps = 8;  // warps a block (K5, K7); each walks 16-row tiles alone
// The forward passes (K4, K6) need about half the registers: 16 warps a
// block, each with a ring of one stage (the same shared memory as 8 warps of
// two stages)
constexpr int kFwdWarps = 16;

__host__ __device__ inline int res_warps(int kind) { return is_bwd(kind) ? kResWarps : kFwdWarps; }

// widths whose weights fit in shared memory, with the rows' rings
template <typename T> struct ResMax;
template <> struct ResMax<bf16> { static constexpr int C = 128; };
template <> struct ResMax<float> { static constexpr int C = 64; };

// Row strides, in elements, of the weights and of the row rings.  Both keep
// rows 16-byte aligned; the weights' pad makes ldmatrix (bf16) and the
// hand-read tf32 fragments (float32) hit 32 distinct banks, the rings' pad
// the A-fragment reads of the rows.
__host__ __device__ inline int res_ldw(int C) { return C + 8; }
template <typename T> __host__ __device__ inline int res_ldx(int C) {
  return sizeof(T) == 2 ? C + 8 : C + 4;
}

// weights resident, and row sources ringed, in the resident pass of `kind`:
// the prologue's four weights and its x; the epilogue's two and its x and p
__host__ __device__ inline int res_nw(int kind) { return kind >= kEpiFwd ? 2 : 4; }
__host__ __device__ inline int res_nsrc(int kind) { return kind >= kEpiFwd ? 2 : 1; }

// Shared memory of a resident pass: nw weights (C x ldw each, row-major
// (in, out)), the six vectors as f32, the block's column sums of their
// gradients, and 2 kResWarps ring stages of 16 rows of each of nsrc row
// sources: two a warp in K5 and K7 (the warp's stage s holds source j at (s
// nsrc + j) 16 ldx), one a warp in K4 and K6.
template <typename T>
struct ResSmem {
  T* w;
  float* vec;   // RowArgs::vec as f32
  float* vacc;  // the six gradients' column sums (backward)
  T* xs;        // (kResWarps, 2, nsrc, 16, ldx)

  __host__ __device__ static size_t carve(uintptr_t base, int C, int nw, int nsrc, ResSmem* out) {
    Carver cv{base, 0};
    ResSmem r{};
    r.w = (T*)cv.take(sizeof(T) * nw * C * res_ldw(C));
    r.vec = (float*)cv.take(sizeof(float) * 6 * C);
    r.vacc = (float*)cv.take(sizeof(float) * 6 * C);
    r.xs = (T*)cv.take(sizeof(T) * kResWarps * 2 * nsrc * 16 * res_ldx<T>(C));
    if (out) *out = r;
    return cv.off;
  }
};

__device__ __forceinline__ float quad_sum(float v) {  // over the 4 lanes of a row (t)
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float column_sum(float v) {  // over the 8 row groups (g)
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The nw weights into shared memory (cp.async, one group, not waited for)
// and the six vectors as f32; the column sums zeroed.
template <typename T>
__device__ void res_load_weights(const ResSmem<T>& sm, const RowArgs<T>& a, int C, int nw) {
  constexpr int E = 16 / (int)sizeof(T);
  const int ch = C / E, ldw = res_ldw(C), NT = blockDim.x;  // ch: 16-byte pieces a row
  for (int e = threadIdx.x; e < nw * C * ch; e += NT) {
    const int k = e / (C * ch), r = (e / ch) % C, c = (e % ch) * E;
    cp_async16(sm.w + ((size_t)k * C + r) * ldw + c, a.mat[k] + (size_t)r * C + c);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 6 * C; i += NT) {
    sm.vec[i] = tof(a.vec[i / C][i % C]);
    sm.vacc[i] = 0.0f;
  }
}

// Rows [r0, r0 + 16) of x into a ring stage (rows past N are zeros), by one
// warp, as one cp.async group.
template <typename T>
__device__ void res_load_rows(T* dst, const T* __restrict__ x, int64_t r0, int N, int C, int ldx) {
  constexpr int E = 16 / (int)sizeof(T);
  const int ch = C / E, lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * ch; e += 32) {
    const int r = e / ch, c = (e % ch) * E;
    if (r0 + r < N) cp_async16(dst + r * ldx + c, x + (r0 + r) * C + c);
    else *reinterpret_cast<uint4*>(dst + r * ldx + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// The block's column sums, warp by warp in order, then its partial.  Lane
// (g, t) holds, of each of the six vectors, columns CW g + 8 (q / 2) + 2t +
// q % 2 at slot q < CW / 4 (CW: the chunk width, 16 or 8).
template <int CW, typename T>
__device__ void res_store_partial(const ResSmem<T>& sm, const float (&vs)[6][CW / 4], int C,
                                  float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int w = 0; w < kResWarps; ++w) {
    __syncthreads();
    if (warp == w && g < C / CW) {
#pragma unroll
      for (int v = 0; v < 6; ++v)
#pragma unroll
        for (int q = 0; q < CW / 4; ++q) sm.vacc[v * C + CW * g + 8 * (q >> 1) + 2 * t + (q & 1)] += vs[v][q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * C; i += kResWarps * 32) part[(size_t)blockIdx.x * 6 * C + i] = sm.vacc[i];
}

// Rows [r0, r0 + 16) of x and, when y is given, of y into a warp's ring
// stage (y's rows 16 ldx after x's).
template <typename T>
__device__ __forceinline__ void res_load_stage(T* stage, const T* __restrict__ x,
                                               const T* __restrict__ y, int64_t r0, int N, int C,
                                               int ldx) {
  res_load_rows(stage, x, r0, N, C, ldx);
  if (y) res_load_rows(stage + 16 * ldx, y, r0, N, C, ldx);
}

// The forward half of a resident pass, shared by K4, K5 and K7.
//
// LayerNorm statistics of rows g, g + 8 of a 16-row tile in a ring stage:
// f32, fast variance; each row's mean and 1/sigma over its cl logical columns
// (the C - cl columns past them are zero and add nothing).
__device__ __forceinline__ void res_ln_stats(const bf16* xt, int ldx, int C, int cl, float (&mu)[2],
                                             float (&inv)[2]) {
  constexpr int KMAX = ResMax<bf16>::C / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, nk = C / 16;
  float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk < nk) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v0, v1;
          load_pair(xt + (g + 8 * h) * ldx + 16 * kk + 8 * j + 2 * t, v0, v1);
          sum[h] += v0 + v1;
          sq[h] += v0 * v0 + v1 * v1;
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mu[h] = quad_sum(sum[h]) / cl;
    const float var = quad_sum(sq[h]) / cl - mu[h] * mu[h];
    inv[h] = rsqrtf(var + kEps);
  }
}

__device__ __forceinline__ void res_ln_stats(const float* xt, int ldx, int C, int cl, float (&mu)[2],
                                             float (&inv)[2]) {
  constexpr int KMAX = ResMax<float>::C / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, nk = C / 8;
  float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < nk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = xt[(g + 8 * h) * ldx + 8 * k + t], v1 = xt[(g + 8 * h) * ldx + 8 * k + t + 4];
        sum[h] += v0 + v1;
        sq[h] += v0 * v0 + v1 * v1;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mu[h] = quad_sum(sum[h]) / cl;
    const float var = quad_sum(sq[h]) / cl - mu[h] * mu[h];
    inv[h] = rsqrtf(var + kEps);
  }
}

// k16 step kk of the LayerNorm output cast to bf16, as the A fragment of s @
// W: register 2j + h holds columns 16 kk + 8 j + 2t, + 1 of row g + 8 h.
__device__ __forceinline__ void res_ln_frag(const bf16* xt, int ldx, const float* lns,
                                            const float* lnb, const float (&mu)[2],
                                            const float (&inv)[2], int kk, uint32_t (&sa)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * kk + 8 * j + 2 * t;
      float v0, v1;
      load_pair(xt + (g + 8 * h) * ldx + c, v0, v1);
      sa[2 * j + h] = pack_bf16((v0 - mu[h]) * inv[h] * lns[c] + lnb[c],
                                (v1 - mu[h]) * inv[h] * lns[c + 1] + lnb[c + 1]);
    }
}

// The same in float32 for k8 step k, split into tf32 (big, small): a0 (g,
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
__device__ __forceinline__ void res_ln_frag(const float* xt, int ldx, const float* lns,
                                            const float* lnb, const float (&mu)[2],
                                            const float (&inv)[2], int k, uint32_t (&sb)[4],
                                            uint32_t (&ss)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = i & 1, c = 8 * k + t + 4 * (i >> 1);
    split_tf32((xt[(g + 8 * h) * ldx + c] - mu[h]) * inv[h] * lns[c] + lnb[c], sb[i], ss[i]);
  }
}

// The tile's statistics and every step's A fragments (bf16), kept in registers.
template <int KMAX>
__device__ __forceinline__ void res_ln_frags(const bf16* xt, int ldx, const float* lns,
                                             const float* lnb, int C, int cl, float (&mu)[2],
                                             float (&inv)[2], uint32_t (&sa)[KMAX][4]) {
  res_ln_stats(xt, ldx, C, cl, mu, inv);
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk)
    if (kk < C / 16) res_ln_frag(xt, ldx, lns, lnb, mu, inv, kk, sa[kk]);
}

// The same in float32 (split tf32 fragments).
template <int KMAX>
__device__ __forceinline__ void res_ln_frags(const float* xt, int ldx, const float* lns,
                                             const float* lnb, int C, int cl, float (&mu)[2],
                                             float (&inv)[2], uint32_t (&sb)[KMAX][4],
                                             uint32_t (&ss)[KMAX][4]) {
  res_ln_stats(xt, ldx, C, cl, mu, inv);
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k < C / 8) res_ln_frag(xt, ldx, lns, lnb, mu, inv, k, sb[k], ss[k]);
}

// pre[w] += s @ W_w[:, n0:n0 + 16] (n8 tiles j = 0, 1) for the NW weights at
// w0 (W_w at w0 + w C ldw), s's A fragments sa, all NW at once: 2 NW
// independent accumulators.  W read with ldmatrix.trans.
template <int NW, int KMAX>
__device__ __forceinline__ void res_products(const bf16* w0, int ldw, int C,
                                             const uint32_t (&sa)[KMAX][4], int n0,
                                             float (&pre)[NW][2][4]) {
  const int lane = threadIdx.x & 31, nk = C / 16;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk < nk) {
      const int off = (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldw + n0 + (lane >> 4) * 8;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t bw[4];
        ldsm_x4_trans(bw, w0 + (size_t)w * C * ldw + off);
        mma_bf16(pre[w][0], sa[kk], bw[0], bw[1]);
        mma_bf16(pre[w][1], sa[kk], bw[2], bw[3]);
      }
    }
  }
}

// The same in float32 for one n8 tile (columns n0..n0 + 7), 3xTF32; W's B
// fragments read by hand: b0 = W[8k + t][n0 + g], b1 = W[8k + t + 4][n0 + g].
template <int NW, int KMAX>
__device__ __forceinline__ void res_products(const float* w0, int ldw, int C,
                                             const uint32_t (&sb)[KMAX][4],
                                             const uint32_t (&ss)[KMAX][4], int n0,
                                             float (&pre)[NW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, nk = C / 8;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < nk) {
      const int off = (8 * k + t) * ldw + n0 + g;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* W = w0 + (size_t)w * C * ldw;
        uint32_t b[4];
        split_tf32(W[off], b[0], b[2]);
        split_tf32(W[off + 4 * ldw], b[1], b[3]);
        mma_3xtf32(pre[w], sb[k], ss[k], b);
      }
    }
  }
}

// ds += d @ W[:, n0:n0 + 16]^T: d the cast cotangent of one 16-column chunk
// as an A fragment (its C fragments packed), W read with ldmatrix; ds holds
// 16 x C in n8 tiles.
template <int NMAX>
__device__ __forceinline__ void res_back_project(float (&ds)[NMAX][4], const uint32_t (&d)[4],
                                                 const bf16* w, int ldw, int C, int n0) {
  const int lane = threadIdx.x & 31, nk = C / 16;
#pragma unroll
  for (int np = 0; np < NMAX / 2; ++np) {
    if (np < nk) {
      const int off = (16 * np + (lane >> 4) * 8 + (lane & 7)) * ldw + n0 + ((lane >> 3) & 1) * 8;
      uint32_t b[4];
      ldsm_x4(b, w + off);
      mma_bf16(ds[2 * np], d, b[0], b[1]);
      mma_bf16(ds[2 * np + 1], d, b[2], b[3]);
    }
  }
}

// The same in float32 for one 8-column chunk: d's C fragment is the A
// fragment of the product when its k index runs (0, 2, 4, 6, 1, 3, 5, 7) on
// d and on W^T alike (a0 = c0, a1 = c2, a2 = c1, a3 = c3); b0 = W[8np +
// g][n0 + 2t], b1 = W[8np + g][n0 + 2t + 1].
template <int NMAX>
__device__ __forceinline__ void res_back_project(float (&ds)[NMAX][4], const float (&d)[4],
                                                 const float* w, int ldw, int C, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, nk = C / 8;
  uint32_t db[4], dsm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(d[(i >> 1) | ((i & 1) << 1)], db[i], dsm[i]);
#pragma unroll
  for (int np = 0; np < NMAX; ++np) {
    if (np < nk) {
      float w0, w1;
      uint32_t b[4];
      load_pair(w + (8 * np + g) * ldw + n0 + 2 * t, w0, w1);
      split_tf32(w0, b[0], b[2]);
      split_tf32(w1, b[1], b[3]);
      mma_3xtf32(ds[np], db, dsm, b);
    }
  }
}

// LayerNorm backward of rows g, g + 8 of a tile from dsrc in C fragments (n8
// tile n of columns 8n + 2t, + 1): dx = inv (dxh - mean(dxh) - xhat
// mean(dxh xhat)), dxh = dsrc lns, stored for rows below N; the column sums of
// dsrc * xhat and dsrc go to slot (n % (CW / 8)) * 2 + e of vsx and vsb in
// the lane whose g is the chunk n / (CW / 8).
template <int CW, int NMAX, typename T>
__device__ __forceinline__ void res_ln_backward(const float (&ds)[NMAX][4], const T* xt, int ldx,
                                                const float* lns, const float (&mu)[2],
                                                const float (&inv)[2], int64_t r0, int N, int C, int cl,
                                                T* __restrict__ dx, float (&vsx)[CW / 4],
                                                float (&vsb)[CW / 4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nn = C / 8;
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    if (n < nn) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int c = 8 * n + 2 * t;
        float x0, x1;
        load_pair(xt + (g + 8 * rr) * ldx + c, x0, x1);
        const float xh0 = (x0 - mu[rr]) * inv[rr], xh1 = (x1 - mu[rr]) * inv[rr];
        const float d0 = ds[n][2 * rr] * lns[c], d1 = ds[n][2 * rr + 1] * lns[c + 1];
        s1[rr] += d0 + d1;
        s2[rr] += d0 * xh0 + d1 * xh1;
      }
    }
  }
  float m1[2], m2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    m1[rr] = quad_sum(s1[rr]) / cl;
    m2[rr] = quad_sum(s2[rr]) / cl;
  }
  constexpr int PER = CW / 8;  // n8 tiles a chunk
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    if (n < nn) {
      const int c = 8 * n + 2 * t;
      float xh[4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float x0, x1;
        load_pair(xt + (g + 8 * rr) * ldx + c, x0, x1);
        xh[2 * rr] = (x0 - mu[rr]) * inv[rr];
        xh[2 * rr + 1] = (x1 - mu[rr]) * inv[rr];
        const int64_t row = r0 + g + 8 * rr;
        if (row < N) {
          const float d0 = ds[n][2 * rr] * lns[c], d1 = ds[n][2 * rr + 1] * lns[c + 1];
          store_pair(dx + row * C + c, inv[rr] * (d0 - m1[rr] - xh[2 * rr] * m2[rr]),
                     inv[rr] * (d1 - m1[rr] - xh[2 * rr + 1] * m2[rr]));
        }
      }
      // LayerNorm gradients: column sums of dsrc * xhat and dsrc
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sx = column_sum(ds[n][e] * xh[e] + ds[n][2 + e] * xh[2 + e]);
        const float sb = column_sum(ds[n][e] + ds[n][2 + e]);
        if (g == n / PER) {
          vsx[2 * (n % PER) + e] += sx;
          vsb[2 * (n % PER) + e] += sb;
        }
      }
    }
  }
}

// A chunk of rows [r0, r0 + 16) of the cast cotangent d (this lane's own
// stores to the scratch, read back from global memory) as the A fragment of
// its back-projection: bf16 16 columns as packed pairs, float32 8 columns
// as its C fragment.  Rows past N read 0.
__device__ __forceinline__ void res_load_frag(const bf16* d, int64_t r0, int N, int C, int n0,
                                              uint32_t (&f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int64_t row = r0 + g + 8 * rr;
      f[2 * j + rr] = row < N ? *reinterpret_cast<const uint32_t*>(d + row * C + n0 + 8 * j + 2 * t) : 0u;
    }
}

__device__ __forceinline__ void res_load_frag(const float* d, int64_t r0, int N, int C, int n0,
                                              float (&f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t row = r0 + g + 8 * rr;
    f[2 * rr] = f[2 * rr + 1] = 0.0f;
    if (row < N) load_pair(d + row * C + n0 + 2 * t, f[2 * rr], f[2 * rr + 1]);
  }
}

template <typename T> struct ResFrag { using type = float; };  // an A-fragment register
template <> struct ResFrag<bf16> { using type = uint32_t; };

// The backward of one row source of a tile: dsrc = d @ W^T over every chunk
// of the cast cotangent d (read back with res_load_frag), then the LayerNorm
// backward (res_ln_backward) into dx and the column sums vsx, vsb.
template <int V, typename T>
__device__ __forceinline__ void res_backward_rows(const T* d, const T* w, int ldw, const T* xt,
                                                  int ldx, const float* lns, const float (&mu)[2],
                                                  const float (&inv)[2], int64_t r0, int N, int C, int cl,
                                                  T* __restrict__ dx, float (&vsx)[V],
                                                  float (&vsb)[V]) {
  constexpr int CW = 4 * V, NCH = ResMax<T>::C / CW;  // chunk width, chunks at most
  const int nch = C / CW;
  typename ResFrag<T>::type f[NCH][4];
#pragma unroll
  for (int nc = 0; nc < NCH; ++nc)
    if (nc < nch) res_load_frag(d, r0, N, C, CW * nc, f[nc]);
  float ds[ResMax<T>::C / 8][4] = {};  // dsrc, 16 x C, as C fragments
#pragma unroll
  for (int nc = 0; nc < NCH; ++nc)
    if (nc < nch) res_back_project(ds, f[nc], w, ldw, C, CW * nc);
  res_ln_backward<CW>(ds, xt, ldx, lns, mu, inv, r0, N, C, cl, dx, vsx, vsb);
}

// K5 rows pass with the four weights resident in shared memory.  Warp w of
// block b walks the 16-row tiles b * kResWarps + w, + grid * kResWarps, ...
// with the next tile's rows of x in flight (a two-stage cp.async ring a
// warp); lane (g, t) = (lane / 4, lane % 4) owns rows g and g + 8 of a tile.
// Products on mma.sync (bf16 m16n8k16 with f32 accumulators): s @ W reads W
// with ldmatrix.trans, the back-projection dpre @ W^T the same copy with
// ldmatrix.  In each 16-column chunk the lane holds columns 2t, 2t + 1,
// 2t + 8 and 2t + 9: the C fragments of s @ W, which, packed to bf16, are the
// A fragments of the back-projection, so dpre never leaves the registers
// before its cast and its store to the scratch.
template <bool kRagged>
__global__ void __launch_bounds__(kResWarps * 32, 1)
prologue_bwd_resident_kernel(RowArgs<bf16> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<bf16> sm;
  ResSmem<bf16>::carve((uintptr_t)smem_raw, p.C, res_nw(kProBwd), res_nsrc(kProBwd), &sm);
  constexpr int KMAX = ResMax<bf16>::C / 16;  // k16 steps, and 16-column chunks, at most
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<bf16>(C), nk = C / 16, cl = ln_divisor<kRagged>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kResWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kResWarps;
  bf16* const xs = sm.xs + (size_t)warp * 2 * 16 * ldx;

  res_load_weights(sm, a, C, res_nw(kProBwd));
  if (first < ntiles) res_load_rows(xs, a.x, first * 16, p.N, C, ldx);
  cp_async_wait_all();
  __syncthreads();

  const float* lns = sm.vec;
  const float* lnb = sm.vec + C;
  // column sums this lane keeps: chunk g, columns 8j + 2t + e at slot 2j + e,
  // of dsrc * xhat, dsrc, dag, dap, dbg, dbp
  float vs[6][4];
#pragma unroll
  for (int v = 0; v < 6; ++v) vs[v][0] = vs[v][1] = vs[v][2] = vs[v][3] = 0.0f;

  int st = 0;
  for (int64_t tile = first; tile < ntiles; tile += stride, st ^= 1) {
    cp_async_wait_all();
    __syncwarp();  // this tile's rows landed; the other stage's readers are done
    if (tile + stride < ntiles) res_load_rows(xs + (st ^ 1) * 16 * ldx, a.x, (tile + stride) * 16, p.N, C, ldx);
    const bf16* xt = xs + st * 16 * ldx;
    const int64_t r0 = tile * 16;

    float mu[2], inv[2], mrow[2];
    uint32_t sa[KMAX][4];
    res_ln_frags(xt, ldx, lns, lnb, C, cl, mu, inv, sa);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + g + 8 * h;
      mrow[h] = row < p.N ? tof(a.aux[row]) : 0.0f;
    }

    float ds[2 * KMAX][4];  // dsrc, 16 x C, as C fragments
#pragma unroll
    for (int n = 0; n < 2 * KMAX; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.0f;

    for (int nc = 0; nc < nk; ++nc) {
      const int n0 = 16 * nc;
      // the four pre-activations s @ W[:, n0:n0+16] (wag, wap, wbg, wbp) at
      // once: eight independent accumulators (one half after the other ran
      // slower, PERF.md)
      float fwd[4][2][4] = {};
      res_products<4>(sm.w, ldw, C, sa, n0, fwd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // (dag, dap), then (dbg, dbp)
        const bf16* wg = sm.w + (size_t)(2 * h) * C * ldw;
        const bf16* wp = wg + (size_t)C * ldw;
        float ct[2][4];  // the cotangent at the C-fragment positions of this chunk
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int64_t row = r0 + g + 8 * rr;
            ct[j][2 * rr] = ct[j][2 * rr + 1] = 0.0f;
            if (row < p.N)
              load_pair(a.ct[h] + row * C + n0 + 8 * j + 2 * t, ct[j][2 * rr], ct[j][2 * rr + 1]);
          }
        const float (&fg)[2][4] = fwd[2 * h];
        const float (&fp)[2][4] = fwd[2 * h + 1];
        // gate backward on the fragments: dproj = ct sigma, dgate = ct proj sigma (1 - sigma)
        const float* bgv = sm.vec + (2 + 2 * h) * C + n0;
        const float* bpv = sm.vec + (3 + 2 * h) * C + n0;
        float dg[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            const float ctm = ct[j][e] * mrow[e >> 1];
            const float sg = sigmoidf(fg[j][e] + bgv[c]);
            const float pj = fp[j][e] + bpv[c];
            dp[j][e] = ctm * sg;
            dg[j][e] = ctm * pj * sg * (1.0f - sg);
          }
        // dpre cast to bf16 once: the A fragments of the back-projection, and the scratch
        const uint32_t ag[4] = {pack_bf16(dg[0][0], dg[0][1]), pack_bf16(dg[0][2], dg[0][3]),
                                pack_bf16(dg[1][0], dg[1][1]), pack_bf16(dg[1][2], dg[1][3])};
        const uint32_t ap[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                                pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
        bf16* dgo = a.dpre + (size_t)(2 * h) * p.N * C;
        bf16* dpo = dgo + (size_t)p.N * C;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int64_t row = r0 + g + 8 * rr;
            if (row < p.N) {
              const int64_t o = row * C + n0 + 8 * j + 2 * t;
              *reinterpret_cast<uint32_t*>(dgo + o) = ag[2 * j + rr];
              *reinterpret_cast<uint32_t*>(dpo + o) = ap[2 * j + rr];
            }
          }
        // bias gradients: column sums of the f32 values (rows past N are 0)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sg_ = column_sum(dg[j][e] + dg[j][2 + e]);
            const float sp_ = column_sum(dp[j][e] + dp[j][2 + e]);
            if (g == nc) {
              vs[2 + 2 * h][2 * j + e] += sg_;
              vs[3 + 2 * h][2 * j + e] += sp_;
            }
          }
        // dsrc += dgate @ Wg[:, n0:n0+16]^T + dproj @ Wp[:, n0:n0+16]^T
#pragma unroll
        for (int np = 0; np < KMAX; ++np) {
          if (np < nk) {
            const int off = (16 * np + (lane >> 4) * 8 + (lane & 7)) * ldw + n0 + ((lane >> 3) & 1) * 8;
            uint32_t bg[4], bp[4];
            ldsm_x4(bg, wg + off);
            ldsm_x4(bp, wp + off);
            mma_bf16(ds[2 * np], ag, bg[0], bg[1]);
            mma_bf16(ds[2 * np + 1], ag, bg[2], bg[3]);
            mma_bf16(ds[2 * np], ap, bp[0], bp[1]);
            mma_bf16(ds[2 * np + 1], ap, bp[2], bp[3]);
          }
        }
      }
    }
    res_ln_backward<16>(ds, xt, ldx, lns, mu, inv, r0, p.N, C, cl, a.out[0], vs[0], vs[1]);
  }
  res_store_partial<16>(sm, vs, C, a.vec_part);
}

// The float32 rows pass, the same walk on 3xTF32 mma.sync m16n8k8 (x = big +
// small, each tf32; three products, small terms first).  A fragment of s:
// rows g, g + 8, columns k0 + t and k0 + t + 4, split in registers after the
// LayerNorm.  The chunk is one n8 tile: the C fragment of dpre (columns 2t,
// 2t + 1) is the A fragment of its back-projection when that product runs
// its k index as (0, 2, 4, 6, 1, 3, 5, 7) on dpre and on W^T alike, so dpre
// stays in registers.  W's fragments are read by hand from shared memory.
template <bool kRagged>
__global__ void __launch_bounds__(kResWarps * 32, 1)
prologue_bwd_resident_kernel(RowArgs<float> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<float> sm;
  ResSmem<float>::carve((uintptr_t)smem_raw, p.C, res_nw(kProBwd), res_nsrc(kProBwd), &sm);
  constexpr int KMAX = ResMax<float>::C / 8;  // k8 steps, and 8-column chunks, at most
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<float>(C), nk = C / 8, cl = ln_divisor<kRagged>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kResWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kResWarps;
  float* const xs = sm.xs + (size_t)warp * 2 * 16 * ldx;

  res_load_weights(sm, a, C, res_nw(kProBwd));
  if (first < ntiles) res_load_rows(xs, a.x, first * 16, p.N, C, ldx);
  cp_async_wait_all();
  __syncthreads();

  const float* lns = sm.vec;
  const float* lnb = sm.vec + C;
  float vs[6][2];  // column sums: chunk g, columns 2t + e at slot e
#pragma unroll
  for (int v = 0; v < 6; ++v) vs[v][0] = vs[v][1] = 0.0f;

  int st = 0;
  for (int64_t tile = first; tile < ntiles; tile += stride, st ^= 1) {
    cp_async_wait_all();
    __syncwarp();
    if (tile + stride < ntiles) res_load_rows(xs + (st ^ 1) * 16 * ldx, a.x, (tile + stride) * 16, p.N, C, ldx);
    const float* xt = xs + st * 16 * ldx;
    const int64_t r0 = tile * 16;

    float mu[2], inv[2], mrow[2];
    uint32_t sb[KMAX][4], ss[KMAX][4];
    res_ln_frags(xt, ldx, lns, lnb, C, cl, mu, inv, sb, ss);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + g + 8 * h;
      mrow[h] = row < p.N ? a.aux[row] : 0.0f;
    }

    float ds[KMAX][4];  // dsrc, 16 x C, as C fragments
#pragma unroll
    for (int n = 0; n < KMAX; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.0f;

    for (int nc = 0; nc < nk; ++nc) {
      const int n0 = 8 * nc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* wg = sm.w + (size_t)(2 * h) * C * ldw;
        const float* wp = wg + (size_t)C * ldw;
        float ct[4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = r0 + g + 8 * rr;
          ct[2 * rr] = ct[2 * rr + 1] = 0.0f;
          if (row < p.N) load_pair(a.ct[h] + row * C + n0 + 2 * t, ct[2 * rr], ct[2 * rr + 1]);
        }
        float pre[2][4] = {};
        res_products<2>(wg, ldw, C, sb, ss, n0, pre);
        const float (&fg)[4] = pre[0];
        const float (&fp)[4] = pre[1];
        const float* bgv = sm.vec + (2 + 2 * h) * C + n0;
        const float* bpv = sm.vec + (3 + 2 * h) * C + n0;
        float dg[4], dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * t + (e & 1);
          const float ctm = ct[e] * mrow[e >> 1];
          const float sg = sigmoidf(fg[e] + bgv[c]);
          const float pj = fp[e] + bpv[c];
          dp[e] = ctm * sg;
          dg[e] = ctm * pj * sg * (1.0f - sg);
        }
        float* dgo = a.dpre + (size_t)(2 * h) * p.N * C;
        float* dpo = dgo + (size_t)p.N * C;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = r0 + g + 8 * rr;
          if (row < p.N) {
            store_pair(dgo + row * C + n0 + 2 * t, dg[2 * rr], dg[2 * rr + 1]);
            store_pair(dpo + row * C + n0 + 2 * t, dp[2 * rr], dp[2 * rr + 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sg_ = column_sum(dg[e] + dg[2 + e]);
          const float sp_ = column_sum(dp[e] + dp[2 + e]);
          if (g == nc) {
            vs[2 + 2 * h][e] += sg_;
            vs[3 + 2 * h][e] += sp_;
          }
        }
        // A fragments of dpre in the k order (0, 2, 4, 6, 1, 3, 5, 7): a0 = c0,
        // a1 = c2, a2 = c1, a3 = c3
        uint32_t gb[4], gs[4], pb[4], ps[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = (i >> 1) | ((i & 1) << 1);
          split_tf32(dg[e], gb[i], gs[i]);
          split_tf32(dp[e], pb[i], ps[i]);
        }
#pragma unroll
        for (int np = 0; np < KMAX; ++np) {
          if (np < nk) {  // b0 = W[8np + g][n0 + 2t], b1 = W[8np + g][n0 + 2t + 1]
            const int off = (8 * np + g) * ldw + n0 + 2 * t;
            float w0, w1;
            uint32_t bg[4], bp[4];
            load_pair(wg + off, w0, w1);
            split_tf32(w0, bg[0], bg[2]);
            split_tf32(w1, bg[1], bg[3]);
            load_pair(wp + off, w0, w1);
            split_tf32(w0, bp[0], bp[2]);
            split_tf32(w1, bp[1], bp[3]);
            mma_3xtf32(ds[np], gb, gs, bg);
            mma_3xtf32(ds[np], pb, ps, bp);
          }
        }
      }
    }
    res_ln_backward<8>(ds, xt, ldx, lns, mu, inv, r0, p.N, C, cl, a.out[0], vs[0], vs[1]);
  }
  res_store_partial<8>(sm, vs, C, a.vec_part);
}

// K4 with the four weights resident: K5's forward half (the LayerNorm on the
// fragments, the four pre-activations of a chunk at once), then a =
// sigmoid(pre_ag + bag) (pre_ap + bap) m and b likewise on the C fragments,
// stored as pairs.  No dsrc and no column sums, so about half K5's
// registers: 16 warps a block, each loading its tile's rows into a
// one-stage ring and waiting for them (more warps in flight beat 8 warps
// with a two-stage ring, PERF.md).
template <bool kRagged>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
prologue_fwd_resident_kernel(RowArgs<bf16> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<bf16> sm;
  ResSmem<bf16>::carve((uintptr_t)smem_raw, p.C, res_nw(kProFwd), res_nsrc(kProFwd), &sm);
  constexpr int KMAX = ResMax<bf16>::C / 16;
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<bf16>(C), nk = C / 16, cl = ln_divisor<kRagged>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kFwdWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kFwdWarps;
  bf16* const xt = sm.xs + (size_t)warp * 16 * ldx;

  res_load_weights(sm, a, C, res_nw(kProFwd));
  cp_async_wait_all();
  __syncthreads();

  for (int64_t tile = first; tile < ntiles; tile += stride) {
    __syncwarp();  // the last tile's readers are done with the stage
    res_load_rows(xt, a.x, tile * 16, p.N, C, ldx);
    cp_async_wait_all();
    __syncwarp();
    const int64_t r0 = tile * 16;

    float mu[2], inv[2], mrow[2];
    uint32_t sa[KMAX][4];
    res_ln_frags(xt, ldx, sm.vec, sm.vec + C, C, cl, mu, inv, sa);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + g + 8 * h;
      mrow[h] = row < p.N ? tof(a.aux[row]) : 0.0f;
    }
    for (int nc = 0; nc < nk; ++nc) {
      const int n0 = 16 * nc;
      float pre[4][2][4] = {};
      res_products<4>(sm.w, ldw, C, sa, n0, pre);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a, then b
        const float* bg = sm.vec + (2 + 2 * h) * C + n0;
        const float* bp = sm.vec + (3 + 2 * h) * C + n0;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int64_t row = r0 + g + 8 * rr;
            if (row < p.N) {
              const int c = 8 * j + 2 * t;
              const float v0 = sigmoidf(pre[2 * h][j][2 * rr] + bg[c]) * (pre[2 * h + 1][j][2 * rr] + bp[c]);
              const float v1 = sigmoidf(pre[2 * h][j][2 * rr + 1] + bg[c + 1]) *
                               (pre[2 * h + 1][j][2 * rr + 1] + bp[c + 1]);
              store_pair(a.out[h] + row * C + n0 + c, v0 * mrow[rr], v1 * mrow[rr]);
            }
          }
      }
    }
  }
}

// The float32 K4, on 3xTF32 over 8-column chunks, a's two products and then
// b's (as K5's float32 pass).
template <bool kRagged>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
prologue_fwd_resident_kernel(RowArgs<float> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<float> sm;
  ResSmem<float>::carve((uintptr_t)smem_raw, p.C, res_nw(kProFwd), res_nsrc(kProFwd), &sm);
  constexpr int KMAX = ResMax<float>::C / 8;
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<float>(C), nk = C / 8, cl = ln_divisor<kRagged>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kFwdWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kFwdWarps;
  float* const xt = sm.xs + (size_t)warp * 16 * ldx;

  res_load_weights(sm, a, C, res_nw(kProFwd));
  cp_async_wait_all();
  __syncthreads();

  for (int64_t tile = first; tile < ntiles; tile += stride) {
    __syncwarp();  // the last tile's readers are done with the stage
    res_load_rows(xt, a.x, tile * 16, p.N, C, ldx);
    cp_async_wait_all();
    __syncwarp();
    const int64_t r0 = tile * 16;

    float mu[2], inv[2], mrow[2];
    uint32_t sb[KMAX][4], ss[KMAX][4];
    res_ln_frags(xt, ldx, sm.vec, sm.vec + C, C, cl, mu, inv, sb, ss);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + g + 8 * h;
      mrow[h] = row < p.N ? a.aux[row] : 0.0f;
    }
    for (int nc = 0; nc < nk; ++nc) {
      const int n0 = 8 * nc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pre[2][4] = {};
        res_products<2>(sm.w + (size_t)(2 * h) * C * ldw, ldw, C, sb, ss, n0, pre);
        const float* bg = sm.vec + (2 + 2 * h) * C + n0;
        const float* bp = sm.vec + (3 + 2 * h) * C + n0;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = r0 + g + 8 * rr;
          if (row < p.N) {
            const int c = 2 * t;
            const float v0 = sigmoidf(pre[0][2 * rr] + bg[c]) * (pre[1][2 * rr] + bp[c]);
            const float v1 = sigmoidf(pre[0][2 * rr + 1] + bg[c + 1]) * (pre[1][2 * rr + 1] + bp[c + 1]);
            store_pair(a.out[h] + row * C + n0 + c, v0 * mrow[rr], v1 * mrow[rr]);
          }
        }
      }
    }
  }
}

// K7 rows pass with Wog and Wo resident.  Each warp's ring stage holds the
// tile's rows of x and of p; s = LN1(x) stays in registers as A fragments,
// t = LN2(p)'s are rebuilt from the ring a k step at a time (keeping both
// spilled).  Per chunk of columns: g's and u's pre-activations at once, the
// gate backward on the C fragments (du = dout g, dpre = dout u g (1 - g);
// dout read from global memory straight into the fragments' registers),
// dpre and du cast to T once and stored to the scratch, their column sums
// kept per lane, and dsrc += dpre @ Wog^T as in K5 (dpre's C fragments are
// its A fragment).  One dsrc accumulator at a time: after the chunks LN1's
// backward (dx), then dt = du @ Wo^T, du read back from the scratch
// (res_backward_rows; keeping it in registers spilled), and LN2's backward
// (dp).
template <bool kRagged>
__global__ void __launch_bounds__(kResWarps * 32, 1)
epilogue_bwd_resident_kernel(RowArgs<bf16> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<bf16> sm;
  ResSmem<bf16>::carve((uintptr_t)smem_raw, p.C, res_nw(kEpiBwd), res_nsrc(kEpiBwd), &sm);
  constexpr int KMAX = ResMax<bf16>::C / 16;
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<bf16>(C), nk = C / 16, cl = ln_divisor<kRagged>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kResWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kResWarps;
  bf16* const xs = sm.xs + (size_t)warp * 2 * 2 * 16 * ldx;  // stage s: x at 32 s ldx, p 16 ldx on

  res_load_weights(sm, a, C, res_nw(kEpiBwd));
  if (first < ntiles) res_load_stage(xs, a.x, a.aux, first * 16, p.N, C, ldx);
  cp_async_wait_all();
  __syncthreads();

  const bf16* wog = sm.w;
  const bf16* wo = sm.w + (size_t)C * ldw;
  const float* bog = sm.vec + 2 * C;
  const float* bo = sm.vec + 5 * C;
  bf16* const dpo = a.dpre;
  bf16* const duo = a.dpre + (size_t)p.N * C;
  // column sums this lane keeps: chunk g, columns 8j + 2t + e at slot 2j + e,
  // of dsrc * xhat1, dsrc, dpre, dt * xhat2, dt, du
  float vs[6][4];
#pragma unroll
  for (int v = 0; v < 6; ++v) vs[v][0] = vs[v][1] = vs[v][2] = vs[v][3] = 0.0f;

  int st = 0;
  for (int64_t tile = first; tile < ntiles; tile += stride, st ^= 1) {
    cp_async_wait_all();
    __syncwarp();
    if (tile + stride < ntiles) res_load_stage(xs + (st ^ 1) * 32 * ldx, a.x, a.aux, (tile + stride) * 16, p.N, C, ldx);
    const bf16* xt = xs + st * 32 * ldx;
    const bf16* pt = xt + 16 * ldx;
    const int64_t r0 = tile * 16;

    float mu[2][2], inv[2][2];  // LN1's, LN2's
    uint32_t sa[KMAX][4];       // s, kept; t is rebuilt a step at a time from p's rows
    res_ln_frags(xt, ldx, sm.vec, sm.vec + C, C, cl, mu[0], inv[0], sa);
    res_ln_stats(pt, ldx, C, cl, mu[1], inv[1]);

    float ds[2 * KMAX][4] = {};  // dsrc = dpre @ Wog^T, chunk by chunk
    for (int nc = 0; nc < nk; ++nc) {
      const int n0 = 16 * nc;
      float pre[2][2][4] = {};  // s @ Wog, t @ Wo
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        if (kk < nk) {
          uint32_t ta[4], bg[4], bu[4];
          res_ln_frag(pt, ldx, sm.vec + 3 * C, sm.vec + 4 * C, mu[1], inv[1], kk, ta);
          const int off = (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldw + n0 + (lane >> 4) * 8;
          ldsm_x4_trans(bg, wog + off);
          ldsm_x4_trans(bu, wo + off);
          mma_bf16(pre[0][0], sa[kk], bg[0], bg[1]);
          mma_bf16(pre[0][1], sa[kk], bg[2], bg[3]);
          mma_bf16(pre[1][0], ta, bu[0], bu[1]);
          mma_bf16(pre[1][1], ta, bu[2], bu[3]);
        }
      }
      float dpre[2][4], du[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = r0 + g + 8 * rr;
          float d[2] = {0.0f, 0.0f};  // rows past N: dout 0
          if (row < p.N) load_pair(a.ct[0] + row * C + n0 + 8 * j + 2 * t, d[0], d[1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 8 * j + 2 * t + e;
            const float gg = sigmoidf(pre[0][j][2 * rr + e] + bog[c]);
            const float u = pre[1][j][2 * rr + e] + bo[c];
            du[j][2 * rr + e] = d[e] * gg;
            dpre[j][2 * rr + e] = d[e] * u * gg * (1.0f - gg);
          }
        }
      // dpre and du cast to bf16 once: dpre's the A fragment of its
      // back-projection, both stored to the scratch
      const uint32_t ap[4] = {pack_bf16(dpre[0][0], dpre[0][1]), pack_bf16(dpre[0][2], dpre[0][3]),
                              pack_bf16(dpre[1][0], dpre[1][1]), pack_bf16(dpre[1][2], dpre[1][3])};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = r0 + g + 8 * rr;
          if (row < p.N) {
            const int64_t o = row * C + n0 + 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(dpo + o) = ap[2 * j + rr];
            store_pair(duo + o, du[j][2 * rr], du[j][2 * rr + 1]);
          }
        }
      res_back_project(ds, ap, wog, ldw, C, n0);
      // bias gradients: column sums of the f32 values (rows past N are 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sp = column_sum(dpre[j][e] + dpre[j][2 + e]);
          const float su = column_sum(du[j][e] + du[j][2 + e]);
          if (g == nc) {
            vs[2][2 * j + e] += sp;
            vs[5][2 * j + e] += su;
          }
        }
    }
    res_ln_backward<16>(ds, xt, ldx, sm.vec, mu[0], inv[0], r0, p.N, C, cl, a.out[0], vs[0], vs[1]);
    res_backward_rows(duo, wo, ldw, pt, ldx, sm.vec + 3 * C, mu[1], inv[1], r0, p.N, C, cl, a.out[1], vs[3], vs[4]);
  }
  res_store_partial<16>(sm, vs, C, a.vec_part);
}

// The float32 K7 rows pass, the same walk on 3xTF32 over 8-column chunks;
// s and t as split tf32 A fragments (big, small), t rebuilt a step at a time.
template <bool kRagged>
__global__ void __launch_bounds__(kResWarps * 32, 1)
epilogue_bwd_resident_kernel(RowArgs<float> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<float> sm;
  ResSmem<float>::carve((uintptr_t)smem_raw, p.C, res_nw(kEpiBwd), res_nsrc(kEpiBwd), &sm);
  constexpr int KMAX = ResMax<float>::C / 8;
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<float>(C), nk = C / 8, cl = ln_divisor<kRagged>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kResWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kResWarps;
  float* const xs = sm.xs + (size_t)warp * 2 * 2 * 16 * ldx;

  res_load_weights(sm, a, C, res_nw(kEpiBwd));
  if (first < ntiles) res_load_stage(xs, a.x, a.aux, first * 16, p.N, C, ldx);
  cp_async_wait_all();
  __syncthreads();

  const float* wog = sm.w;
  const float* wo = sm.w + (size_t)C * ldw;
  const float* bog = sm.vec + 2 * C;
  const float* bo = sm.vec + 5 * C;
  float* const dpo = a.dpre;
  float* const duo = a.dpre + (size_t)p.N * C;
  float vs[6][2];  // column sums: chunk g, columns 2t + e at slot e
#pragma unroll
  for (int v = 0; v < 6; ++v) vs[v][0] = vs[v][1] = 0.0f;

  int st = 0;
  for (int64_t tile = first; tile < ntiles; tile += stride, st ^= 1) {
    cp_async_wait_all();
    __syncwarp();
    if (tile + stride < ntiles) res_load_stage(xs + (st ^ 1) * 32 * ldx, a.x, a.aux, (tile + stride) * 16, p.N, C, ldx);
    const float* xt = xs + st * 32 * ldx;
    const float* pt = xt + 16 * ldx;
    const int64_t r0 = tile * 16;

    float mu[2][2], inv[2][2];
    uint32_t sb[KMAX][4], ss[KMAX][4];  // s, kept; t rebuilt a step at a time
    res_ln_frags(xt, ldx, sm.vec, sm.vec + C, C, cl, mu[0], inv[0], sb, ss);
    res_ln_stats(pt, ldx, C, cl, mu[1], inv[1]);

    float ds[KMAX][4] = {};  // dsrc = dpre @ Wog^T, chunk by chunk
    for (int nc = 0; nc < nk; ++nc) {
      const int n0 = 8 * nc;
      float pre[2][4] = {};  // s @ Wog, t @ Wo
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < nk) {  // b0 = W[8k + t][n0 + g], b1 = W[8k + t + 4][n0 + g]
          uint32_t tb[4], ts[4], bg[4], bu[4];
          res_ln_frag(pt, ldx, sm.vec + 3 * C, sm.vec + 4 * C, mu[1], inv[1], k, tb, ts);
          const int off = (8 * k + t) * ldw + n0 + g;
          split_tf32(wog[off], bg[0], bg[2]);
          split_tf32(wog[off + 4 * ldw], bg[1], bg[3]);
          split_tf32(wo[off], bu[0], bu[2]);
          split_tf32(wo[off + 4 * ldw], bu[1], bu[3]);
          mma_3xtf32(pre[0], sb[k], ss[k], bg);
          mma_3xtf32(pre[1], tb, ts, bu);
        }
      }
      float dpre[4], du[4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int64_t row = r0 + g + 8 * rr;
        float d[2] = {0.0f, 0.0f};
        if (row < p.N) load_pair(a.ct[0] + row * C + n0 + 2 * t, d[0], d[1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * rr + e, c = n0 + 2 * t + e;
          const float gg = sigmoidf(pre[0][i] + bog[c]);
          const float u = pre[1][i] + bo[c];
          du[i] = d[e] * gg;
          dpre[i] = d[e] * u * gg * (1.0f - gg);
        }
        if (row < p.N) {
          store_pair(dpo + row * C + n0 + 2 * t, dpre[2 * rr], dpre[2 * rr + 1]);
          store_pair(duo + row * C + n0 + 2 * t, du[2 * rr], du[2 * rr + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sp = column_sum(dpre[e] + dpre[2 + e]);
        const float su = column_sum(du[e] + du[2 + e]);
        if (g == nc) {
          vs[2][e] += sp;
          vs[5][e] += su;
        }
      }
      res_back_project(ds, dpre, wog, ldw, C, n0);
    }
    res_ln_backward<8>(ds, xt, ldx, sm.vec, mu[0], inv[0], r0, p.N, C, cl, a.out[0], vs[0], vs[1]);
    res_backward_rows(duo, wo, ldw, pt, ldx, sm.vec + 3 * C, mu[1], inv[1], r0, p.N, C, cl, a.out[1], vs[3], vs[4]);
  }
  res_store_partial<8>(sm, vs, C, a.vec_part);
}

// The float32 LayerNorm output of rows g, g + 8 of a tile in a ring stage,
// in A-fragment order and not yet split: v[k][i] is row g + 8 (i & 1),
// column 8k + t + 4 (i >> 1).
template <int KMAX>
__device__ __forceinline__ void res_ln_vals(const float* xt, int ldx, const float* lns,
                                            const float* lnb, int C, int cl, float (&v)[KMAX][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float mu[2], inv[2];
  res_ln_stats(xt, ldx, C, cl, mu, inv);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < C / 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, c = 8 * k + t + 4 * (i >> 1);
        v[k][i] = (xt[(g + 8 * h) * ldx + c] - mu[h]) * inv[h] * lns[c] + lnb[c];
      }
    }
  }
}

// K6's operands of one tile in registers: s = LN1(x) and t = LN2(p), read
// from the warp's ring stage (p's rows 16 ldx after x's), and the products
// of a 16-column chunk, pre[0] = s @ Wog[:, n0:n0 + 16] and pre[1] = t @
// Wo[:, n0:n0 + 16] (n8 tiles j = 0, 1), with Wo C ldw after Wog.
template <typename T> struct EpiFwdFrags;

// bf16: both as the packed A fragments of every k16 step (2 x 32 registers);
// W read with ldmatrix.trans.
template <> struct EpiFwdFrags<bf16> {
  static constexpr int KMAX = ResMax<bf16>::C / 16;
  uint32_t sa[KMAX][4], ta[KMAX][4];

  __device__ __forceinline__ void build(const bf16* xt, int ldx, const float* vec, int C, int cl) {
    float mu[2], inv[2];
    res_ln_frags(xt, ldx, vec, vec + C, C, cl, mu, inv, sa);
    res_ln_frags(xt + 16 * ldx, ldx, vec + 3 * C, vec + 4 * C, C, cl, mu, inv, ta);
  }

  __device__ __forceinline__ void products(const bf16* w, int ldw, int C, int n0,
                                           float (&pre)[2][2][4]) const {
    const int lane = threadIdx.x & 31;
    const bf16* wo = w + (size_t)C * ldw;
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      if (kk < C / 16) {
        const int off = (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldw + n0 + (lane >> 4) * 8;
        uint32_t bg[4], bu[4];
        ldsm_x4_trans(bg, w + off);
        ldsm_x4_trans(bu, wo + off);
        mma_bf16(pre[0][0], sa[kk], bg[0], bg[1]);
        mma_bf16(pre[0][1], sa[kk], bg[2], bg[3]);
        mma_bf16(pre[1][0], ta[kk], bu[0], bu[1]);
        mma_bf16(pre[1][1], ta[kk], bu[2], bu[3]);
      }
    }
  }
};

// float32: both as f32 values (2 x 32 registers; split to tf32 (big, small)
// at each k8 step, which costs fewer registers than keeping both splits);
// 3xTF32, W's B fragments read by hand: b0 = W[8k + t][n], b1 = W[8k + t +
// 4][n], n = n0 + 8j + g.
template <> struct EpiFwdFrags<float> {
  static constexpr int KMAX = ResMax<float>::C / 8;
  float sa[KMAX][4], ta[KMAX][4];

  __device__ __forceinline__ void build(const float* xt, int ldx, const float* vec, int C, int cl) {
    res_ln_vals(xt, ldx, vec, vec + C, C, cl, sa);
    res_ln_vals(xt + 16 * ldx, ldx, vec + 3 * C, vec + 4 * C, C, cl, ta);
  }

  __device__ __forceinline__ void products(const float* w, int ldw, int C, int n0,
                                           float (&pre)[2][2][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* wo = w + (size_t)C * ldw;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < C / 8) {
        uint32_t sb[4], ss[4], tb[4], ts[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(sa[k][i], sb[i], ss[i]);
          split_tf32(ta[k][i], tb[i], ts[i]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int off = (8 * k + t) * ldw + n0 + 8 * j + g;
          uint32_t bg[4], bu[4];
          split_tf32(w[off], bg[0], bg[2]);
          split_tf32(w[off + 4 * ldw], bg[1], bg[3]);
          split_tf32(wo[off], bu[0], bu[2]);
          split_tf32(wo[off + 4 * ldw], bu[1], bu[3]);
          mma_3xtf32(pre[0][j], sb, ss, bg);
          mma_3xtf32(pre[1][j], tb, ts, bu);
        }
      }
    }
  }
};

// K6 with Wog and Wo resident, K7's forward half: 16 warps a block, each
// walking its 16-row tiles through a one-stage ring of the tile's rows of x
// and p.  s and t go to registers first, which frees the stage, so the next
// tile's rows are in flight while this tile's products, gates and stores
// run.  Per 16-column chunk: g's and u's pre-activations (four independent
// accumulators), out = sigmoid(pre_g + bog) (pre_u + bo) on the C fragments
// (rows g, g + 8, columns n0 + 8j + 2t, + 1), stored as pairs below N.
template <typename T, bool kRagged>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
epilogue_fwd_resident_kernel(RowArgs<T> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<T> sm;
  ResSmem<T>::carve((uintptr_t)smem_raw, p.C, res_nw(kEpiFwd), res_nsrc(kEpiFwd), &sm);
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<T>(C), cl = ln_divisor<kRagged>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kFwdWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kFwdWarps;
  T* const xt = sm.xs + (size_t)warp * 2 * 16 * ldx;  // x's rows, then p's 16 ldx on

  res_load_weights(sm, a, C, res_nw(kEpiFwd));
  if (first < ntiles) res_load_stage(xt, a.x, a.aux, first * 16, p.N, C, ldx);
  cp_async_wait_all();
  __syncthreads();

  const float* bog = sm.vec + 2 * C;
  const float* bo = sm.vec + 5 * C;
  for (int64_t tile = first; tile < ntiles; tile += stride) {
    cp_async_wait_all();
    __syncwarp();  // this tile's rows landed
    EpiFwdFrags<T> f;
    f.build(xt, ldx, sm.vec, C, cl);
    __syncwarp();  // every lane has read the stage: the next tile's rows may land in it
    if (tile + stride < ntiles) res_load_stage(xt, a.x, a.aux, (tile + stride) * 16, p.N, C, ldx);
    const int64_t r0 = tile * 16;
    for (int n0 = 0; n0 < C; n0 += 16) {
      float pre[2][2][4] = {};
      f.products(sm.w, ldw, C, n0, pre);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = r0 + g + 8 * rr;
          if (row < p.N) {
            const int c = n0 + 8 * j + 2 * t;
            const float v0 = sigmoidf(pre[0][j][2 * rr] + bog[c]) * (pre[1][j][2 * rr] + bo[c]);
            const float v1 = sigmoidf(pre[0][j][2 * rr + 1] + bog[c + 1]) * (pre[1][j][2 * rr + 1] + bo[c + 1]);
            store_pair(a.out[0] + row * C + c, v0, v1);
          }
        }
    }
  }
}

// The wide route's float32 products (here and in the GEMM core below):
// operands split by split_tf32_alu, each k8 step's 3xTF32 products summed
// apart (wide_3xtf32).
// x = big + small: big is x rounded to tf32 (to nearest, ties away, as
// cvt.rna) by integer arithmetic on the float's bits, small = x - big exact
// in f32 and handed over as it is: the tensor cores read a tf32 operand's
// top 19 bits, so small is truncated there, within 2^-21 |x| of x - big.
// Three ALU operations at their full rate, where split_tf32 takes two cvt.
__device__ __forceinline__ void split_tf32_alu(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a b at float32 accuracy: the three TF32 products of one k8 step
// summed apart, then added in f32.
__device__ __forceinline__ void wide_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                            const uint32_t (&a_small)[4], const uint32_t (&b)[4]) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_3xtf32(d, a_big, a_small, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// Weight gradients, split over row chunks: block (chunk, job, tile) sums
// s^T @ d over its chunk's rows for one TM x TM tile of dW_job (TM = C up to
// 128), with s = LN(src) cast to T recomputed as the rows kernels computed
// it, once per row (the resident route, where the tile is all of C x C), or
// read from the wide route's s plane, 64 rows a step (fewer where the ring
// does not fit; the wide float32 pass 32, so that two blocks share an SM);
// the step's rows of src (or of s) and d come through a two-stage cp.async
// ring.  Products on mma.sync: bf16 m16n8k16 (ldmatrix.trans for both
// operands), float32 3xTF32 m16n8k8 with each step's product (the wide
// route: each k8 step's) summed apart and added in f32 (the tensor cores
// truncate as they accumulate).  Warp
// (wm, wn) of the 4 x 2 grid owns m16 tiles wm + 4i and n16 tiles wn + 2j of
// the output tile.
template <typename T>
struct WgradArgs {
  const T* src[4];
  const T* sc[4];
  const T* bi[4];
  const T* d[4];
  float* part;  // (chunks, njobs, C, C)
};

constexpr int kWgMi = 2, kWgNj = 4;  // m16 and n16 tiles a warp, at most

// Shared memory of the weight-gradient kernel, for steps of R = wg_rows
// rows: the LayerNorm'd rows s (R x lds), and two ring stages each of the
// step's rows of the source (R x lds, full C) and of the matching R x TM
// slice of d.  On the wide route (from_s) the source is s itself: the ring
// holds its R x TM slice (stride TM + kPadT) and nothing is recomputed.
template <typename T>
struct WgradSmem {
  T* s;
  T* x;  // (2, R, lds), or (2, R, TM + kPadT) from s
  T* d;  // (2, R, TM + kPadT)

  __host__ __device__ static size_t carve(uintptr_t base, const Plan& p, bool from_s,
                                          WgradSmem* out) {
    Carver cv{base, 0};
    WgradSmem r{};
    const int ldx = from_s ? p.wg_tile + kPadT : p.lds;
    if (!from_s) r.s = (T*)cv.take(sizeof(T) * p.wg_rows * p.lds);
    r.x = (T*)cv.take(sizeof(T) * 2 * p.wg_rows * ldx);
    r.d = (T*)cv.take(sizeof(T) * 2 * p.wg_rows * (p.wg_tile + kPadT));
    if (out) *out = r;
    return cv.off;
  }
};

// acc (this warp's tiles) += s[:, m0:]^T @ d over R rows
template <bool kApart>
__device__ __forceinline__ void wgrad_products(float (&acc)[kWgMi][2 * kWgNj][4], const bf16* s,
                                               int lds, const bf16* d, int ldd, int m0, int mt,
                                               int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp & 3, wn = warp >> 2;
#pragma unroll 4
  for (int kk = 0; kk < R / 16; ++kk) {
    uint32_t af[kWgMi][4];
#pragma unroll
    for (int i = 0; i < kWgMi; ++i) {
      const int mi = wm + 4 * i;
      if (mi < mt)
        ldsm_x4_trans(af[i], s + (16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8) * lds + m0 +
                                 16 * mi + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int j = 0; j < kWgNj; ++j) {
      const int nj = wn + 2 * j;
      if (nj < mt) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, d + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldd + 16 * nj +
                              (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kWgMi; ++i) {
          if (wm + 4 * i < mt) {
            mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
            mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
  }
}

// The same in float32, 3xTF32.  The resident route's pass sums each R-row
// step's products apart; the wide route's (kApart) each k8 step's, through
// wide_3xtf32, which leaves no second set of accumulators: its registers
// fit two blocks an SM.
template <bool kApart>
__device__ __forceinline__ void wgrad_products(float (&acc)[kWgMi][2 * kWgNj][4], const float* s,
                                               int lds, const float* d, int ldd, int m0, int mt,
                                               int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kApart) {
#pragma unroll 2
    for (int k0 = 0; k0 < R; k0 += 8) {
      uint32_t ab[kWgMi][4], as[kWgMi][4];
#pragma unroll
      for (int i = 0; i < kWgMi; ++i) {
        const int mi = wm + 4 * i;
        if (mi < mt) {  // A = s^T: rows m, columns k
          const float* q = s + (k0 + t) * lds + m0 + 16 * mi + g;
          split_tf32_alu(q[0], ab[i][0], as[i][0]);
          split_tf32_alu(q[8], ab[i][1], as[i][1]);
          split_tf32_alu(q[4 * lds], ab[i][2], as[i][2]);
          split_tf32_alu(q[4 * lds + 8], ab[i][3], as[i][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * kWgNj; ++j) {
        const int nj = wn + 2 * (j >> 1);
        if (nj < mt) {
          const float* q = d + (k0 + t) * ldd + 16 * nj + 8 * (j & 1) + g;
          uint32_t bf[4];
          split_tf32_alu(q[0], bf[0], bf[2]);
          split_tf32_alu(q[4 * ldd], bf[1], bf[3]);
#pragma unroll
          for (int i = 0; i < kWgMi; ++i)
            if (wm + 4 * i < mt) wide_3xtf32(acc[i][j], ab[i], as[i], bf);
        }
      }
    }
    return;
  }
  float step[kWgMi][2 * kWgNj][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < R; k0 += 8) {
    uint32_t ab[kWgMi][4], as[kWgMi][4];
#pragma unroll
    for (int i = 0; i < kWgMi; ++i) {
      const int mi = wm + 4 * i;
      if (mi < mt) {  // A = s^T: rows m, columns k
        const float* q = s + (k0 + t) * lds + m0 + 16 * mi + g;
        split_tf32(q[0], ab[i][0], as[i][0]);
        split_tf32(q[8], ab[i][1], as[i][1]);
        split_tf32(q[4 * lds], ab[i][2], as[i][2]);
        split_tf32(q[4 * lds + 8], ab[i][3], as[i][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * kWgNj; ++j) {
      const int nj = wn + 2 * (j >> 1);
      if (nj < mt) {
        const float* q = d + (k0 + t) * ldd + 16 * nj + 8 * (j & 1) + g;
        uint32_t bf[4];
        split_tf32(q[0], bf[0], bf[2]);
        split_tf32(q[4 * ldd], bf[1], bf[3]);
#pragma unroll
        for (int i = 0; i < kWgMi; ++i)
          if (wm + 4 * i < mt) mma_3xtf32(step[i][j], ab[i], as[i], bf);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kWgMi; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kWgNj; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += step[i][j][e];
}

// LayerNorm of R rows of x already in shared memory (stride ld) into dst
// (stride ld): f32 statistics, fast variance, the output cast to T.  Eight
// lanes a row, four rows a warp at a time, each lane on the 16-byte pieces
// oct, oct + 8, ... of its row (one row's 128 contiguous bytes a phase).
template <typename T>
__device__ void ln_smem_rows(const T* x, int R, int C, const T* __restrict__ sc,
                             const T* __restrict__ bi, T* dst, int ld) {
  constexpr int E = 16 / (int)sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, oct = lane & 7;
  for (int r = warp * 4 + (lane >> 3); r < R; r += kWarps * 4) {
    const T* xr = x + (size_t)r * ld;
    float sum = 0.0f, sq = 0.0f;
    for (int c = E * oct; c < C; c += 8 * E) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        sum += tof(v[i]);
        sq += tof(v[i]) * tof(v[i]);
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / C;
    const float inv = rsqrtf(sq / C - mu * mu + kEps);
    for (int c = E * oct; c < C; c += 8 * E) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < E; ++i) o[i] = fromf<T>((tof(v[i]) - mu) * inv * tof(sc[c + i]) + tof(bi[c + i]));
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) = out;
    }
  }
}

template <typename T, bool kFromS, bool kRagged = false>
__device__ __forceinline__ void wgrad_body(const WgradArgs<T>& a, const Plan& p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WgradSmem<T> sm;
  WgradSmem<T>::carve((uintptr_t)smem_raw, p, kFromS, &sm);
  const int C = p.C, R = p.wg_rows, TM = p.wg_tile, per = C / TM, mt = TM / 16;
  const int ldd = TM + kPadT, lds = kFromS ? ldd : p.lds;
  const int tile = blockIdx.x % p.tiles, job = (blockIdx.x / p.tiles) % p.njobs;
  const int chunk = blockIdx.x / (p.tiles * p.njobs);
  const int m0 = (tile / per) * TM, n0 = (tile % per) * TM;
  const int64_t rbeg = (int64_t)chunk * p.chunk_rows;
  const int64_t rend = min((int64_t)p.N, rbeg + p.chunk_rows);
  const T* x = a.src[job];
  const T* d = a.d[job];
  constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte piece
  // the source's columns a step: all of them (s recomputed), or s's [m0, m0 + TM)
  const int xpieces = (kFromS ? TM : C) / E, dpieces = TM / E, xc0 = kFromS ? m0 : 0;
  // rows [r0, r0 + R) of x and of d's columns [n0, n0 + TM) into ring stage
  // st, one group; rows past rend are zeros (their s is finite, their d 0)
  auto load = [&](int64_t r0, int st) {
    T* xd = sm.x + st * R * lds;
    T* dd = sm.d + st * R * ldd;
    for (int e = threadIdx.x; e < R * xpieces; e += kThreads) {
      const int r = e / xpieces, c = (e % xpieces) * E;
      if (r0 + r < rend) cp_async16(xd + r * lds + c, x + (r0 + r) * C + xc0 + c);
      else *reinterpret_cast<uint4*>(xd + r * lds + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e = threadIdx.x; e < R * dpieces; e += kThreads) {
      const int r = e / dpieces, c = (e % dpieces) * E;
      if (r0 + r < rend) cp_async16(dd + r * ldd + c, d + (r0 + r) * C + n0 + c);
      else *reinterpret_cast<uint4*>(dd + r * ldd + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };
  float acc[kWgMi][2 * kWgNj][4] = {};
  if (rbeg < rend) load(rbeg, 0);
  int st = 0;
  for (int64_t r0 = rbeg; r0 < rend; r0 += R, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // stage st landed; the readers of s and of the other stage are done
    if (r0 + R < rend) load(r0 + R, st ^ 1);
    if constexpr (kFromS) {
      wgrad_products<true>(acc, sm.x + st * R * lds, lds, sm.d + st * R * ldd, ldd, 0, mt, R);
    } else {
      // a ragged width's LayerNorm runs over its logical width cl (the rows
      // are zero past it); the columns of s past cl's last 16-byte piece stay
      // unwritten and reach only the rows of dW past cl, which are cut off
      ln_smem_rows<T>(sm.x + st * R * lds, R, ln_divisor<kRagged>(p), a.sc[job], a.bi[job], sm.s, lds);
      __syncthreads();
      wgrad_products<false>(acc, sm.s, lds, sm.d + st * R * ldd, ldd, m0, mt, R);
    }
  }
  // C fragments: rows m0 + 16 mi + g (+8), columns n0 + 16 nj + 8 (j & 1) + 2t (+1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  float* out = a.part + ((size_t)chunk * p.njobs + job) * C * C;
#pragma unroll
  for (int i = 0; i < kWgMi; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kWgNj; ++j) {
      const int mi = wm + 4 * i, nj = wn + 2 * (j >> 1);
      if (mi < mt && nj < mt) {
        const int m = m0 + 16 * mi + g, n = n0 + 16 * nj + 8 * (j & 1) + 2 * t;
        store_pair(out + (size_t)m * C + n, acc[i][j][0], acc[i][j][1]);
        store_pair(out + (size_t)(m + 8) * C + n, acc[i][j][2], acc[i][j][3]);
      }
    }
}

template <typename T, bool kFromS>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradArgs<T> a, Plan p) {
  wgrad_body<T, kFromS>(a, p);
}

// The resident route's pass at a ragged width (its LayerNorm divides by cl).
template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_ragged_kernel(WgradArgs<T> a, Plan p) {
  wgrad_body<T, false, true>(a, p);
}

// The wide route's float32 pass at two blocks an SM: 128 registers (with
// launch bounds of one block, 206), its ring halved by make_plan to fit.
template <>
__global__ void __launch_bounds__(kThreads, 2) wgrad_kernel<float, true>(WgradArgs<float> a, Plan p) {
  wgrad_body<float, true>(a, p);
}

// out[i] = sum over g < G (in order) of part[g * M + i], cast to T.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ part, int G, int64_t M, T* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s += part[(size_t)g * M + i];
    out[i] = fromf<T>(s);
  }
}

// ---------------------------------------------------------------------------
// the wide route of K4-K7 (bf16 C > 128, float32 C > 64)
// ---------------------------------------------------------------------------
//
// Replaces, at the widths whose weights do not fit in shared memory, the
// TPU kernels K4 _prologue_fwd_kernel (protstruc_tpu/ops/tri_mul.py:107), K5
// _prologue_bwd_kernel (l.121), K6 _epilogue_fwd_kernel (l.267) and K7
// _epilogue_bwd_kernel (l.279).  At C = 1024 a block cannot own whole rows
// through the products (64 rows of f32 dsrc are 256 KB), and a rows pass
// that does restages every weight for every row tile (K5: about 16 MB of
// weights through L2 a 16-row tile, 131 GB a call at N = 2*256*256; K4: 8
// MB a 64-row tile, 17 GB a call).  So each kernel is a chain of kernels on
// the caller's stream, its scratch in the wrapper's f32 workspace (no
// kernel allocates).  The forwards (K4, K6) run steps 1 and 2:
//   1. s = LN(x) (K6 also t = LN2(p)) into the planes in T;
//   2. wide_gate_kernel<T, NA, true>: both products of each 128-row x
//      64-column output tile at once (K4: s @ Wag and s @ Wap into a, then
//      Wbg and Wbp into b; K6: s @ Wog and t @ Wo into out), and the gates
//      in the epilogue: sigmoid(G + bg) * (P + bp) (* m in K4) in f32, cast
//      once.
// They bind on the tensor cores: K4's four (N, C) x (C, C) products are 1.1
// TFLOP, 1.1117 ms at 989 TFLOP/s bf16 (6.67 ms as 3xTF32 at 495 TFLOP/s),
// K6's two 0.55 TFLOP, 0.5559 ms (N = 2*256*256, C = 1024); the bf16 rows
// and outputs are 0.8 GB (0.24 ms at 3.35 TB/s).  The weights are staged
// once per 128-row tile (8.6 GB through L2 for K4 at that shape), through
// the core's cp.async ring, which overlaps the copies with the products.
// The backwards (K5, K7) run:
//   1. wide_ln_kernel: s = LN(x) (K7 also t = LN2(p)) in T into an (N, C)
//      plane, each row's mean and 1/sigma kept (f32, fast variance);
//   2. wide_gate_kernel<T, NA, false>: the pre-activations of each 128-row x
//      64-column output tile as in the forward, then the gate backward in
//      the epilogue: dpre (and du) in T into the dpre planes, and the tile's
//      f32 column sums of the two gradients;
//   3. wide_back_kernel: dsrc (N, C, f32) = sum_k dpre_k @ W_k^T, one product
//      of depth 4C (K5), or C for each of K7's two (run one after the other
//      into the same plane);
//   4. wide_ln_bwd_kernel: dx from dsrc, and the 128-row tile's column sums
//      of dsrc * xhat and dsrc;
//   5. wgrad_kernel<T, true>: dW = s^T @ dpre with s read from step 1's
//      plane, not recomputed;
//   6. reduce_kernel: the 128-row tiles' column sums in tile order, the
//      weight-gradient chunks in chunk order (no atomics: the same bits on
//      every run).
// Steps 2, 3 and 5 are products of 8 N C^2 operations each (K5), bound by
// the tensor cores (3.34 ms for K5's twelve (N, C) x (C, C) products at N =
// 2*256*256, C = 1024 on an H100 at 989 TFLOP/s bf16; float32 as 3xTF32 is
// three TF32 products each, 20.0 ms at 495 TFLOP/s).  Steps 2 and 3 share
// one GEMM core (wide_mainloop): 128-row block tiles of 8 warps (2 x 4,
// each 64 rows x 32 columns), a ring of 3-4 stages of A and B tiles 64
// bytes deep (bf16 32, float32 16 values) copied by 16-byte cp.async (rows
// past N and columns past C zero-filled, never read), padded shared memory
// read without bank conflicts, two blocks an SM on a persistent grid, and
// the next tile's first stages issued before the current tile's epilogue.
// A stage takes the same bytes in both types, so the rings and their shared
// memory are the same.  bf16 runs mma.sync m16n8k16 with f32 accumulators;
// float32 runs m16n8k8 in 3xTF32 (x = big + small, three TF32 products,
// small terms first), each k8 step's three products summed apart and added
// in f32 (the tensor cores truncate as they accumulate: over K5's 4096-deep
// back-projection at C = 1024 that would drift past the f32 budget).  The
// weights are staged once per 128-row tile (not per 16), so a product moves
// about 17 GB through L2 at that shape instead of K5's 131 GB.  The core
// takes B row-major (k, n) for the gate products (bf16: ldmatrix.trans;
// float32 by hand, 32-bit loads on a stride of 72 floats) or as rows of W,
// (n, k), for the back-projections (ldmatrix; on 32-bit words it gives the
// tf32 fragments); the epilogue is the caller's.  float32 (ptxas, PERF.md):
// the gate and back-projection kernels 128 registers, 12 B spilled; the
// weight-gradient pass 127, none.
// Rounding points are the plain versions': the LayerNorm statistics in f32
// (fast variance), s and t cast to T, f32 accumulation with the bias added
// in f32, the gates and the mask applied in f32 and the output cast once;
// dpre and du cast to T before the back-projection and the weight
// gradients, dsrc in f32, column sums in f32, every gradient cast once at
// the end.  Only the order of the sums differs (and, in float32, the
// products' 3xTF32 split).

constexpr int kWideBM = 128;               // rows of a GEMM tile and of a column-sum tile
constexpr int kWideGateN = 64;             // columns of each of a gate tile's two products
constexpr int kWideLdn = kWideGateN + 8;   // row stride of the gate's (k, n) weight tiles, in elements
constexpr int kWideBackN = 128;            // columns of a back-projection tile
constexpr int kWideThreads = 256;
constexpr int kWideLnRows = 8;             // rows a block of wide_ln_kernel at a time (one a warp)
// ring stages of the gate core: K4, K5 (one row operand) 4, K6, K7 (two) 3, so two blocks fit an SM
__host__ __device__ constexpr int wide_gate_stages(int na) { return na == 1 ? 4 : 3; }
constexpr int kWideBackStages = 4;

// One ring stage of the core in T: NA row tiles A (BM x BK, k contiguous;
// the gate's second product may read its own) and its B tiles: the gate's
// two (BK x 64 each, n contiguous) or the back-projection's one (128 rows
// of W x BK, k contiguous).  BK is 64 bytes of a row (bf16 32, float32 16),
// the k-contiguous stride 80 bytes, so both types take the same bytes.
template <typename T, bool kNK, int NA>
struct WideStage {
  static constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte piece
  static constexpr int BK = 4 * E;               // depth of a stage
  static constexpr int LDK = BK + E;             // row stride of k-contiguous tiles
  static constexpr int NH = kNK ? 1 : 2;         // products an output tile holds
  static constexpr int A_ELEMS = kWideBM * LDK;
  static constexpr int B_ELEMS = kNK ? kWideBackN * LDK : BK * kWideLdn;
  static constexpr int ELEMS = NA * A_ELEMS + NH * B_ELEMS;
};

// The accumulators of a warp: NH products of 4 m16 x (4 / NH) n8 fragments.
// Fragment (h, i, j): rows 64 wm + 16 i + g (+ 8), columns (gate) 16 wn +
// 8 j + 2t (+1) of product h, or (back-projection) 32 wn + 8 j + 2t (+1).
template <bool kNK>
struct WideAcc {
  static constexpr int NH = kNK ? 1 : 2;
  float c[NH][4][4 / NH][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4 / NH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[h][i][j][e] = 0.0f;
  }
};

// The products of one landed bf16 stage (two k16 steps) into the warp's
// accumulators.
template <bool kNK, int NA>
__device__ __forceinline__ void wide_stage_mma(const bf16* stage, WideAcc<kNK>& acc) {
  using S = WideStage<bf16, kNK, NA>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const bf16* B0 = stage + NA * S::A_ELEMS;
#pragma unroll
  for (int kk = 0; kk < S::BK / 16; ++kk) {
    uint32_t b[2][4];
    if constexpr (kNK) {
      // rows n of W (this warp's 32 columns, 16 at a time), k contiguous
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldsm_x4(b[q], B0 + (32 * wn + 16 * q + (lane >> 4) * 8 + (lane & 7)) * S::LDK + 16 * kk +
                          ((lane >> 3) & 1) * 8);
    } else {
      // rows k of each product's weight tile, n contiguous: this warp's 16 columns
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4_trans(b[h], B0 + h * S::B_ELEMS +
                                (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * kWideLdn + 16 * wn +
                                (lane >> 4) * 8);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int aoff = (64 * wm + 16 * i + (lane & 15)) * S::LDK + 16 * kk + (lane >> 4) * 8;
      uint32_t a[4];
      ldsm_x4(a, stage + aoff);
      if constexpr (kNK) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma_bf16(acc.c[0][i][2 * q], a, b[q][0], b[q][1]);
          mma_bf16(acc.c[0][i][2 * q + 1], a, b[q][2], b[q][3]);
        }
      } else {
        mma_bf16(acc.c[0][i][0], a, b[0][0], b[0][1]);
        mma_bf16(acc.c[0][i][1], a, b[0][2], b[0][3]);
        if constexpr (NA == 2) ldsm_x4(a, stage + S::A_ELEMS + aoff);
        mma_bf16(acc.c[1][i][0], a, b[1][0], b[1][1]);
        mma_bf16(acc.c[1][i][1], a, b[1][2], b[1][3]);
      }
    }
  }
}

// The tf32 A fragment (big, small) of a 16 x 8 float32 tile by one ldmatrix
// of 32-bit words: matrix q holds rows 8 (q & 1).., columns 4 (q >> 1).., and
// lane (g, t) receives row g, column t of each, the m16n8k8 A layout (a0
// (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)).  p is this lane's
// row address: row (lane & 15), column 4 (lane >> 4).
__device__ __forceinline__ void wide_tf32_a(const float* p, uint32_t (&big)[4], uint32_t (&small)[4]) {
  uint32_t r[4];
  ldsm_x4(r, p);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_alu(__uint_as_float(r[e]), big[e], small[e]);
}

// The same for a landed float32 stage: two k8 steps, 3xTF32.  B fragments
// (big b0, b1, small b0, b1) of n8 tile j: the back-projection's by
// ldmatrix of W's rows (b0 = W[n0 + g][k0 + t], b1 = W[n0 + g][k0 + t + 4]),
// the gate's by hand (b0 = W[k0 + t][n0 + g], b1 = W[k0 + t + 4][n0 + g];
// t kWideLdn + g covers the 32 banks).
template <bool kNK, int NA>
__device__ __forceinline__ void wide_stage_mma(const float* stage, WideAcc<kNK>& acc) {
  using S = WideStage<float, kNK, NA>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float* B0 = stage + NA * S::A_ELEMS;
  // one k8 step at a time: the B fragments of one step live, at 128
  // registers (unrolled, the back-projection spilled 216 B)
#pragma unroll 1
  for (int kk = 0; kk < S::BK / 8; ++kk) {
    uint32_t b[4][4];  // n8 tiles: back-projection j; gate 2 h + j
    if constexpr (kNK) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t r[4];
        ldsm_x4(r, B0 + (32 * wn + 16 * q + (lane >> 4) * 8 + (lane & 7)) * S::LDK + 8 * kk +
                       ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32_alu(__uint_as_float(r[e]), b[2 * q + (e >> 1)][e & 1],
                         b[2 * q + (e >> 1)][2 + (e & 1)]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* w = B0 + h * S::B_ELEMS + (8 * kk + t) * kWideLdn + 16 * wn + 8 * j + g;
          split_tf32_alu(w[0], b[2 * h + j][0], b[2 * h + j][2]);
          split_tf32_alu(w[4 * kWideLdn], b[2 * h + j][1], b[2 * h + j][3]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int aoff = (64 * wm + 16 * i + (lane & 15)) * S::LDK + 8 * kk + (lane >> 4) * 4;
      uint32_t ab[4], as[4];
      wide_tf32_a(stage + aoff, ab, as);
      if constexpr (kNK) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wide_3xtf32(acc.c[0][i][j], ab, as, b[j]);
      } else {
        wide_3xtf32(acc.c[0][i][0], ab, as, b[0]);
        wide_3xtf32(acc.c[0][i][1], ab, as, b[1]);
        if constexpr (NA == 2) wide_tf32_a(stage + S::A_ELEMS + aoff, ab, as);
        wide_3xtf32(acc.c[1][i][0], ab, as, b[2]);
        wide_3xtf32(acc.c[1][i][1], ab, as, b[3]);
      }
    }
  }
}

// The GEMM core: a persistent walk over ntiles output tiles, each nk
// k-steps deep, through a ring of STAGES stages (one cp.async group a
// step).  load(stage, tile, ks) issues the copies of k-step ks of `tile`
// into `stage` (no commit); epilogue(tile, acc) consumes a tile's
// accumulators.  The next tile's first STAGES - 1 stages are in flight
// while the epilogue runs.
template <bool kNK, int NA, int STAGES, typename T, typename Load, typename Epilogue>
__device__ __forceinline__ void wide_mainloop(T* ring, int64_t ntiles, int nk, Load&& load,
                                              Epilogue&& epilogue) {
  using S = WideStage<T, kNK, NA>;
  auto prologue = [&](int64_t tile) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(ring + s * S::ELEMS, tile, s);
      cp_async_commit();
    }
  };
  int64_t tile = blockIdx.x;
  if (tile < ntiles) prologue(tile);
  WideAcc<kNK> acc;
  for (; tile < ntiles; tile += gridDim.x) {
    acc.zero();
    for (int ks = 0; ks < nk; ++ks) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // k-step ks landed everywhere; step ks - 1's readers are done
      const int pf = ks + STAGES - 1;
      if (pf < nk) load(ring + (pf % STAGES) * S::ELEMS, tile, pf);
      cp_async_commit();
      wide_stage_mma<kNK, NA>(ring + (ks % STAGES) * S::ELEMS, acc);
    }
    __syncthreads();  // every stage read: the next tile may refill them
    if (tile + gridDim.x < ntiles) prologue(tile + gridDim.x);
    epilogue(tile, acc);
  }
  cp_async_wait_all();
}

// 16-byte piece e of a tile of `pieces` pieces a row: row r0 + e / pieces of
// a row-major source of stride ld, from column c0, into dst (stride ldd);
// pieces of rows at or past rend or of columns at or past cend (a multiple
// of the piece) are zero-filled (and not read).
template <typename T>
__device__ __forceinline__ void wide_copy(T* dst, int ldd, const T* __restrict__ src, int64_t ld,
                                          int64_t r0, int64_t rend, int c0, int cend, int pieces,
                                          int e) {
  const int r = e / pieces, c = (e % pieces) * (16 / (int)sizeof(T));
  const bool valid = r0 + r < rend && c0 + c < cend;
  cp_async16_zfill(dst + r * ldd + c, valid ? src + (r0 + r) * ld + c0 + c : src, valid);
}

// Step 1: the LayerNorm of job blockIdx.y's rows into a plane in T, and each
// row's mean and 1/sigma: one warp a row, the row read in pairs.  Rows are C
// wide (the tile width); the statistics divide by the logical width cl.
template <typename T>
struct WideLnArgs {
  const T* src[2];
  const T* sc[2];
  const T* bi[2];
  T* s[2];
  float* mu[2];
  float* inv[2];
};

template <typename T>
__global__ void __launch_bounds__(kWideLnRows * 32) wide_ln_kernel(WideLnArgs<T> a, int N, int C, int cl) {
  const int job = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* __restrict__ sc = a.sc[job];
  const T* __restrict__ bi = a.bi[job];
  for (int64_t row = (int64_t)blockIdx.x * kWideLnRows + warp; row < N;
       row += (int64_t)gridDim.x * kWideLnRows) {
    const T* x = a.src[job] + row * C;
    float sum = 0.0f, sq = 0.0f;
    for (int c = 2 * lane; c < C; c += 64) {
      float v0, v1;
      load_pair(x + c, v0, v1);
      sum += v0 + v1;
      sq += v0 * v0 + v1 * v1;
    }
    const float mu = warp_sum(sum) / cl;
    const float inv = rsqrtf(warp_sum(sq) / cl - mu * mu + kEps);
    T* s = a.s[job] + row * C;
    for (int c = 2 * lane; c < C; c += 64) {
      float v0, v1, s0, s1, b0, b1;
      load_pair(x + c, v0, v1);
      load_pair(sc + c, s0, s1);
      load_pair(bi + c, b0, b1);
      store_pair(s + c, (v0 - mu) * inv * s0 + b0, (v1 - mu) * inv * s1 + b1);
    }
    if (lane == 0) {
      a.mu[job][row] = mu;
      a.inv[job][row] = inv;
    }
  }
}

// Step 2: the gate products, then the forward's gates or the gate
// backward.  Job h of K4 and K5 is (Wag, Wap) or (Wbg, Wbp) against s; K6's
// and K7's one job is (Wog against s, Wo against t).  With the gate
// pre-activation G and the projection P at a point: sg = sigmoid(G + bg),
// pj = P + bp.  Forward (kFwd): d[h][0] = sg pj m (K4's a and b, m the
// mask; K6's out, m = 1).  Backward, with the point's cotangent ct (times
// the mask in K5): d[h][0] = ct pj sg (1 - sg) (dag, dbg; K7's dpre), d[h][1]
// = ct sg (dap, dbp; K7's du), and the tile's column sums of both.
template <typename T>
struct WideGateArgs {
  const T* a[2];        // the row operands of the two products (s, s or s, t)
  const T* w[2][2];     // [job][product] weights (C, C), stored (in, out)
  const T* bias[2][2];  // [job][product]
  const T* ct[2];       // backward: [job] cotangent rows (N, C)
  const T* mask;        // K4, K5: (N,); K6, K7: none
  T* d[2][2];           // [job][product] the cast gradients, (N, C) planes; forward: [job][0] the output
  int vidx[2][2];       // backward: [job][product] slot of their column sums among the six vectors
  float* vpart;         // backward: (row tiles, 6, C) column sums
  int njobs;
};

// the ring, and the backward's column sums of the warps
template <typename T, int NA, bool kFwd>
__host__ __device__ constexpr size_t wide_gate_smem() {
  return sizeof(T) * wide_gate_stages(NA) * WideStage<T, false, NA>::ELEMS +
         (kFwd ? 0 : sizeof(float) * 4 * kWideGateN);
}

template <typename T, int NA, bool kFwd>
__global__ void __launch_bounds__(kWideThreads, 2) wide_gate_kernel(WideGateArgs<T> a, int N, int C) {
  using S = WideStage<T, false, NA>;
  constexpr int STAGES = wide_gate_stages(NA);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int nct = (C + kWideGateN - 1) / kWideGateN, nk = (C + S::BK - 1) / S::BK;
  const int64_t rtiles = ((int64_t)N + kWideBM - 1) / kWideBM;
  const int64_t ntiles = rtiles * a.njobs * nct;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // tiles: the column tile fastest, then the job, then the row tile
  auto load = [&](T* stage, int64_t tile, int ks) {
    const int nt = (int)(tile % nct), job = (int)((tile / nct) % a.njobs);
    const int64_t r0 = tile / ((int64_t)nct * a.njobs) * kWideBM;
    const int k0 = ks * S::BK;
#pragma unroll
    for (int q = 0; q < NA; ++q)
#pragma unroll
      for (int e = tid; e < kWideBM * S::BK / S::E; e += kWideThreads)
        wide_copy(stage + q * S::A_ELEMS, S::LDK, a.a[q], C, r0, N, k0, C, S::BK / S::E, e);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      for (int e = tid; e < S::BK * kWideGateN / S::E; e += kWideThreads)
        wide_copy(stage + NA * S::A_ELEMS + h * S::B_ELEMS, kWideLdn, a.w[job][h], C, k0, C,
                  nt * kWideGateN, C, kWideGateN / S::E, e);
  };
  auto epilogue = [&](int64_t tile, const WideAcc<false>& acc) {
    const int nt = (int)(tile % nct), job = (int)((tile / nct) % a.njobs);
    const int64_t mt = tile / ((int64_t)nct * a.njobs);
    // this warp's 16 columns: all past C, or none (C is a multiple of 16: a
    // ragged width comes staged to round_up(cl, 16), zero past cl)
    const int n0 = nt * kWideGateN + 16 * wn;
    if constexpr (kFwd) {  // the gates
      if (n0 >= C) return;
      float bg[2][2], bp[2][2];  // [j][e]: the biases of this lane's columns n0 + 8 j + 2 t + e
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        load_pair(a.bias[job][0] + n0 + 8 * j + 2 * t, bg[j][0], bg[j][1]);
        load_pair(a.bias[job][1] + n0 + 8 * j + 2 * t, bp[j][0], bp[j][1]);
      }
      T* out = a.d[job][0];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = mt * kWideBM + 64 * wm + 16 * i + g + 8 * rr;
          if (row >= N) continue;
          const float m = a.mask ? tof(a.mask[row]) : 1.0f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = sigmoidf(acc.c[0][i][j][2 * rr + e] + bg[j][e]) *
                     (acc.c[1][i][j][2 * rr + e] + bp[j][e]) * m;
            store_pair(out + row * C + n0 + 8 * j + 2 * t, v[0], v[1]);
          }
        }
    } else {  // the gate backward
      const bool live = n0 < C;
      const T* bg = a.bias[job][0] + n0;
      const T* bp = a.bias[job][1] + n0;
      const T* ct = a.ct[job];
      float sums[2][2][2] = {};  // [product][j][e]: this lane's rows, summed
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int64_t row = mt * kWideBM + 64 * wm + 16 * i + g + 8 * rr;
          if (row >= N || !live) continue;
          const float m = a.mask ? tof(a.mask[row]) : 1.0f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 8 * j + 2 * t;  // the column, from n0
            float c0, c1, g0, g1, p0, p1;
            load_pair(ct + row * C + n0 + c, c0, c1);
            load_pair(bg + c, g0, g1);
            load_pair(bp + c, p0, p1);
            float dg[2], dp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ctm = (e ? c1 : c0) * m;
              const float sg = sigmoidf(acc.c[0][i][j][2 * rr + e] + (e ? g1 : g0));
              const float pj = acc.c[1][i][j][2 * rr + e] + (e ? p1 : p0);
              dg[e] = ctm * pj * sg * (1.0f - sg);
              dp[e] = ctm * sg;
              sums[0][j][e] += dg[e];
              sums[1][j][e] += dp[e];
            }
            store_pair(a.d[job][0] + row * C + n0 + c, dg[0], dg[1]);
            store_pair(a.d[job][1] + row * C + n0 + c, dp[0], dp[1]);
          }
        }
      // the tile's column sums: the warp's 64 rows by shuffles, then the two
      // row halves (wm) in order, through the warps' sums [wm][product][64]
      float* csum = reinterpret_cast<float*>(smem_raw + sizeof(T) * STAGES * S::ELEMS);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = column_sum(sums[h][j][e]);
            if (g == 0) csum[(wm * 2 + h) * kWideGateN + 16 * wn + 8 * j + 2 * t + e] = v;
          }
      __syncthreads();
      if (tid < 2 * kWideGateN && nt * kWideGateN + tid % kWideGateN < C) {
        const int h = tid / kWideGateN, c = tid % kWideGateN;
        a.vpart[(mt * 6 + a.vidx[job][h]) * C + nt * kWideGateN + c] =
            csum[h * kWideGateN + c] + csum[(2 + h) * kWideGateN + c];
      }
    }
  };
  wide_mainloop<false, NA, STAGES>(ring, ntiles, nk, load, epilogue);
}

// Step 3: dsrc (N, C, f32) = sum over k < nmat of a_k @ w_k^T, depth nmat C;
// k-step ks reads plane ks / (C / BK) of a and the same columns of w's rows.
template <typename T>
struct WideBackArgs {
  const T* a[4];  // cast cotangent planes (N, C)
  const T* w[4];  // weights (C, C), stored (in, out): row n of w is column n of w^T
  int nmat;
  float* dsrc;    // (N, C)
};

template <typename T>
__host__ __device__ constexpr size_t wide_back_smem() {
  return sizeof(T) * kWideBackStages * WideStage<T, true, 1>::ELEMS;
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 2) wide_back_kernel(WideBackArgs<T> a, int N, int C) {
  using S = WideStage<T, true, 1>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int nct = (C + kWideBackN - 1) / kWideBackN, kper = (C + S::BK - 1) / S::BK;
  const int nk = a.nmat * kper;
  const int64_t ntiles = ((int64_t)N + kWideBM - 1) / kWideBM * nct;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  auto load = [&](T* stage, int64_t tile, int ks) {
    const int nt = (int)(tile % nct), k = ks / kper, k0 = (ks % kper) * S::BK;
    const int64_t r0 = tile / nct * kWideBM;
    for (int e = tid; e < kWideBM * S::BK / S::E; e += kWideThreads)
      wide_copy(stage, S::LDK, a.a[k], C, r0, N, k0, C, S::BK / S::E, e);
    for (int e = tid; e < kWideBackN * S::BK / S::E; e += kWideThreads)
      wide_copy(stage + S::A_ELEMS, S::LDK, a.w[k], C, (int64_t)nt * kWideBackN, C, k0, C,
                S::BK / S::E, e);
  };
  auto epilogue = [&](int64_t tile, const WideAcc<true>& acc) {
    const int n0 = (int)(tile % nct) * kWideBackN + 32 * wn;
    const int64_t r0 = tile / nct * kWideBM + 64 * wm;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int64_t row = r0 + 16 * i + g + 8 * rr;
        if (row >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          if (n < C)
            store_pair(a.dsrc + row * C + n, acc.c[0][i][j][2 * rr], acc.c[0][i][j][2 * rr + 1]);
        }
      }
  };
  wide_mainloop<true, 1, kWideBackStages>(ring, ntiles, nk, load, epilogue);
}

// Step 4: the LayerNorm backward, a 128-row tile a block: dx = inv (dxh -
// mean(dxh) - xhat mean(dxh xhat)), dxh = dsrc scale.  The warps take rows
// for the two row means; then each thread owns column pairs and walks the
// tile's rows in order for dx and the tile's column sums of dsrc * xhat and
// dsrc (slots va, vb of the vector partials).  Rows C wide, the means over
// the logical width cl.
template <typename T>
struct WideLnBwdArgs {
  const float* dsrc;
  const T* x;
  const float* mu;
  const float* inv;
  const T* sc;
  T* dx;
  float* vpart;
  int va, vb;
};

template <typename T>
__global__ void __launch_bounds__(kWideThreads) wide_ln_bwd_kernel(WideLnBwdArgs<T> a, int N, int C, int cl) {
  __shared__ float rmu[kWideBM], rinv[kWideBM], rm1[kWideBM], rm2[kWideBM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t tile = blockIdx.x, r0 = tile * kWideBM;
  const int nrows = (int)min((int64_t)kWideBM, (int64_t)N - r0);
  for (int r = warp; r < nrows; r += kWideThreads / 32) {
    const int64_t row = r0 + r;
    const float mu = a.mu[row], inv = a.inv[row];
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = 2 * lane; c < C; c += 64) {
      float d0, d1, x0, x1, k0, k1;
      load_pair(a.dsrc + row * C + c, d0, d1);
      load_pair(a.x + row * C + c, x0, x1);
      load_pair(a.sc + c, k0, k1);
      const float e0 = d0 * k0, e1 = d1 * k1;
      s1 += e0 + e1;
      s2 += e0 * ((x0 - mu) * inv) + e1 * ((x1 - mu) * inv);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      rmu[r] = mu;
      rinv[r] = inv;
      rm1[r] = s1 / cl;
      rm2[r] = s2 / cl;
    }
  }
  __syncthreads();
  for (int c = 2 * tid; c < C; c += 2 * kWideThreads) {
    float k0, k1;
    load_pair(a.sc + c, k0, k1);
    float sx0 = 0.0f, sx1 = 0.0f, sb0 = 0.0f, sb1 = 0.0f;
    for (int r = 0; r < nrows; ++r) {
      const int64_t row = r0 + r;
      const float mu = rmu[r], inv = rinv[r], m1 = rm1[r], m2 = rm2[r];
      float d0, d1, x0, x1;
      load_pair(a.dsrc + row * C + c, d0, d1);
      load_pair(a.x + row * C + c, x0, x1);
      const float xh0 = (x0 - mu) * inv, xh1 = (x1 - mu) * inv;
      store_pair(a.dx + row * C + c, inv * (d0 * k0 - m1 - xh0 * m2),
                 inv * (d1 * k1 - m1 - xh1 * m2));
      sx0 += d0 * xh0;
      sx1 += d1 * xh1;
      sb0 += d0;
      sb1 += d1;
    }
    store_pair(a.vpart + (tile * 6 + a.va) * C + c, sx0, sx1);
    store_pair(a.vpart + (tile * 6 + a.vb) * C + c, sb0, sb1);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// host: plans and launches
// ---------------------------------------------------------------------------

namespace {

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int K>
bool aligned16(const void* const (&ptrs)[K]) {
  for (int i = 0; i < K; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  return true;
}

// Tiles, grids and scratch for one call.  Deterministic for a given device,
// kind, dtype, N and the logical width cl, so the launch recomputes what the
// workspace query returned.  The tiles work on C = round_up(cl, 16): the
// caller's tensors are that wide, zero past cl (ops/tri_mul.py stages a
// ragged width so), and only the LayerNorms divide by cl.  The route is a
// function of kind, dtype and C alone (the table at the top).  Returns
// kErrUnsupportedC when cl < 1 or the tiles do not fit in shared memory.
template <typename T>
int make_plan(int device, int kind, int N, int cl, Plan* out, HostPlan* host) {
  if (cl < 1 || N < 0) return kErrUnsupportedC;
  const int C = (cl + 15) / 16 * 16;
  Plan p{};
  HostPlan h{};
  p.N = N;
  p.C = C;
  p.cl = cl;
  p.lds = C + kPadT;
  p.res_smem = ResSmem<T>::carve(0, C, res_nw(kind), res_nsrc(kind), nullptr);
  p.resident = C <= ResMax<T>::C && p.res_smem <= kSmemLimit;
  // resident where the weights fit (bf16 C <= 128, float32 C <= 64), else
  // wide: every kernel, both dtypes
  const bool wide = !p.resident;
  h.route = wide ? kRouteWide : kRouteResident;
  cudaError_t err = cudaDeviceGetAttribute(&h.nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int nsm = h.nsm;
  p.work_floats = 0;
  if (p.resident) {  // one block an SM: its registers leave room for no second
    const long long need = ((long long)N + 16 * res_warps(kind) - 1) / (16 * res_warps(kind));
    p.res_grid = (int)(need < nsm ? need : nsm);
  }
  if (is_bwd(kind)) {
    p.njobs = n_dpre(kind);
    // the output tile, in 16s: the largest divisor of C / 16 up to 8.  The
    // resident route (C <= 128) recomputes s and takes all of C x C as one
    // tile; the wide route reads its tiles' columns of the s plane
    int units = 8;
    while ((C / 16) % units) --units;
    p.wg_tile = 16 * units;
    const int per = C / p.wg_tile;
    p.tiles = per * per;
    // the wide float32 pass runs two blocks an SM (wgrad_kernel<float, true>)
    const size_t wg_limit = wide && sizeof(T) == 4 ? kSmemLimit / 2 - 1024 : kSmemLimit;
    for (p.wg_rows = kWgRows; p.wg_rows >= 16; p.wg_rows /= 2) {
      p.wg_smem = WgradSmem<T>::carve(0, p, wide, nullptr);
      if (p.wg_smem <= wg_limit) break;
    }
    if (p.wg_rows < 16) return kErrUnsupportedC;
    const int max_chunks = (N + p.wg_rows - 1) / p.wg_rows;
    const int jobs = p.tiles * p.njobs;
    int want = (2 * nsm + jobs - 1) / jobs;  // two blocks an SM
    const int chunks = want < max_chunks ? want : max_chunks;
    if (chunks > 0) {
      const int rows = (N + chunks - 1) / chunks;
      p.chunk_rows = (rows + p.wg_rows - 1) / p.wg_rows * p.wg_rows;
      p.chunks = (N + p.chunk_rows - 1) / p.chunk_rows;
    }
    if (p.resident)  // the resident rows pass's blocks write vector partials
      p.work_floats = (long long)p.res_grid * 6 * C + (long long)p.chunks * p.njobs * C * C;
  }
  if (wide) {  // the forward takes the statistics and the planes alone
    h.rtiles = (N + kWideBM - 1) / kWideBM;
    long long off = 0;
    auto take = [&](long long floats) {  // 128-byte aligned regions
      const long long at = off;
      off += (floats + 31) / 32 * 32;
      return at;
    };
    if (is_bwd(kind)) {
      h.off_vpart = take((long long)h.rtiles * 6 * C);
      h.off_wpart = take((long long)p.chunks * p.njobs * C * C);
    }
    h.off_stats = take(2LL * n_ln(kind) * N);
    if (is_bwd(kind)) h.off_dsrc = take((long long)N * C);
    h.off_s = take((long long)n_ln(kind) * N * C * (long long)sizeof(T) / 4);
    p.work_floats = off;
  }
  *out = p;
  if (host) *host = h;
  return 0;
}

template <typename T, int NA, bool kFwd>
int launch_wide_gate(const WideGateArgs<T>& ga, int grid, int N, int C, cudaStream_t st) {
  constexpr size_t smem = wide_gate_smem<T, NA, kFwd>();
  const cudaError_t err = set_smem(wide_gate_kernel<T, NA, kFwd>, smem);
  if (err != cudaSuccess) return (int)err;
  wide_gate_kernel<T, NA, kFwd><<<grid, kWideThreads, smem, st>>>(ga, N, C);
  return (int)cudaGetLastError();
}

// The wide route's chain (the note above wide_ln_kernel) on stream st, its
// scratch carved from the workspace as make_plan laid it out: steps 1 and 2
// for the forward (K4, K6), 1-6 for the backward (K5, K7; dvec and dmat are
// the backward's).
template <typename T>
int run_wide(const Plan& p, const HostPlan& h, int kind, const RowArgs<T>& a, T* dvec, T* dmat,
             float* work, cudaStream_t st) {
  const int N = p.N, C = p.C, nln = n_ln(kind);
  const bool pro = kind <= kProBwd, bwd = is_bwd(kind);
  float* vpart = work + h.off_vpart;
  float* wpart = work + h.off_wpart;
  float* stats = work + h.off_stats;
  float* dsrc = work + h.off_dsrc;
  T* s = reinterpret_cast<T*>(work + h.off_s);
  cudaError_t err;
  // 1. s = LN(x) (and K6's and K7's t = LN2(p)), their statistics
  WideLnArgs<T> ln{};
  for (int j = 0; j < nln; ++j) {
    ln.src[j] = j ? a.aux : a.x;
    ln.sc[j] = a.vec[3 * j];
    ln.bi[j] = a.vec[3 * j + 1];
    ln.s[j] = s + (size_t)j * N * C;
    ln.mu[j] = stats + (size_t)2 * j * N;
    ln.inv[j] = ln.mu[j] + N;
  }
  const long long ln_need = ((long long)N + kWideLnRows - 1) / kWideLnRows;
  const int ln_grid = (int)(ln_need < 64LL * h.nsm ? ln_need : 64LL * h.nsm);
  wide_ln_kernel<T><<<dim3(ln_grid, nln), kWideLnRows * 32, 0, st>>>(ln, N, C, p.cl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2. the gate products, then the gates (forward: a and b, or out) or the
  // gate backward (dpre planes, column sums)
  WideGateArgs<T> ga{};
  ga.a[0] = s;
  ga.a[1] = s + (size_t)(nln - 1) * N * C;
  ga.mask = pro ? a.aux : nullptr;
  ga.vpart = vpart;
  ga.njobs = pro ? 2 : 1;
  for (int j = 0; j < ga.njobs; ++j) {
    ga.ct[j] = a.ct[j];
    for (int h = 0; h < 2; ++h) {
      ga.w[j][h] = a.mat[2 * j + h];
      ga.vidx[j][h] = pro ? 2 + 2 * j + h : (h ? 5 : 2);
      ga.bias[j][h] = a.vec[ga.vidx[j][h]];
      ga.d[j][h] = bwd ? a.dpre + (size_t)(2 * j + h) * N * C : (h ? nullptr : a.out[j]);
    }
  }
  const long long gate_tiles = (long long)h.rtiles * ga.njobs * ((C + kWideGateN - 1) / kWideGateN);
  const int gate_grid = (int)(gate_tiles < 2LL * h.nsm ? gate_tiles : 2LL * h.nsm);
  const int rc = pro ? (bwd ? launch_wide_gate<T, 1, false>(ga, gate_grid, N, C, st)
                            : launch_wide_gate<T, 1, true>(ga, gate_grid, N, C, st))
                     : (bwd ? launch_wide_gate<T, 2, false>(ga, gate_grid, N, C, st)
                            : launch_wide_gate<T, 2, true>(ga, gate_grid, N, C, st));
  if (rc != 0 || !bwd) return rc;
  // 3, 4. dsrc = sum_k dpre_k @ W_k^T, then the LayerNorm backward (K7: LN1's,
  // then LN2's through the same dsrc plane)
  const long long back_tiles = (long long)h.rtiles * ((C + kWideBackN - 1) / kWideBackN);
  const int back_grid = (int)(back_tiles < 2LL * h.nsm ? back_tiles : 2LL * h.nsm);
  constexpr size_t back_smem = wide_back_smem<T>();
  if ((err = set_smem(wide_back_kernel<T>, back_smem)) != cudaSuccess) return (int)err;
  for (int j = 0; j < nln; ++j) {
    WideBackArgs<T> ba{};
    ba.nmat = pro ? 4 : 1;
    for (int k = 0; k < ba.nmat; ++k) {
      ba.a[k] = a.dpre + (size_t)(j + k) * N * C;
      ba.w[k] = a.mat[j + k];
    }
    ba.dsrc = dsrc;
    wide_back_kernel<T><<<back_grid, kWideThreads, back_smem, st>>>(ba, N, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    WideLnBwdArgs<T> lb{};
    lb.dsrc = dsrc;
    lb.x = j ? a.aux : a.x;
    lb.mu = ln.mu[j];
    lb.inv = ln.inv[j];
    lb.sc = a.vec[3 * j];
    lb.dx = a.out[j];
    lb.vpart = vpart;
    lb.va = 3 * j;
    lb.vb = 3 * j + 1;
    wide_ln_bwd_kernel<T><<<h.rtiles, kWideThreads, 0, st>>>(lb, N, C, p.cl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 5. weight gradients from the LayerNorm planes
  WgradArgs<T> g{};
  for (int j = 0; j < p.njobs; ++j) {
    g.src[j] = (!pro && j == 1) ? s + (size_t)N * C : s;
    g.d[j] = a.dpre + (size_t)j * N * C;
  }
  g.part = wpart;
  if ((err = set_smem(wgrad_kernel<T, true>, p.wg_smem)) != cudaSuccess) return (int)err;
  wgrad_kernel<T, true><<<p.chunks * p.njobs * p.tiles, kThreads, p.wg_smem, st>>>(g, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 6. the row tiles' column sums, the chunks' weight gradients, in order
  const int64_t mv = 6LL * C, mm = (int64_t)p.njobs * C * C;
  reduce_kernel<T><<<(int)((mv + 255) / 256), 256, 0, st>>>(vpart, h.rtiles, mv, dvec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<T><<<(int)((mm + 255) / 256), 256, 0, st>>>(wpart, p.chunks, mm, dmat);
  return (int)cudaGetLastError();
}

// A resident rows pass: the kernels of both dtypes are overloads on RowArgs<T>,
// picked by the pointer's type.
template <typename T> using RowsKernel = void (*)(RowArgs<T>, Plan);

template <typename T>
int launch_rows(RowsKernel<T> kernel, int warps, const Plan& p, const RowArgs<T>& a, cudaStream_t st) {
  const cudaError_t err = set_smem(kernel, p.res_smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.res_grid, warps * 32, p.res_smem, st>>>(a, p);
  return (int)cudaGetLastError();
}

// The resident route of `kind`: its rows pass, then (backward) the
// weight-gradient pass and the two reductions; kRagged when the logical
// width is not the tile width (ln_divisor).
template <typename T, bool kRagged>
int run_resident(const Plan& p, int kind, const RowArgs<T>& a, T* dvec, T* dmat, float* work,
                 cudaStream_t st) {
  if (kind == kEpiFwd) return launch_rows<T>(epilogue_fwd_resident_kernel<T, kRagged>, kFwdWarps, p, a, st);
  if (kind == kProFwd) return launch_rows<T>(prologue_fwd_resident_kernel<kRagged>, kFwdWarps, p, a, st);
  const bool pro = kind == kProBwd;
  int rc = pro ? launch_rows<T>(prologue_bwd_resident_kernel<kRagged>, kResWarps, p, a, st)
               : launch_rows<T>(epilogue_bwd_resident_kernel<kRagged>, kResWarps, p, a, st);
  if (rc != 0) return rc;

  const int N = p.N, C = p.C;
  cudaError_t err;
  WgradArgs<T> g{};
  for (int j = 0; j < p.njobs; ++j) {
    const bool second = !pro && j == 1;  // epilogue: dWo from LN2(prod)
    g.src[j] = second ? a.aux : a.x;
    g.sc[j] = second ? a.vec[3] : a.vec[0];
    g.bi[j] = second ? a.vec[4] : a.vec[1];
    g.d[j] = a.dpre + (size_t)j * N * C;
  }
  g.part = work + (size_t)p.res_grid * 6 * C;
  const auto wgrad = kRagged ? wgrad_ragged_kernel<T> : wgrad_kernel<T, false>;
  if ((err = set_smem(wgrad, p.wg_smem)) != cudaSuccess) return (int)err;
  wgrad<<<p.chunks * p.njobs * p.tiles, kThreads, p.wg_smem, st>>>(g, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t mv = 6LL * C, mm = (int64_t)p.njobs * C * C;
  reduce_kernel<T><<<(int)((mv + 255) / 256), 256, 0, st>>>(work, p.res_grid, mv, dvec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<T><<<(int)((mm + 255) / 256), 256, 0, st>>>(g.part, p.chunks, mm, dmat);
  return (int)cudaGetLastError();
}

// Launch kernel `kind`: the wide route's chain, or the resident route's
// passes.  ptrs follow the C entry points' order after the dtype, N and C
// arguments.
template <typename T>
int run(int device, int kind, int N, int cl, void* const* ptrs, cudaStream_t st) {
  Plan p;
  HostPlan h;
  int rc = make_plan<T>(device, kind, N, cl, &p, &h);
  if (rc != 0) return rc;
  if (N == 0) return 0;
  const bool pro = kind <= kProBwd;
  const int nw = pro ? 10 : 8;
  // weight order: pro lns lnb wag bag wap bap wbg bbg wbp bbp;
  //               epi ln1s ln1b wog bog ln2s ln2b wo bo
  static const int kProVec[6] = {0, 1, 3, 5, 7, 9}, kProMat[4] = {2, 4, 6, 8};
  static const int kEpiVec[6] = {0, 1, 3, 4, 5, 7}, kEpiMat[2] = {2, 6};
  RowArgs<T> a{};
  a.x = (const T*)ptrs[0];
  a.aux = (const T*)ptrs[1];
  const void* const* w = ptrs + 2;
  for (int i = 0; i < 6; ++i) a.vec[i] = (const T*)w[pro ? kProVec[i] : kEpiVec[i]];
  for (int i = 0; i < (pro ? 4 : 2); ++i) a.mat[i] = (const T*)w[pro ? kProMat[i] : kEpiMat[i]];
  void* const* rest = ptrs + 2 + nw;
  T* dvec = nullptr;
  T* dmat = nullptr;
  float* work;
  // the resident passes and the weight-gradient pass copy rows and weights
  // in 16-byte pieces (cp.async), and read cotangents and write outputs in
  // pairs: the wrappers hand all of them over 16-byte aligned
  if (kind == kEpiFwd) {  // forward: the outputs, then the f32 workspace (the wide route's)
    a.out[0] = (T*)rest[0];
    work = (float*)rest[1];
    const void* need[] = {a.x, a.aux, a.mat[0], a.mat[1], a.out[0]};
    if (!aligned16(need)) return kErrBadArgs;
  } else if (kind == kProFwd) {
    a.out[0] = (T*)rest[0];
    a.out[1] = (T*)rest[1];
    work = (float*)rest[2];
    const void* need[] = {a.x, a.mat[0], a.mat[1], a.mat[2], a.mat[3], a.out[0], a.out[1]};
    if (!aligned16(need)) return kErrBadArgs;
  } else {
    // backward: cotangents, grads of the rows, dvec (6, C), dmat (njobs, C,
    // C), dpre scratch (njobs, N, C), f32 workspace
    const int nct = pro ? 2 : 1, nout = pro ? 1 : 2;
    for (int i = 0; i < nct; ++i) a.ct[i] = (const T*)rest[i];
    for (int i = 0; i < nout; ++i) a.out[i] = (T*)rest[nct + i];
    dvec = (T*)rest[nct + nout];
    dmat = (T*)rest[nct + nout + 1];
    a.dpre = (T*)rest[nct + nout + 2];
    work = (float*)rest[nct + nout + 3];
    a.vec_part = work;
    if (pro) {
      const void* need[] = {a.x, a.ct[0], a.ct[1], a.mat[0], a.mat[1], a.mat[2], a.mat[3], a.out[0], a.dpre};
      if (!aligned16(need)) return kErrBadArgs;
    } else {
      const void* need[] = {a.x, a.aux, a.ct[0], a.mat[0], a.mat[1], a.out[0], a.out[1], a.dpre};
      if (!aligned16(need)) return kErrBadArgs;
    }
  }
  if (h.route == kRouteWide) return run_wide<T>(p, h, kind, a, dvec, dmat, work, st);
  return p.cl == p.C ? run_resident<T, false>(p, kind, a, dvec, dmat, work, st)
                     : run_resident<T, true>(p, kind, a, dvec, dmat, work, st);
}

int dispatch(int device, int kind, int dtype, int N, int C, void* const* ptrs, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return run<float>(device, kind, N, C, ptrs, st);
  if (dtype == 1) return run<bf16>(device, kind, N, C, ptrs, st);
  return kErrBadArgs;
}

}  // namespace

// Scratch that `kind` (0 K4, 1 K5, 2 K6, 3 K7) needs, in floats, for dtype
// (0 f32, 1 bf16) at N rows of logical width C: every backward's, and the
// wide route's forward (its LayerNorm planes and statistics; 0 on the
// resident route).  Returns 0, or -1 when C is not supported.
extern "C" int ps_tri_workspace(int device, int kind, int dtype, int N, int C,
                                long long* work_floats) {
  Plan p;
  int rc = dtype == 0 ? make_plan<float>(device, kind, N, C, &p, nullptr)
                      : (dtype == 1 ? make_plan<bf16>(device, kind, N, C, &p, nullptr) : kErrBadArgs);
  if (rc == 0) *work_floats = p.work_floats;
  return rc;
}

// The rows pass that `kind` (0 K4, 1 K5, 2 K6, 3 K7) takes for dtype (0 f32,
// 1 bf16) at logical width C, into *route: 0 resident, 1 wide (the table at
// the top, read at round_up(C, 16); N does not change it).  Returns 0, -1 when C is not
// supported, or a CUDA error code.
extern "C" int ps_tri_route(int device, int kind, int dtype, int N, int C, int* route) {
  Plan p;
  HostPlan h;
  int rc = dtype == 0 ? make_plan<float>(device, kind, N, C, &p, &h)
                      : (dtype == 1 ? make_plan<bf16>(device, kind, N, C, &p, &h) : kErrBadArgs);
  if (rc == 0) *route = h.route;
  return rc;
}

// C is the logical width (any C >= 1) and Cp = round_up(C, 16) the width of
// every tensor: all are contiguous, on `device`, in the stream dtype (0 f32,
// 1 bf16), zero in every column at or past C: rows (N, Cp), the mask (N,),
// vectors (Cp,), matrices (Cp, Cp) stored (in, out); the outputs are as
// wide, their columns past C left unspecified.  At a multiple of 16, Cp = C.
// work holds ps_tri_workspace floats of kind.  Each launches on `stream` and
// returns 0 or a CUDA error code (-1: C not supported).

extern "C" int ps_tri_prologue_fwd(int device, int dtype, int N, int C, const void* x,
                                   const void* m, const void* lns, const void* lnb,
                                   const void* wag, const void* bag, const void* wap,
                                   const void* bap, const void* wbg, const void* bbg,
                                   const void* wbp, const void* bbp, void* a, void* b,
                                   void* work, void* stream) {
  void* const ptrs[] = {(void*)x, (void*)m, (void*)lns, (void*)lnb, (void*)wag, (void*)bag,
                        (void*)wap, (void*)bap, (void*)wbg, (void*)bbg, (void*)wbp, (void*)bbp,
                        a, b, work};
  return dispatch(device, kProFwd, dtype, N, C, ptrs, stream);
}

// dvec (6, Cp): lns, lnb, bag, bap, bbg, bbp; dmat (4, Cp, Cp): wag, wap,
// wbg, wbp; dpre: (4, N, Cp) scratch; work: ps_tri_workspace floats.
extern "C" int ps_tri_prologue_bwd(int device, int dtype, int N, int C, const void* x,
                                   const void* m, const void* lns, const void* lnb,
                                   const void* wag, const void* bag, const void* wap,
                                   const void* bap, const void* wbg, const void* bbg,
                                   const void* wbp, const void* bbp, const void* da,
                                   const void* db, void* dx, void* dvec, void* dmat, void* dpre,
                                   void* work, void* stream) {
  void* const ptrs[] = {(void*)x, (void*)m, (void*)lns, (void*)lnb, (void*)wag, (void*)bag,
                        (void*)wap, (void*)bap, (void*)wbg, (void*)bbg, (void*)wbp, (void*)bbp,
                        (void*)da, (void*)db, dx, dvec, dmat, dpre, work};
  return dispatch(device, kProBwd, dtype, N, C, ptrs, stream);
}

extern "C" int ps_tri_epilogue_fwd(int device, int dtype, int N, int C, const void* x,
                                   const void* p, const void* ln1s, const void* ln1b,
                                   const void* wog, const void* bog, const void* ln2s,
                                   const void* ln2b, const void* wo, const void* bo, void* out,
                                   void* work, void* stream) {
  void* const ptrs[] = {(void*)x, (void*)p, (void*)ln1s, (void*)ln1b, (void*)wog, (void*)bog,
                        (void*)ln2s, (void*)ln2b, (void*)wo, (void*)bo, out, work};
  return dispatch(device, kEpiFwd, dtype, N, C, ptrs, stream);
}

// dvec (6, Cp): ln1s, ln1b, bog, ln2s, ln2b, bo; dmat (2, Cp, Cp): wog, wo;
// dpre: (2, N, Cp) scratch; work: ps_tri_workspace floats.
extern "C" int ps_tri_epilogue_bwd(int device, int dtype, int N, int C, const void* x,
                                   const void* p, const void* ln1s, const void* ln1b,
                                   const void* wog, const void* bog, const void* ln2s,
                                   const void* ln2b, const void* wo, const void* bo,
                                   const void* dout, void* dx, void* dp, void* dvec, void* dmat,
                                   void* dpre, void* work, void* stream) {
  void* const ptrs[] = {(void*)x, (void*)p, (void*)ln1s, (void*)ln1b, (void*)wog, (void*)bog,
                        (void*)ln2s, (void*)ln2b, (void*)wo, (void*)bo, (void*)dout, dx, dp,
                        dvec, dmat, dpre, work};
  return dispatch(device, kEpiBwd, dtype, N, C, ptrs, stream);
}
