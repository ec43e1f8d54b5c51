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
// Matrix products run inside the kernels.  K5's rows pass and the
// weight-gradient pass (K5 and K7) use mma.sync on the tensor cores: bf16
// m16n8k16 with f32 accumulators, float32 as 3xTF32 m16n8k8 (x = big +
// small, three TF32 products, small terms first; helpers in mma.cuh, shared
// with flash_attn.cu).  The streamed rows passes (K4, K6, K7, and K5 where
// its weights do not fit) use nvcuda::wmma 16x16x16 in bf16 and FMA loops in
// full f32 (the library is built with FMA contraction on).
//
// K5 (the prologue backward) takes one of two rows passes, chosen by dtype
// and C in make_plan:
//
//  * resident (bf16 C <= 128, float32 C <= 64):
//    prologue_bwd_resident_kernel<T>.  One persistent block of 8 warps an
//    SM copies wag, wap, wbg, wbp into shared memory once
//    (cp.async; 136 KB in bf16 at C = 128, padded a row) and every warp walks
//    its own 16-row tiles, the next tile's x in flight through a two-stage
//    cp.async ring of its own.  The LayerNorm runs on the fragments in
//    registers, s becomes the A fragments of s @ W (W read with
//    ldmatrix.trans; float32 by hand), the gate backward runs on the
//    accumulator fragments, dpre is cast to T once and is both stored to the
//    scratch and (as registers) the A fragment of dpre @ W^T, which reads the
//    same copy of W (ldmatrix; float32 in the k order 0, 2, 4, 6, 1, 3, 5, 7).
//    dsrc stays in registers (16 x C f32 a warp), the LayerNorm backward and
//    dx come from it.  The cotangents are read from global memory straight
//    into the fragments' registers (shared memory holds the weights).  Column
//    sums: warp shuffles over a fragment's rows, a per-lane running sum per
//    chunk, then warp by warp into the block's vacc.  Registers: 239 (bf16) /
//    216 (float32) a thread, no spills, so 8 warps an SM is what fits; the
//    weights, vectors and rings take 215,040 of the 232,448 bytes of shared
//    memory a block may have (bf16, C = 128).
//  * streamed (every other C): prologue_bwd_kernel, as K7's rows pass below.
//
// What bounds K5 on an H100 at N = 4*512*512, C = 128, bf16: 12 products of
// 2 N C^2 (412 GFLOP, 0.42 ms at 989 TFLOP/s) against about 2.4 GB of traffic
// (0.7 ms at 3.35 TB/s, the 1.07 GB dpre scratch written and read back
// included).  The resident rows pass is bound by its instruction rate and
// latencies at 8 warps an SM (ldmatrix + mma.sync, the gate's exp, column
// shuffles; no single part dominates, PERF.md); the weight-gradient pass by
// its per-step ring.
//
// The streamed rows passes.  A block of 256 threads takes TR pair rows at a
// time (64 in bf16, 32 in f32, fewer where C is wide) and keeps them in
// shared memory as the LayerNorm output s (TR x C, T).  The (C, C) weights
// are streamed through shared memory in TNK x TNK chunks (TNK = 64, 32 or
// 16, dividing C), so no weight has to fit whole.  Each TR x TNK output
// chunk is staged in f32 in shared memory, where the gates, masks and casts
// are applied and the result is written out with coalesced stores.  Ragged
// rows past N are zeros in shared memory and are never stored.  Restaging
// the weights for every row tile bounds them (PERF.md has the times).
//
// The Pallas backwards sum weight gradients into one block that the
// sequential TPU grid revisits.  Here blocks run in parallel, so:
//  * bias and LayerNorm gradients: each persistent block (grid fixed by the
//    SM count) sums its tiles' columns and writes one f32 partial; a second
//    kernel adds the partials in block order;
//  * weight gradients dW = s^T @ dpre: the rows kernel writes dpre (cast to
//    T) to a scratch buffer; wgrad_kernel gives each block a chunk of rows,
//    one job (K5: wag, wap, wbg, wbp; K7: wog, wo) and one output tile,
//    recomputes s from the pair rows, and sums s^T @ dpre on mma.sync into
//    an f32 partial; the same reduction kernel adds the chunks in order.  Up
//    to C = 128 the tile is all of C x C, so a row's LayerNorm is computed
//    once per job; wider, the tile is at most 128 x 128 and each of the
//    (C / tile)^2 tiles of a job recomputes it (4 times per row per job at
//    C = 256, which only the streamed rows passes reach).
// No atomics: the result is the same from run to run.  The kernels allocate
// nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-6f;
constexpr int kPadT = 8;     // row padding of T tiles, in elements
constexpr int kPadF = 4;     // row padding of f32 tiles, in floats
constexpr int kWgRows = 64;  // rows per step of the weight-gradient kernel, at most
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kErrUnsupportedC = -1;
constexpr int kErrBadArgs = -2;

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
// block tile accumulators of the streamed rows passes: acc (TR x TN, TR and
// TN multiples of 16, <= 64) += A (TR x K) @ B (K x TN), A(m, k) =
// A[m*lda + k], B(k, n) = B[k*ldb + n].  All operands in shared memory.
// ---------------------------------------------------------------------------

template <typename T> struct TileAcc;

// f32: FMA loops.  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and
// columns tx + 16 j of the tile.
template <> struct TileAcc<float> {
  float acc[4][4];
  int mi, nj;

  __device__ void init(int tr, int tn) {
    mi = tr / 16;
    nj = tn / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  __device__ void mma(const float* A, int lda, const float* B, int ldb, int K) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = i < mi ? A[(ty + 16 * i) * lda + k] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = j < nj ? B[k * ldb + tx + 16 * j] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(float* S, int lds) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i < mi && j < nj) S[(ty + 16 * i) * lds + tx + 16 * j] = acc[i][j];
  }
};

// bf16: tensor cores.  Warp w owns 16 x 16 fragments w and w + 8 of the tile
// (row-major over fragments); a 64 x 64 tile has 16.
template <> struct TileAcc<bf16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  int fn_count, nfrag;

  __device__ void init(int tr, int tn) {
    fn_count = tn / 16;
    nfrag = (tr / 16) * fn_count;
    wmma::fill_fragment(c[0], 0.0f);
    wmma::fill_fragment(c[1], 0.0f);
  }

  __device__ void mma(const bf16* A, int lda, const bf16* B, int ldb, int K) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = warp + kWarps * q;
      if (f < nfrag) {
        const int fm = f / fn_count, fn = f % fn_count;
        for (int k = 0; k < K; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, A + fm * 16 * lda + k, lda);
          wmma::load_matrix_sync(b, B + k * ldb + fn * 16, ldb);
          wmma::mma_sync(c[q], a, b, c[q]);
        }
      }
    }
  }

  __device__ void store(float* S, int lds) const {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = warp + kWarps * q;
      if (f < nfrag) {
        const int fm = f / fn_count, fn = f % fn_count;
        wmma::store_matrix_sync(S + fm * 16 * lds + fn * 16, c[q], lds, wmma::mem_row_major);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// launch plan and shared-memory layout (computed alike on host and device)
// ---------------------------------------------------------------------------

struct Plan {
  int N, C, TR, TNK;
  int lds, ldw, ldf, ldc;  // row strides: s/d tiles, weight chunks, f32 stages, f32 dbuf
  int ntiles, grid;        // rows kernels: row tiles, persistent blocks
  size_t smem;
  int njobs, tiles, chunks, chunk_rows, wg_tile, wg_rows;  // weight-gradient kernel
  size_t wg_smem;
  int resident, res_grid;  // K5: the resident-weight rows pass takes this shape
  size_t res_smem;
  long long work_floats;   // f32 scratch: grid*6*C vector partials + chunks*njobs*C*C
};

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

// Shared memory of the rows kernels: the LayerNorm'd tiles s[], the dpre
// tiles d[] (backward), two weight chunks, two f32 output stages which the
// backward's full-width f32 dsrc buffer overlays (never live together), the
// backward's per-block column sums vacc (6 x C), row statistics and the mask.
template <typename T>
struct RowsSmem {
  T* s[2];
  T* d[4];
  T* w0;
  T* w1;
  float* st0;
  float* st1;
  float* dbuf;
  float* vacc;
  float* mu[2];
  float* inv[2];
  float* mrow;

  __host__ __device__ static size_t carve(uintptr_t base, const Plan& p, int kind, RowsSmem* out) {
    Carver cv{base, 0};
    RowsSmem r{};
    const size_t tile = sizeof(T) * p.TR * p.lds;
    for (int i = 0; i < n_ln(kind); ++i) r.s[i] = (T*)cv.take(tile);
    for (int i = 0; i < n_dpre(kind); ++i) r.d[i] = (T*)cv.take(tile);
    r.w0 = (T*)cv.take(sizeof(T) * p.TNK * p.ldw);
    r.w1 = (T*)cv.take(sizeof(T) * p.TNK * p.ldw);
    const size_t st = ((sizeof(float) * p.TR * p.ldf + 127) / 128) * 128;
    const size_t db = is_bwd(kind) ? sizeof(float) * p.TR * p.ldc : 0;
    const uintptr_t u = cv.take(2 * st > db ? 2 * st : db);
    r.st0 = (float*)u;
    r.st1 = (float*)(u + st);
    r.dbuf = (float*)u;
    if (is_bwd(kind)) r.vacc = (float*)cv.take(sizeof(float) * 6 * p.C);
    for (int i = 0; i < n_ln(kind); ++i) {
      r.mu[i] = (float*)cv.take(sizeof(float) * p.TR);
      r.inv[i] = (float*)cv.take(sizeof(float) * p.TR);
    }
    r.mrow = (float*)cv.take(sizeof(float) * p.TR);
    if (out) *out = r;
    return cv.off;
  }
};

// ---------------------------------------------------------------------------
// row helpers
// ---------------------------------------------------------------------------

// LayerNorm rows [r0, r0 + TR) of src (., C) into dst (TR x lds, T): f32
// statistics, fast variance, y = ((x - mu) * inv) * scale + bias cast to T.
// Rows at or past rend are zeros.  Keeps each row's mean and 1/sigma when
// mu_out is given.
template <typename T>
__device__ void ln_rows(const T* __restrict__ src, int64_t r0, int64_t rend, int TR, int C,
                        const T* __restrict__ sc, const T* __restrict__ bi, T* dst, int lds,
                        float* mu_out, float* inv_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TR; r += kWarps) {
    const int64_t row = r0 + r;
    T* d = dst + (size_t)r * lds;
    if (row >= rend) {
      for (int c = lane; c < C; c += 32) d[c] = fromf<T>(0.0f);
      if (lane == 0 && mu_out) {
        mu_out[r] = 0.0f;
        inv_out[r] = 0.0f;
      }
      continue;
    }
    const T* x = src + row * C;
    float sum = 0.0f, sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = tof(x[c]);
      sum += v;
      sq += v * v;
    }
    const float mu = warp_sum(sum) / C;
    const float var = warp_sum(sq) / C - mu * mu;
    const float inv = rsqrtf(var + kEps);
    for (int c = lane; c < C; c += 32) {
      const float xh = (tof(x[c]) - mu) * inv;
      d[c] = fromf<T>(xh * tof(sc[c]) + tof(bi[c]));
    }
    if (lane == 0 && mu_out) {
      mu_out[r] = mu;
      inv_out[r] = inv;
    }
  }
}

// A TNK x TNK chunk of a (C, C) row-major weight into dst[k][n] (stride ld):
// rows k0.., columns n0.. of W, or of W^T when transpose.
template <typename T>
__device__ void load_w(const T* __restrict__ W, int C, int k0, int n0, int TNK, bool transpose,
                       T* dst, int ld) {
  for (int e = threadIdx.x; e < TNK * TNK; e += kThreads) {
    if (!transpose) {
      const int k = e / TNK, n = e % TNK;
      dst[k * ld + n] = W[(size_t)(k0 + k) * C + n0 + n];
    } else {
      const int n = e / TNK, k = e % TNK;
      dst[k * ld + n] = W[(size_t)(n0 + n) * C + k0 + k];
    }
  }
}

// acc[n] += sum over rows < nrows of S[r][n], n < TN, in row order.
__device__ void col_sums(const float* S, int lds, int nrows, int TN, float* acc) {
  for (int n = threadIdx.x; n < TN; n += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < nrows; ++r) s += S[r * lds + n];
    acc[n] += s;
  }
}

// Both products of one TR x TNK output chunk, streaming the two weights'
// k-chunks through shared memory: g = s0 @ Wg[:, n0:], q = s1 @ Wq[:, n0:],
// staged to st0/st1 in f32.  Ends synchronised.
template <typename T>
__device__ void two_products(const Plan& p, const RowsSmem<T>& sm, const T* s0, const T* s1,
                             const T* Wg, const T* Wq, int n0) {
  TileAcc<T> g, q;
  g.init(p.TR, p.TNK);
  q.init(p.TR, p.TNK);
  for (int k0 = 0; k0 < p.C; k0 += p.TNK) {
    load_w(Wg, p.C, k0, n0, p.TNK, false, sm.w0, p.ldw);
    load_w(Wq, p.C, k0, n0, p.TNK, false, sm.w1, p.ldw);
    __syncthreads();
    g.mma(s0 + k0, p.lds, sm.w0, p.ldw, p.TNK);
    q.mma(s1 + k0, p.lds, sm.w1, p.ldw, p.TNK);
    __syncthreads();
  }
  g.store(sm.st0, p.ldf);
  q.store(sm.st1, p.ldf);
  __syncthreads();
}

// dsrc (TR x C, f32, into dbuf) = sum_k d[k] @ W_k^T over nmat cast-dpre
// tiles, the weights streamed transposed.  Ends synchronised.
template <typename T>
__device__ void back_project(const Plan& p, const RowsSmem<T>& sm, T* const* d,
                             const T* const* W, int nmat) {
  for (int n0 = 0; n0 < p.C; n0 += p.TNK) {
    TileAcc<T> acc;
    acc.init(p.TR, p.TNK);
    for (int k = 0; k < nmat; ++k) {
      for (int k0 = 0; k0 < p.C; k0 += p.TNK) {
        load_w(W[k], p.C, k0, n0, p.TNK, true, sm.w0, p.ldw);
        __syncthreads();
        acc.mma(d[k] + k0, p.lds, sm.w0, p.ldw, p.TNK);
        __syncthreads();
      }
    }
    acc.store(sm.dbuf + n0, p.ldc);
  }
  __syncthreads();
}

// LayerNorm backward of rows [r0, r0 + TR) given dsrc in dbuf:
// dx = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)), dxh = dsrc * scale,
// written as T; then the block's column sums of dsrc * xhat and dsrc into
// vs and vb.  Ends synchronised.
template <typename T>
__device__ void ln_backward(const Plan& p, const RowsSmem<T>& sm, const T* __restrict__ src,
                            int64_t r0, const T* __restrict__ sc, const float* mu,
                            const float* inv, T* __restrict__ dx, float* vs, float* vb) {
  const int C = p.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < p.TR; r += kWarps) {
    const int64_t row = r0 + r;
    if (row >= p.N) continue;
    const float* ds = sm.dbuf + (size_t)r * p.ldc;
    const T* x = src + row * C;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = ds[c] * tof(sc[c]);
      const float xh = (tof(x[c]) - mu[r]) * inv[r];
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float dxh = ds[c] * tof(sc[c]);
      const float xh = (tof(x[c]) - mu[r]) * inv[r];
      dx[row * C + c] = fromf<T>(inv[r] * (dxh - m1 - xh * m2));
    }
  }
  const int nrows = (int)min((int64_t)p.TR, (int64_t)p.N - r0);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < nrows; ++r) {
      const float ds = sm.dbuf[(size_t)r * p.ldc + c];
      a += ds * ((tof(src[(r0 + r) * C + c]) - mu[r]) * inv[r]);
      b += ds;
    }
    vs[c] += a;
    vb[c] += b;
  }
  __syncthreads();
}

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

template <typename T>
__device__ void store_vec_partial(const Plan& p, const RowsSmem<T>& sm, float* part) {
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * p.C; i += kThreads)
    part[(size_t)blockIdx.x * 6 * p.C + i] = sm.vacc[i];
}

template <typename T>
__device__ void zero_vacc(const Plan& p, const RowsSmem<T>& sm) {
  for (int i = threadIdx.x; i < 6 * p.C; i += kThreads) sm.vacc[i] = 0.0f;
}

// K4: a = sigmoid(s @ Wag + bag) * (s @ Wap + bap) * m, b likewise.
template <typename T>
__global__ void __launch_bounds__(kThreads) prologue_fwd_kernel(RowArgs<T> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RowsSmem<T> sm;
  RowsSmem<T>::carve((uintptr_t)smem_raw, p, kProFwd, &sm);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int64_t r0 = (int64_t)tile * p.TR;
    ln_rows<T>(a.x, r0, p.N, p.TR, p.C, a.vec[0], a.vec[1], sm.s[0], p.lds, nullptr, nullptr);
    for (int r = threadIdx.x; r < p.TR; r += kThreads)
      sm.mrow[r] = r0 + r < p.N ? tof(a.aux[r0 + r]) : 0.0f;
    __syncthreads();
    for (int n0 = 0; n0 < p.C; n0 += p.TNK) {
      for (int h = 0; h < 2; ++h) {  // a, then b
        two_products<T>(p, sm, sm.s[0], sm.s[0], a.mat[2 * h], a.mat[2 * h + 1], n0);
        const T* bg = a.vec[2 + 2 * h];
        const T* bp = a.vec[3 + 2 * h];
        for (int e = threadIdx.x; e < p.TR * p.TNK; e += kThreads) {
          const int r = e / p.TNK, n = e % p.TNK;
          const int64_t row = r0 + r;
          if (row < p.N) {
            const float gate = sigmoidf(sm.st0[r * p.ldf + n] + tof(bg[n0 + n]));
            const float proj = sm.st1[r * p.ldf + n] + tof(bp[n0 + n]);
            a.out[h][row * p.C + n0 + n] = fromf<T>(gate * proj * sm.mrow[r]);
          }
        }
        __syncthreads();
      }
    }
  }
}

// K5 rows pass: dx through the LayerNorm, the cast dpre for the weight
// gradients, and the per-block column sums of the bias and LayerNorm grads.
template <typename T>
__global__ void __launch_bounds__(kThreads) prologue_bwd_kernel(RowArgs<T> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RowsSmem<T> sm;
  RowsSmem<T>::carve((uintptr_t)smem_raw, p, kProBwd, &sm);
  const int C = p.C;
  zero_vacc(p, sm);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int64_t r0 = (int64_t)tile * p.TR;
    const int nrows = (int)min((int64_t)p.TR, (int64_t)p.N - r0);
    ln_rows<T>(a.x, r0, p.N, p.TR, C, a.vec[0], a.vec[1], sm.s[0], p.lds, sm.mu[0], sm.inv[0]);
    for (int r = threadIdx.x; r < p.TR; r += kThreads)
      sm.mrow[r] = r0 + r < p.N ? tof(a.aux[r0 + r]) : 0.0f;
    __syncthreads();
    for (int n0 = 0; n0 < C; n0 += p.TNK) {
      for (int h = 0; h < 2; ++h) {  // (dag, dap), then (dbg, dbp)
        two_products<T>(p, sm, sm.s[0], sm.s[0], a.mat[2 * h], a.mat[2 * h + 1], n0);
        const T* bg = a.vec[2 + 2 * h];
        const T* bp = a.vec[3 + 2 * h];
        T* dg_g = a.dpre + (size_t)(2 * h) * p.N * C;
        T* dp_g = a.dpre + (size_t)(2 * h + 1) * p.N * C;
        for (int e = threadIdx.x; e < p.TR * p.TNK; e += kThreads) {
          const int r = e / p.TNK, n = e % p.TNK;
          const int64_t row = r0 + r;
          float dgate = 0.0f, dproj = 0.0f;
          if (row < p.N) {
            const float ct = tof(a.ct[h][row * C + n0 + n]) * sm.mrow[r];
            const float sg = sigmoidf(sm.st0[r * p.ldf + n] + tof(bg[n0 + n]));
            const float pj = sm.st1[r * p.ldf + n] + tof(bp[n0 + n]);
            dproj = ct * sg;
            dgate = ct * pj * sg * (1.0f - sg);
          }
          sm.st0[r * p.ldf + n] = dgate;
          sm.st1[r * p.ldf + n] = dproj;
          const T dg = fromf<T>(dgate), dp = fromf<T>(dproj);
          sm.d[2 * h][r * p.lds + n0 + n] = dg;
          sm.d[2 * h + 1][r * p.lds + n0 + n] = dp;
          if (row < p.N) {
            dg_g[row * C + n0 + n] = dg;
            dp_g[row * C + n0 + n] = dp;
          }
        }
        __syncthreads();
        col_sums(sm.st0, p.ldf, nrows, p.TNK, sm.vacc + (2 + 2 * h) * C + n0);
        col_sums(sm.st1, p.ldf, nrows, p.TNK, sm.vacc + (3 + 2 * h) * C + n0);
        __syncthreads();
      }
    }
    back_project<T>(p, sm, sm.d, a.mat, 4);
    ln_backward<T>(p, sm, a.x, r0, a.vec[0], sm.mu[0], sm.inv[0], a.out[0], sm.vacc, sm.vacc + C);
  }
  store_vec_partial(p, sm, a.vec_part);
}

// ---------------------------------------------------------------------------
// K5, resident-weight rows pass (bf16 C <= 128, float32 C <= 64)
// ---------------------------------------------------------------------------

constexpr int kResWarps = 8;  // warps a block; each walks 16-row tiles alone

// widths whose four weights fit in shared memory, with the rows' rings
template <typename T> struct ResMax;
template <> struct ResMax<bf16> { static constexpr int C = 128; };
template <> struct ResMax<float> { static constexpr int C = 64; };

// Row strides, in elements, of the weights and of the x rings.  Both keep
// rows 16-byte aligned; the weights' pad makes ldmatrix (bf16) and the
// hand-read tf32 fragments (float32) hit 32 distinct banks, the rings' pad
// the A-fragment reads of x.
__host__ __device__ inline int res_ldw(int C) { return C + 8; }
template <typename T> __host__ __device__ inline int res_ldx(int C) {
  return sizeof(T) == 2 ? C + 8 : C + 4;
}

// Shared memory of the resident pass: the four weights (C x ldw each,
// row-major (in, out)), the six vectors as f32, the block's column sums, and
// per warp a two-stage ring of 16 x rows.
template <typename T>
struct ResSmem {
  T* w;
  float* vec;   // lns, lnb, bag, bap, bbg, bbp
  float* vacc;  // the same six gradients' column sums
  T* xs;        // (kResWarps, 2, 16, ldx)

  __host__ __device__ static size_t carve(uintptr_t base, int C, ResSmem* out) {
    Carver cv{base, 0};
    ResSmem r{};
    r.w = (T*)cv.take(sizeof(T) * 4 * C * res_ldw(C));
    r.vec = (float*)cv.take(sizeof(float) * 6 * C);
    r.vacc = (float*)cv.take(sizeof(float) * 6 * C);
    r.xs = (T*)cv.take(sizeof(T) * kResWarps * 2 * 16 * res_ldx<T>(C));
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

// The weights into shared memory (cp.async, one group, not waited for) and
// the six vectors as f32; the column sums zeroed.
template <typename T>
__device__ void res_load_weights(const ResSmem<T>& sm, const RowArgs<T>& a, int C) {
  constexpr int E = 16 / (int)sizeof(T), NT = kResWarps * 32;
  const int ch = C / E, ldw = res_ldw(C);  // ch: 16-byte pieces a row
  for (int e = threadIdx.x; e < 4 * C * ch; e += NT) {
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

// LayerNorm backward of rows g, g + 8 of a tile from dsrc in C fragments (n8
// tile n of columns 8n + 2t, + 1): dx = inv (dxh - mean(dxh) - xhat
// mean(dxh xhat)), dxh = dsrc lns, stored for rows below N; the column sums of
// dsrc * xhat and dsrc go to slot (n % (CW / 8)) * 2 + e of the lane whose g
// is the chunk n / (CW / 8).
template <int CW, int NMAX, typename T>
__device__ __forceinline__ void res_ln_backward(const float (&ds)[NMAX][4], const T* xt, int ldx,
                                                const float* lns, const float (&mu)[2],
                                                const float (&inv)[2], int64_t r0, int N, int C,
                                                T* __restrict__ dx, float (&vs)[6][CW / 4]) {
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
    m1[rr] = quad_sum(s1[rr]) / C;
    m2[rr] = quad_sum(s2[rr]) / C;
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
          vs[0][2 * (n % PER) + e] += sx;
          vs[1][2 * (n % PER) + e] += sb;
        }
      }
    }
  }
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
template <typename T>
__global__ void prologue_bwd_resident_kernel(RowArgs<T> a, Plan p);

template <>
__global__ void __launch_bounds__(kResWarps * 32, 1)
prologue_bwd_resident_kernel<bf16>(RowArgs<bf16> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<bf16> sm;
  ResSmem<bf16>::carve((uintptr_t)smem_raw, p.C, &sm);
  constexpr int KMAX = ResMax<bf16>::C / 16;  // k16 steps, and 16-column chunks, at most
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<bf16>(C), nk = C / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kResWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kResWarps;
  bf16* const xs = sm.xs + (size_t)warp * 2 * 16 * ldx;

  res_load_weights(sm, a, C);
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

    // LayerNorm of rows g, g + 8 (f32 statistics, fast variance), s as A fragments
    float mu[2], inv[2], mrow[2];
    {
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
        mu[h] = quad_sum(sum[h]) / C;
        const float var = quad_sum(sq[h]) / C - mu[h] * mu[h];
        inv[h] = rsqrtf(var + kEps);
        const int64_t row = r0 + g + 8 * h;
        mrow[h] = row < p.N ? tof(a.aux[row]) : 0.0f;
      }
    }
    uint32_t sa[KMAX][4];
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      if (kk < nk) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 16 * kk + 8 * j + 2 * t;
            float v0, v1;
            load_pair(xt + (g + 8 * h) * ldx + c, v0, v1);
            sa[kk][2 * j + h] = pack_bf16((v0 - mu[h]) * inv[h] * lns[c] + lnb[c],
                                          (v1 - mu[h]) * inv[h] * lns[c + 1] + lnb[c + 1]);
          }
      }
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
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        if (kk < nk) {
          const int off = (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldw + n0 + (lane >> 4) * 8;
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) {
            uint32_t bw[4];
            ldsm_x4_trans(bw, sm.w + (size_t)w4 * C * ldw + off);
            mma_bf16(fwd[w4][0], sa[kk], bw[0], bw[1]);
            mma_bf16(fwd[w4][1], sa[kk], bw[2], bw[3]);
          }
        }
      }
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
    res_ln_backward<16>(ds, xt, ldx, lns, mu, inv, r0, p.N, C, a.out[0], vs);
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
template <>
__global__ void __launch_bounds__(kResWarps * 32, 1)
prologue_bwd_resident_kernel<float>(RowArgs<float> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ResSmem<float> sm;
  ResSmem<float>::carve((uintptr_t)smem_raw, p.C, &sm);
  constexpr int KMAX = ResMax<float>::C / 8;  // k8 steps, and 8-column chunks, at most
  const int C = p.C, ldw = res_ldw(C), ldx = res_ldx<float>(C), nk = C / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ntiles = ((int64_t)p.N + 15) / 16;
  const int64_t first = (int64_t)blockIdx.x * kResWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kResWarps;
  float* const xs = sm.xs + (size_t)warp * 2 * 16 * ldx;

  res_load_weights(sm, a, C);
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

    // LayerNorm of rows g, g + 8; s split into tf32 A fragments (big, small)
    float mu[2], inv[2], mrow[2];
    {
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
        mu[h] = quad_sum(sum[h]) / C;
        const float var = quad_sum(sq[h]) / C - mu[h] * mu[h];
        inv[h] = rsqrtf(var + kEps);
        const int64_t row = r0 + g + 8 * h;
        mrow[h] = row < p.N ? a.aux[row] : 0.0f;
      }
    }
    uint32_t sb[KMAX][4], ss[KMAX][4];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          const int h = i & 1, c = 8 * k + t + 4 * (i >> 1);
          split_tf32((xt[(g + 8 * h) * ldx + c] - mu[h]) * inv[h] * lns[c] + lnb[c], sb[k][i], ss[k][i]);
        }
      }
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
        float fg[4] = {}, fp[4] = {};
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < nk) {  // b0 = W[8k + t][n0 + g], b1 = W[8k + t + 4][n0 + g]
            const int off = (8 * k + t) * ldw + n0 + g;
            uint32_t bg[4], bp[4];
            split_tf32(wg[off], bg[0], bg[2]);
            split_tf32(wg[off + 4 * ldw], bg[1], bg[3]);
            split_tf32(wp[off], bp[0], bp[2]);
            split_tf32(wp[off + 4 * ldw], bp[1], bp[3]);
            mma_3xtf32(fg, sb[k], ss[k], bg);
            mma_3xtf32(fp, sb[k], ss[k], bp);
          }
        }
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
    res_ln_backward<8>(ds, xt, ldx, lns, mu, inv, r0, p.N, C, a.out[0], vs);
  }
  res_store_partial<8>(sm, vs, C, a.vec_part);
}

// K6: out = sigmoid(LN1(x) @ Wog + bog) * (LN2(prod) @ Wo + bo).
template <typename T>
__global__ void __launch_bounds__(kThreads) epilogue_fwd_kernel(RowArgs<T> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RowsSmem<T> sm;
  RowsSmem<T>::carve((uintptr_t)smem_raw, p, kEpiFwd, &sm);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int64_t r0 = (int64_t)tile * p.TR;
    ln_rows<T>(a.x, r0, p.N, p.TR, p.C, a.vec[0], a.vec[1], sm.s[0], p.lds, nullptr, nullptr);
    ln_rows<T>(a.aux, r0, p.N, p.TR, p.C, a.vec[3], a.vec[4], sm.s[1], p.lds, nullptr, nullptr);
    __syncthreads();
    for (int n0 = 0; n0 < p.C; n0 += p.TNK) {
      two_products<T>(p, sm, sm.s[0], sm.s[1], a.mat[0], a.mat[1], n0);
      for (int e = threadIdx.x; e < p.TR * p.TNK; e += kThreads) {
        const int r = e / p.TNK, n = e % p.TNK;
        const int64_t row = r0 + r;
        if (row < p.N) {
          const float g = sigmoidf(sm.st0[r * p.ldf + n] + tof(a.vec[2][n0 + n]));
          const float u = sm.st1[r * p.ldf + n] + tof(a.vec[5][n0 + n]);
          a.out[0][row * p.C + n0 + n] = fromf<T>(g * u);
        }
      }
      __syncthreads();
    }
  }
}

// K7 rows pass: dx and dprod through both LayerNorms, the cast dpre and du
// for the weight gradients, and the per-block column sums.
template <typename T>
__global__ void __launch_bounds__(kThreads) epilogue_bwd_kernel(RowArgs<T> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RowsSmem<T> sm;
  RowsSmem<T>::carve((uintptr_t)smem_raw, p, kEpiBwd, &sm);
  const int C = p.C;
  zero_vacc(p, sm);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int64_t r0 = (int64_t)tile * p.TR;
    const int nrows = (int)min((int64_t)p.TR, (int64_t)p.N - r0);
    ln_rows<T>(a.x, r0, p.N, p.TR, C, a.vec[0], a.vec[1], sm.s[0], p.lds, sm.mu[0], sm.inv[0]);
    ln_rows<T>(a.aux, r0, p.N, p.TR, C, a.vec[3], a.vec[4], sm.s[1], p.lds, sm.mu[1], sm.inv[1]);
    __syncthreads();
    T* dpre_g = a.dpre;
    T* du_g = a.dpre + (size_t)p.N * C;
    for (int n0 = 0; n0 < C; n0 += p.TNK) {
      two_products<T>(p, sm, sm.s[0], sm.s[1], a.mat[0], a.mat[1], n0);
      for (int e = threadIdx.x; e < p.TR * p.TNK; e += kThreads) {
        const int r = e / p.TNK, n = e % p.TNK;
        const int64_t row = r0 + r;
        float dpre = 0.0f, du = 0.0f;
        if (row < p.N) {
          const float g = sigmoidf(sm.st0[r * p.ldf + n] + tof(a.vec[2][n0 + n]));
          const float u = sm.st1[r * p.ldf + n] + tof(a.vec[5][n0 + n]);
          const float dout = tof(a.ct[0][row * C + n0 + n]);
          du = dout * g;
          dpre = dout * u * g * (1.0f - g);
        }
        sm.st0[r * p.ldf + n] = dpre;
        sm.st1[r * p.ldf + n] = du;
        const T dpc = fromf<T>(dpre), duc = fromf<T>(du);
        sm.d[0][r * p.lds + n0 + n] = dpc;
        sm.d[1][r * p.lds + n0 + n] = duc;
        if (row < p.N) {
          dpre_g[row * C + n0 + n] = dpc;
          du_g[row * C + n0 + n] = duc;
        }
      }
      __syncthreads();
      col_sums(sm.st0, p.ldf, nrows, p.TNK, sm.vacc + 2 * C + n0);
      col_sums(sm.st1, p.ldf, nrows, p.TNK, sm.vacc + 5 * C + n0);
      __syncthreads();
    }
    back_project<T>(p, sm, sm.d, a.mat, 1);
    ln_backward<T>(p, sm, a.x, r0, a.vec[0], sm.mu[0], sm.inv[0], a.out[0], sm.vacc, sm.vacc + C);
    back_project<T>(p, sm, sm.d + 1, a.mat + 1, 1);
    ln_backward<T>(p, sm, a.aux, r0, a.vec[3], sm.mu[1], sm.inv[1], a.out[1], sm.vacc + 3 * C,
                   sm.vacc + 4 * C);
  }
  store_vec_partial(p, sm, a.vec_part);
}

// Weight gradients, split over row chunks: block (chunk, job, tile) sums
// s^T @ d over its chunk's rows for one TM x TM tile of dW_job (TM = C up to
// 128), with s = LN(src) cast to T recomputed as the rows kernels computed
// it, once per row, 64 rows a step (fewer where C is wide); the step's rows
// of src and d come through a two-stage cp.async ring.  Products on mma.sync: bf16 m16n8k16 (ldmatrix.trans for both
// operands), float32 3xTF32 m16n8k8 with each step's product summed apart
// and added in f32 (the tensor cores truncate as they accumulate).  Warp
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
// slice of d.
template <typename T>
struct WgradSmem {
  T* s;
  T* x;  // (2, R, lds)
  T* d;  // (2, R, TM + kPadT)

  __host__ __device__ static size_t carve(uintptr_t base, const Plan& p, WgradSmem* out) {
    Carver cv{base, 0};
    WgradSmem r{};
    r.s = (T*)cv.take(sizeof(T) * p.wg_rows * p.lds);
    r.x = (T*)cv.take(sizeof(T) * 2 * p.wg_rows * p.lds);
    r.d = (T*)cv.take(sizeof(T) * 2 * p.wg_rows * (p.wg_tile + kPadT));
    if (out) *out = r;
    return cv.off;
  }
};

// acc (this warp's tiles) += s[:, m0:]^T @ d over R rows
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

__device__ __forceinline__ void wgrad_products(float (&acc)[kWgMi][2 * kWgNj][4], const float* s,
                                               int lds, const float* d, int ldd, int m0, int mt,
                                               int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradArgs<T> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WgradSmem<T> sm;
  WgradSmem<T>::carve((uintptr_t)smem_raw, p, &sm);
  const int C = p.C, R = p.wg_rows, TM = p.wg_tile, per = C / TM, mt = TM / 16;
  const int lds = p.lds, ldd = TM + kPadT;
  const int tile = blockIdx.x % p.tiles, job = (blockIdx.x / p.tiles) % p.njobs;
  const int chunk = blockIdx.x / (p.tiles * p.njobs);
  const int m0 = (tile / per) * TM, n0 = (tile % per) * TM;
  const int64_t rbeg = (int64_t)chunk * p.chunk_rows;
  const int64_t rend = min((int64_t)p.N, rbeg + p.chunk_rows);
  const T* x = a.src[job];
  const T* d = a.d[job];
  constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte piece
  const int xpieces = C / E, dpieces = TM / E;
  // rows [r0, r0 + R) of x and of d's columns [n0, n0 + TM) into ring stage
  // st, one group; rows past rend are zeros (their s is finite, their d 0)
  auto load = [&](int64_t r0, int st) {
    T* xd = sm.x + st * R * lds;
    T* dd = sm.d + st * R * ldd;
    for (int e = threadIdx.x; e < R * xpieces; e += kThreads) {
      const int r = e / xpieces, c = (e % xpieces) * E;
      if (r0 + r < rend) cp_async16(xd + r * lds + c, x + (r0 + r) * C + c);
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
    ln_smem_rows<T>(sm.x + st * R * lds, R, C, a.sc[job], a.bi[job], sm.s, lds);
    __syncthreads();
    wgrad_products(acc, sm.s, lds, sm.d + st * R * ldd, ldd, m0, mt, R);
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

}  // namespace

// ---------------------------------------------------------------------------
// host: plans and launches
// ---------------------------------------------------------------------------

namespace {

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
size_t rows_smem(const Plan& p, int kind) {
  return RowsSmem<T>::carve(0, p, kind, nullptr);
}

// Tiles, grids and scratch for one call.  Deterministic for a given device,
// kind, dtype, N and C, so the launch recomputes what the workspace query
// returned.  Returns kErrUnsupportedC when C is not a multiple of 16 or its
// tiles do not fit in shared memory.
template <typename T>
int make_plan(int device, int kind, int N, int C, Plan* out) {
  if (C < 16 || C % 16 != 0 || N < 0) return kErrUnsupportedC;
  Plan p{};
  p.N = N;
  p.C = C;
  p.TNK = C % 64 == 0 ? 64 : (C % 32 == 0 ? 32 : 16);
  p.lds = C + kPadT;
  p.ldw = p.TNK + kPadT;
  p.ldf = p.TNK + kPadF;
  p.ldc = C + kPadF;
  int TR = sizeof(T) == 2 ? 64 : 32;
  for (; TR >= 16; TR /= 2) {
    p.TR = TR;
    p.smem = rows_smem<T>(p, kind);
    if (p.smem <= kSmemLimit) break;
  }
  if (TR < 16) return kErrUnsupportedC;
  int nsm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  p.ntiles = (N + p.TR - 1) / p.TR;
  p.grid = p.ntiles < 2 * nsm ? p.ntiles : 2 * nsm;
  p.work_floats = 0;
  if (is_bwd(kind)) {
    p.njobs = n_dpre(kind);
    int units = 8;  // the output tile, in 16s: the largest divisor of C / 16 up to 8
    while ((C / 16) % units) --units;
    p.wg_tile = 16 * units;
    const int per = C / p.wg_tile;
    p.tiles = per * per;
    for (p.wg_rows = kWgRows; p.wg_rows >= 16; p.wg_rows /= 2) {
      p.wg_smem = WgradSmem<T>::carve(0, p, nullptr);
      if (p.wg_smem <= kSmemLimit) break;
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
    p.res_smem = ResSmem<T>::carve(0, C, nullptr);
    p.resident = kind == kProBwd && C <= ResMax<T>::C && p.res_smem <= kSmemLimit;
    if (p.resident) {  // one block an SM: its registers leave room for no second
      const long long need = ((long long)N + 16 * kResWarps - 1) / (16 * kResWarps);
      p.res_grid = (int)(need < nsm ? need : nsm);
    }
    const int vgrid = p.grid > p.res_grid ? p.grid : p.res_grid;
    p.work_floats = (long long)vgrid * 6 * C + (long long)p.chunks * p.njobs * C * C;
  }
  *out = p;
  return 0;
}

// Launch the rows kernel of `kind`, then (backward) the weight-gradient pass
// and the two reductions.  ptrs follow the C entry points' order after the
// dtype, N and C arguments.
template <typename T>
int run(int device, int kind, int N, int C, void* const* ptrs, cudaStream_t st) {
  Plan p;
  int rc = make_plan<T>(device, kind, N, C, &p);
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
  cudaError_t err;
  if (kind == kProFwd) {
    a.out[0] = (T*)rest[0];
    a.out[1] = (T*)rest[1];
    if ((err = set_smem(prologue_fwd_kernel<T>, p.smem)) != cudaSuccess) return (int)err;
    prologue_fwd_kernel<T><<<p.grid, kThreads, p.smem, st>>>(a, p);
    return (int)cudaGetLastError();
  }
  if (kind == kEpiFwd) {
    a.out[0] = (T*)rest[0];
    if ((err = set_smem(epilogue_fwd_kernel<T>, p.smem)) != cudaSuccess) return (int)err;
    epilogue_fwd_kernel<T><<<p.grid, kThreads, p.smem, st>>>(a, p);
    return (int)cudaGetLastError();
  }
  // backward: cotangents, grads of the rows, dvec (6, C), dmat (njobs, C, C),
  // dpre scratch (njobs, N, C), f32 workspace
  const int nct = pro ? 2 : 1, nout = pro ? 1 : 2;
  for (int i = 0; i < nct; ++i) a.ct[i] = (const T*)rest[i];
  for (int i = 0; i < nout; ++i) a.out[i] = (T*)rest[nct + i];
  T* dvec = (T*)rest[nct + nout];
  T* dmat = (T*)rest[nct + nout + 1];
  a.dpre = (T*)rest[nct + nout + 2];
  float* work = (float*)rest[nct + nout + 3];
  a.vec_part = work;
  // the weight-gradient pass copies the source rows in 16-byte pieces
  // (cp.async), K5's resident pass its weights too, and reads the cotangents
  // in pairs: the wrappers hand them over 16-byte aligned
  const T* need[] = {a.x, pro ? a.ct[0] : a.aux, a.ct[1], a.mat[0], a.mat[1], a.mat[2], a.mat[3]};
  for (int i = 0; i < (pro ? 7 : 2); ++i)
    if ((uintptr_t)need[i] % 16 != 0) return kErrBadArgs;
  int vgrid = p.grid;  // blocks that wrote vector partials
  if (pro) {
    if (p.resident) {
      if ((err = set_smem(prologue_bwd_resident_kernel<T>, p.res_smem)) != cudaSuccess) return (int)err;
      prologue_bwd_resident_kernel<T><<<p.res_grid, kResWarps * 32, p.res_smem, st>>>(a, p);
      vgrid = p.res_grid;
    } else {
      if ((err = set_smem(prologue_bwd_kernel<T>, p.smem)) != cudaSuccess) return (int)err;
      prologue_bwd_kernel<T><<<p.grid, kThreads, p.smem, st>>>(a, p);
    }
  } else {
    if ((err = set_smem(epilogue_bwd_kernel<T>, p.smem)) != cudaSuccess) return (int)err;
    epilogue_bwd_kernel<T><<<p.grid, kThreads, p.smem, st>>>(a, p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  WgradArgs<T> g{};
  for (int j = 0; j < p.njobs; ++j) {
    const bool second = !pro && j == 1;  // epilogue: dWo from LN2(prod)
    g.src[j] = second ? a.aux : a.x;
    g.sc[j] = second ? a.vec[3] : a.vec[0];
    g.bi[j] = second ? a.vec[4] : a.vec[1];
    g.d[j] = a.dpre + (size_t)j * N * C;
  }
  g.part = work + (size_t)(p.grid > p.res_grid ? p.grid : p.res_grid) * 6 * C;
  if ((err = set_smem(wgrad_kernel<T>, p.wg_smem)) != cudaSuccess) return (int)err;
  wgrad_kernel<T><<<p.chunks * p.njobs * p.tiles, kThreads, p.wg_smem, st>>>(g, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t mv = 6LL * C, mm = (int64_t)p.njobs * C * C;
  reduce_kernel<T><<<(int)((mv + 255) / 256), 256, 0, st>>>(work, vgrid, mv, dvec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<T><<<(int)((mm + 255) / 256), 256, 0, st>>>(g.part, p.chunks, mm, dmat);
  return (int)cudaGetLastError();
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

// Scratch that the backward of `kind` (0 K4, 1 K5, 2 K6, 3 K7) needs, in
// floats, for dtype (0 f32, 1 bf16) at N rows of width C.  Returns 0, or
// -1 when C is not supported.
extern "C" int ps_tri_workspace(int device, int kind, int dtype, int N, int C,
                                long long* work_floats) {
  Plan p;
  int rc = dtype == 0 ? make_plan<float>(device, kind, N, C, &p)
                      : (dtype == 1 ? make_plan<bf16>(device, kind, N, C, &p) : kErrBadArgs);
  if (rc == 0) *work_floats = p.work_floats;
  return rc;
}

// All tensors are contiguous, on `device`, in the stream dtype (0 f32, 1 bf16):
// rows (N, C), the mask (N,), vectors (C,), matrices (C, C) stored (in, out).
// Each launches on `stream` and returns 0 or a CUDA error code (-1: C not
// supported).

extern "C" int ps_tri_prologue_fwd(int device, int dtype, int N, int C, const void* x,
                                   const void* m, const void* lns, const void* lnb,
                                   const void* wag, const void* bag, const void* wap,
                                   const void* bap, const void* wbg, const void* bbg,
                                   const void* wbp, const void* bbp, void* a, void* b,
                                   void* stream) {
  void* const ptrs[] = {(void*)x, (void*)m, (void*)lns, (void*)lnb, (void*)wag, (void*)bag,
                        (void*)wap, (void*)bap, (void*)wbg, (void*)bbg, (void*)wbp, (void*)bbp,
                        a, b};
  return dispatch(device, kProFwd, dtype, N, C, ptrs, stream);
}

// dvec (6, C): lns, lnb, bag, bap, bbg, bbp; dmat (4, C, C): wag, wap, wbg,
// wbp; dpre: (4, N, C) scratch; work: ps_tri_workspace floats.
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
                                   void* stream) {
  void* const ptrs[] = {(void*)x, (void*)p, (void*)ln1s, (void*)ln1b, (void*)wog, (void*)bog,
                        (void*)ln2s, (void*)ln2b, (void*)wo, (void*)bo, out};
  return dispatch(device, kEpiFwd, dtype, N, C, ptrs, stream);
}

// dvec (6, C): ln1s, ln1b, bog, ln2s, ln2b, bo; dmat (2, C, C): wog, wo;
// dpre: (2, N, C) scratch; work: ps_tri_workspace floats.
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
