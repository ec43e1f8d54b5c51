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
// Matrix products run inside the kernels: bf16 through the tensor cores
// (nvcuda::wmma 16x16x16, f32 accumulators), f32 through FMA loops in full
// f32 (no TF32; the library is built with FMA contraction on).
//
// Design.  A block of 256 threads takes TR pair rows at a time (64 in bf16,
// 32 in f32, fewer where C is wide) and keeps them in shared memory as the
// LayerNorm output s (TR x C, T).  The (C, C) weights are streamed through
// shared memory in TNK x TNK chunks (TNK = 64, 32 or 16, dividing C), so no
// weight has to fit whole.  Each TR x TNK output chunk is staged in f32 in
// shared memory, where the gates, masks and casts are applied and the result
// is written out with coalesced stores.  Ragged rows past N are zeros in
// shared memory and are never stored.
//
// The Pallas backwards sum weight gradients into one block that the
// sequential TPU grid revisits.  Here blocks run in parallel, so:
//  * bias and LayerNorm gradients: each persistent block (grid fixed by the
//    SM count) sums its tiles' columns in shared memory and writes one f32
//    partial; a second kernel adds the partials in block order;
//  * weight gradients dW = s^T @ dpre: the rows kernel writes dpre (cast to
//    T) to a scratch buffer; a split-K kernel recomputes s from the pair
//    rows and sums s^T @ dpre over fixed row chunks into f32 partials; the
//    same reduction kernel adds the chunks in order.
// No atomics: the result is the same from run to run.
//
// What bounds it on an H100: at C = 128, bf16, the forwards read the pair
// rows once and write one or two (N, C) outputs (about 0.8 GB for K4 at
// N = 4*512*512) against 4 x 2NC^2 = 137 GFLOP of tensor-core work; both are
// well under a millisecond at the card's peaks, so what bounds this first
// version is the restaging of the weights through shared memory for every
// row tile and one resident block per SM in the backwards (their shared
// memory).  PERF.md has the times.  The kernels allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "device_scope.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-6f;
constexpr int kPadT = 8;     // row padding of T tiles, in elements
constexpr int kPadF = 4;     // row padding of f32 tiles, in floats
constexpr int kWgRows = 64;  // rows per step of the weight-gradient kernel
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
// block tile accumulators: acc (TR x TN, TR and TN multiples of 16, <= 64)
// += A (TR x K) @ B (K x TN).  A(m, k) is A[m*lda + k], or A[k*lda + m] when
// KMAJOR; B(k, n) is B[k*ldb + n].  All operands in shared memory.
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

  template <bool KMAJOR>
  __device__ void mma(const float* A, int lda, const float* B, int ldb, int K) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = i < mi ? (KMAJOR ? A[k * lda + ty + 16 * i] : A[(ty + 16 * i) * lda + k]) : 0.0f;
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

  template <bool KMAJOR>
  __device__ void mma(const bf16* A, int lda, const bf16* B, int ldb, int K) {
    using ALayout = typename std::conditional<KMAJOR, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = warp + kWarps * q;
      if (f < nfrag) {
        const int fm = f / fn_count, fn = f % fn_count;
        for (int k = 0; k < K; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, KMAJOR ? A + k * lda + fm * 16 : A + fm * 16 * lda + k, lda);
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
  int njobs, tiles, chunks, chunk_rows;  // weight-gradient kernel
  size_t wg_smem;
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

// Shared memory of the weight-gradient kernel: kWgRows LayerNorm'd rows
// (full C) and the matching kWgRows x TNK slice of dpre.
template <typename T>
__host__ __device__ size_t carve_wgrad(uintptr_t base, const Plan& p, T** srows, T** drows) {
  Carver cv{base, 0};
  T* s = (T*)cv.take(sizeof(T) * kWgRows * p.lds);
  T* d = (T*)cv.take(sizeof(T) * kWgRows * p.ldw);
  if (srows) *srows = s;
  if (drows) *drows = d;
  return cv.off;
}

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
    g.template mma<false>(s0 + k0, p.lds, sm.w0, p.ldw, p.TNK);
    q.template mma<false>(s1 + k0, p.lds, sm.w1, p.ldw, p.TNK);
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
        acc.template mma<false>(d[k] + k0, p.lds, sm.w0, p.ldw, p.TNK);
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

// Weight gradients, split over row chunks: block (chunk, tile, job) sums
// s^T @ d over its chunk's rows for one TNK x TNK tile of dW_job, with
// s = LN(src) cast to T recomputed as the rows kernels computed it.
template <typename T>
struct WgradArgs {
  const T* src[4];
  const T* sc[4];
  const T* bi[4];
  const T* d[4];
  float* part;  // (chunks, njobs, C, C)
};

template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradArgs<T> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* srows;
  T* drows;
  carve_wgrad<T>((uintptr_t)smem_raw, p, &srows, &drows);
  const int C = p.C, job = blockIdx.z;
  const int per = C / p.TNK;
  const int m0 = (blockIdx.y / per) * p.TNK, n0 = (blockIdx.y % per) * p.TNK;
  const int64_t rbeg = (int64_t)blockIdx.x * p.chunk_rows;
  const int64_t rend = min((int64_t)p.N, rbeg + p.chunk_rows);
  const T* d = a.d[job];
  TileAcc<T> acc;
  acc.init(p.TNK, p.TNK);
  for (int64_t r0 = rbeg; r0 < rend; r0 += kWgRows) {
    ln_rows<T>(a.src[job], r0, rend, kWgRows, C, a.sc[job], a.bi[job], srows, p.lds, nullptr,
               nullptr);
    for (int e = threadIdx.x; e < kWgRows * p.TNK; e += kThreads) {
      const int r = e / p.TNK, n = e % p.TNK;
      const int64_t row = r0 + r;
      drows[r * p.ldw + n] = row < rend ? d[row * C + n0 + n] : fromf<T>(0.0f);
    }
    __syncthreads();
    acc.template mma<true>(srows + m0, p.lds, drows, p.ldw, kWgRows);
    __syncthreads();
  }
  acc.store(a.part + (((size_t)blockIdx.x * p.njobs + job) * C + m0) * C + n0, C);
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
    const int per = C / p.TNK;
    p.tiles = per * per;
    p.wg_smem = carve_wgrad<T>(0, p, nullptr, nullptr);
    if (p.wg_smem > kSmemLimit) return kErrUnsupportedC;
    const int max_chunks = (N + kWgRows - 1) / kWgRows;
    int want = (4 * nsm) / (p.tiles * p.njobs);
    if (want < 1) want = 1;
    const int chunks = want < max_chunks ? want : max_chunks;
    if (chunks > 0) {
      const int rows = (N + chunks - 1) / chunks;
      p.chunk_rows = (rows + kWgRows - 1) / kWgRows * kWgRows;
      p.chunks = (N + p.chunk_rows - 1) / p.chunk_rows;
    }
    p.work_floats = (long long)p.grid * 6 * C + (long long)p.chunks * p.njobs * C * C;
  }
  *out = p;
  return 0;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  if (pro) {
    if ((err = set_smem(prologue_bwd_kernel<T>, p.smem)) != cudaSuccess) return (int)err;
    prologue_bwd_kernel<T><<<p.grid, kThreads, p.smem, st>>>(a, p);
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
  g.part = work + (size_t)p.grid * 6 * C;
  if ((err = set_smem(wgrad_kernel<T>, p.wg_smem)) != cudaSuccess) return (int)err;
  wgrad_kernel<T><<<dim3(p.chunks, p.tiles, p.njobs), kThreads, p.wg_smem, st>>>(g, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t mv = 6LL * C, mm = (int64_t)p.njobs * C * C;
  reduce_kernel<T><<<(int)((mv + 255) / 256), 256, 0, st>>>(work, p.grid, mv, dvec);
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
