// Flash pair-bias attention, forward (K8) and backward (K9), for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the TPU kernels protstruc_tpu/ops/flash_attn.py: _fwd_kernel
// (:79, launched by _fwd_call at :145) and _bwd_kernel (:184, launched by
// _bwd_call at :309).  The op is softmax(q k^T * scale + bias) v over the
// keys that `kmask` allows, per (batch, head):
//
//   K8, one block per (b*h, tile of 64 query rows), 16 rows a warp:
//       loops over 64-key tiles with a running max m, denominator l and a
//       float32 accumulator (registers), then writes out = acc / l and
//       lse = m + log(l).  A query row with no allowed key writes zeros and
//       lse = +1e30, so K9 recomputes p = 0 there and every gradient through
//       the row is 0.  Masked logits use the finite sentinel -1e30, and p = 0
//       is selected for them (no exp of a masked logit is used).
//   K9, one block per (b*h, tile of 64 keys), 16 keys a warp: loops over
//       query tiles, recomputes p = exp(s - lse), accumulates dv += p^T dO
//       and dk += ds^T q * scale in registers (so no atomics: each block owns
//       its keys), and streams ds = p * (dp - delta) out in the bias's dtype
//       and layout.  delta = sum(dO * out) and dq = ds k * scale are plain
//       PyTorch outside the kernel, as in the JAX package.
//
// B*h runs along grid x (up to 2^31 - 1), the tiles along y, and at dh 256
// the two halves of the head dim along z (above 256 its 128-column blocks).
//
// Head dims.  Two routes.  "whole": built for dh 16, 32, 64, 128 and 256;
// the wrapper runs any dh up to 256 on the next of these, its q, k, v and dO
// zero-padded (the Pallas kernels take any dh as one block).  "chunked":
// every dh above 256, rounded up to 128 by the wrapper, runs the chunked
// kernels below (flash_fwd_chunked_kernel, flash_bwd_chunked_kernel), whose
// products over the head dim stream in chunks.  dh 256 (the [mfu-peak] width, node
// 2048 over 8 heads) fits neither tiles nor registers as dh 128 does:
// K8's f32 tiles would take 367,616 bytes of shared memory, K9's 284,160
// (a block may have 232,448), and a warp's f32 output accumulator alone is
// 128 registers a thread (K9's dk and dv 256).  So at dh 256 each block owns
// half of the head dim (blockIdx.z): K8 reads the whole of Q and K for
// q k^T but only its half of V, and writes its half of the output (the
// z = 0 block the lse); K9 reads all of K, V, Q and dO for s^T and dp^T,
// accumulates its half of dk and dv, and the z = 0 block writes ds.  The
// products over the head dim (q k^T, dO v^T) and the exps are done twice:
// a simple design that keeps dh 128's accumulators.  Q is read from shared
// memory at each k step (bf16 too).  float32 K8 keeps one stage of its K,
// V and bias ring (184,320 bytes), float32 K9 16-row query tiles (208,640);
// bf16 keeps two stages and 32-row tiles (154,624 and 144,896 bytes).
//
// Rounding points follow the TPU kernels: products accumulate in float32;
// p is cast to the value dtype before p v and p^T dO, ds to the query dtype
// before ds^T q; for float32 operands these casts are exact.  scale =
// 1/sqrt(dh) multiplies.
//
// Layouts.  q, k, v and dO are read through (batch, position, head) element
// strides with a contiguous head dim, so q, k, v can be views into one qkv
// projection.  bias is read through (b, h, i, j) strides and ds is written
// with the same strides, so the (B, L, L, H) output of the pair-bias Dense is
// read in place as (B, H, L, L) and no copy of it is made.  out, dk, dv are
// contiguous (B, L, H, dh); lse and delta contiguous (B, H, L).  Ragged L is
// masked inside the kernels; nothing is padded.
//
// What bounds K8 on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense).  At the
// [attn] shape (B=1, H=8, L=4096, dh=32, bf16, last 100 keys masked) it must
// read the 268 MB bias: 0.080 ms.  Its 17 GFLOP of products take 0.017 ms on
// the tensor cores, and its 134 M exps about 0.036 ms at the MUFU rate (16 a
// clock an SM), so the bias's bytes bound it.  At the FoldModel train shape
// (f32, B=4, H=4, dh=32, L=256) the work is 134 MFLOP and 4.5 MB: the bound
// is 2 us, and what the kernel takes is launch latency and how much of the
// card its few blocks occupy.  What the design does about each:
//
//   * Products on the tensor cores with mma.sync.  bf16: m16n8k16 with f32
//     accumulators; Q's A fragments are loaded once per block (ldmatrix), K's
//     B fragments with ldmatrix and V's with ldmatrix.trans.  The scores stay
//     in registers: two adjacent n8 C fragments of S are, cast to bf16 (the
//     JAX rounding point of p), the A fragment of one k16 step of p v.
//     float32: "3xTF32" on m16n8k8, x = big + small with big =
//     cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), acc += a_small b_big
//     + a_big b_small + a_big b_big (small terms first), which keeps the
//     float32 budget (one TF32 pass does not: tests/test_torch_flash_split.py).
//     tf32 fragments are read from shared memory by hand; the m16n8k8 A
//     fragment wants columns t and t+4 where the C fragment of S holds 2t and
//     2t+1, so p v runs its k index in the order (0, 2, 4, 6, 1, 3, 5, 7) of
//     each 8 keys, on p and on V alike, and p never leaves its registers.
//     Q's f32 fragments (big and small) are held in registers up to dh 64
//     and read from shared memory at each k step at dh 128.
//   * A two-stage cp.async ring of K, V and bias tiles in their own dtype:
//     tile j+1 is in flight while tile j is computed, with one
//     __syncthreads a tile.  16-byte cp.async.cg where the rows are 16-byte
//     aligned (q/k/v; the bias where bj == 1, as at [attn]); 4-byte cp.async
//     element by element for other float32 strides (the train shape's
//     permuted bias); register copies for other bf16 strides.  Rows and keys
//     past L are zero-filled, so a masked or ragged tile holds finite values.
//   * Tiles padded by 16 bytes a row: ldmatrix and the hand-read tf32
//     fragments hit 32 distinct banks.
//   * Block height: 64 query rows (4 warps).  The train shape gets 4 x 16 =
//     64 blocks and [attn] 512.  32-row blocks (128 blocks at the train
//     shape) ran 6% slower there (PERF.md).
//   * The softmax runs in base 2: logits times log2(e), p = exp2(x - m) (one
//     MUFU.EX2 each), lse = (m + log2 l) ln 2.  bf16 at dh <= 32 is held to
//     128 registers, so four 64-row blocks share an SM; with up to 154 it
//     was three, and [attn] took 0.44 ms instead of 0.23.
//   * float32 p v is summed a key tile at a time and added to o in float32:
//     the tensor cores truncate as they accumulate, and over all 4096 keys
//     of [attn] that drifted to 4e-5 of max|out|, past the budget.
//
// What bounds K9.  At [attn] it reads the 268 MB bias and writes the 268 MB
// ds: 0.16 ms.  Its four products (s, dp, dv, dk: 4 x 2 x 8 x 4096^2 x 32,
// about 34 GFLOP) take about 0.035 ms on the bf16 tensor cores, and its 134 M
// exps about 0.036 ms; on the FMA pipes the products alone took 3.3 ms
// (PERF.md).  At the train shape the bound is 4 us; there it is latency and
// the 64 blocks on 132 SMs.  The design mirrors K8's, transposed:
//
//   * Each warp owns 16 keys of the block's 64 and computes s^T = K Q^T and
//     dp^T = V dO^T, so that p^T and ds^T come out as C fragments whose rows
//     are its keys.  Packed to bf16 (the rounding points of p and ds), two
//     adjacent C fragments are the A fragment of one k16 step of dv += p^T dO
//     and dk += ds^T Q; float32 takes them in the k order (0, 2, 4, 6, 1, 3,
//     5, 7) as K8 does.  All four products run mma.sync: bf16 m16n8k16, f32
//     3xTF32 m16n8k8.
//   * K and V stay resident in shared memory for the block; their A
//     fragments are read at each use (ldmatrix, or by hand for tf32): held
//     in registers they cost occupancy.  Q, dO (B
//     fragments by ldmatrix, ldmatrix.trans, or by hand for tf32), the bias
//     tile, lse and delta of the next query tile arrive through a two-stage
//     cp.async ring in their own dtype, copied as K8 copies its tiles.
//   * ds goes out through shared memory: each thread writes its ds^T entries
//     over the bias entries it alone read, and after one barrier the block
//     stores the tile by rows, 16 bytes at a time where bj == 1 ([attn]),
//     element by element for other strides (the train shape's permuted bias).
//   * Query tiles of 64 rows (32 at dh 128, where dk and dv take 128
//     registers a thread).  float32 sums each query tile's dv and dk products
//     apart and adds them in float32, against the tensor cores' truncating
//     accumulation, as K8 does over keys.
//   * Rows past L read as zeros with lse pinned at +1e30, so p = 0 there; a
//     masked key is p = 0 by selection, once a block (its allowed flags are
//     held in registers).
//
// Registers a thread (-Xptxas -v, sm_90a; _build/libflash_attn-*.log), K8:
// bf16 dh 16/32/64/128: 128/126/173/236; float32: 165/249/255/255.  float32
// dh 64 and 128 spill 8 and 4 bytes a thread (no model of the repo runs
// them); the rest do not.  K9: bf16 128/128/238/255, float32 255 at every
// dh; bf16 dh 32 spills 132 bytes a thread (held to 128 registers for four
// blocks an SM, it runs faster at [attn] than unbounded:
// experiments/pair_tile_probe.py; PERF.md), the others 0-20 bytes.  dh
// 256: K8 bf16 223 (no spill), float32 255 (8 bytes spilled); K9 bf16 255
// (20 bytes), float32 255 (none).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "device_scope.cuh"
#include "mma.cuh"

namespace {

constexpr int kBK = 64;        // keys per tile (K8 and K9)
constexpr int kFwdWarps = 4;   // K8: warps a block, 16 query rows each
constexpr int kBwdWarps = 4;   // K9: warps a block, 16 keys each
constexpr float kNeg = -1e30f;
constexpr float kLseMasked = 1e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------------------
// Asynchronous copies into the tiles of K8 and K9 (cp.async, ldmatrix and
// mma.sync helpers are in mma.cuh)
// ---------------------------------------------------------------------------

// one element from a stride that 16-byte copies cannot take: a 4-byte
// cp.async for float32, a register copy for bf16 (cp.async has no 2-byte form)
__device__ __forceinline__ void copy_elem(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *dst = *src;
}

// rows [r0, r0 + ROWS) of a (position, head-dim) slab into a tile whose rows
// are DH elements plus 16 bytes apart; rows at or past L are zero
template <typename T, int DH, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long stride, int r0, int L,
                                          bool vec) {
  constexpr int RS = DH + 16 / (int)sizeof(T);
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T), CH = DH / E;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
      const int rr = e / CH, c = (e % CH) * E, r = r0 + rr;
      T* d = dst + rr * RS + c;
      if (r < L) cp_async16(d, src + r * stride + c);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DH; e += NT) {
      const int rr = e / DH, c = e % DH, r = r0 + rr;
      if (r < L) copy_elem(dst + rr * RS + c, src + r * stride + c);
      else dst[rr * RS + c] = from_f<T>(0.0f);
    }
  }
}

// the (BQ x 64) bias tile at (i0, j0) into a tile whose rows are 64 elements
// plus 16 bytes apart; entries outside L are zero.  vec: bj == 1 and rows
// 16-byte aligned
template <typename T, int BQ, int NT>
__device__ __forceinline__ void copy_bias(T* dst, const T* bias, long long bi, long long bj, int i0,
                                          int j0, int L, bool vec) {
  constexpr int BS = kBK + 16 / (int)sizeof(T);
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T), CH = kBK / E;
    for (int e = threadIdx.x; e < BQ * CH; e += NT) {
      const int rr = e / CH, c = (e % CH) * E, i = i0 + rr, j = j0 + c;
      T* d = dst + rr * BS + c;
      const T* s = bias + i * bi + j;
      if (i < L && j + E <= L) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int x = 0; x < E; ++x) d[x] = (i < L && j + x < L) ? s[x] : from_f<T>(0.0f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < BQ * kBK; e += NT) {
      const int rr = e / kBK, c = e % kBK, i = i0 + rr, j = j0 + c;
      if (i < L && j < L) copy_elem(dst + rr * BS + c, bias + i * bi + j * bj);
      else dst[rr * BS + c] = from_f<T>(0.0f);
    }
  }
}

// The head-dim columns of the output (K8) and of dk and dv (K9) one block
// owns: all of them up to dh 128; at dh 256 half, blockIdx.z choosing which,
// so that the accumulators stay at dh 128's registers (a 16-row tile's f32
// output over 256 columns alone is 128 registers a thread).  Both halves'
// blocks compute the whole q k^T (and K9 the whole dO v^T): the products over
// the head dim are computed twice, the softmax and its statistics come out
// the same in both.
template <int DH>
constexpr int owned_dim() { return DH > 128 ? 128 : DH; }

// ---------------------------------------------------------------------------
// A warp's steps, shared by the whole and the chunked route
// ---------------------------------------------------------------------------
//
// Fragments are mma.sync's m16n8: lane = 4g + t, and a C fragment holds
// columns 2t, 2t + 1 of row g (c 0, 1) and of row g + 8 (c 2, 3).

// c[nt] += A B^T over KS k steps (float32: k8, 3xTF32; bf16: k16): A the
// 16 rows of `at` from a_row, B the NR * 8 rows of `bt`, both R elements a
// row; c[nt] holds B's rows nt*8 + 2t, +1.  A's fragments are read at each
// k step (held in registers for the block, they cost occupancy).
template <typename T, int NR, int KS, int R>
__device__ __forceinline__ void mma_rows_t(float (&c)[NR][4], const T* at, const T* bt, int a_row,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ab[4], as[4];  // f32: big, small
    if constexpr (sizeof(T) == 4) {
      tf32_a_frag<R>(reinterpret_cast<const float*>(at), a_row + g, kk * 8, t, ab, as);
#pragma unroll
      for (int nt = 0; nt < NR; ++nt) {
        const float* r = reinterpret_cast<const float*>(bt) + (nt * 8 + g) * R + kk * 8 + t;
        uint32_t bf[4];
        split_tf32(r[0], bf[0], bf[2]);
        split_tf32(r[4], bf[1], bf[3]);
        mma_3xtf32(c[nt], ab, as, bf);
      }
    } else {
      ldsm_x4(ab, at + (a_row + ((lane >> 3) & 1) * 8 + (lane & 7)) * R + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NR / 2; ++np) {
        uint32_t f[4];  // b0, b1 of n8 tiles 2np and 2np + 1
        ldsm_x4(f, bt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * R + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(c[2 * np], ab, f[0], f[1]);
        mma_bf16(c[2 * np + 1], ab, f[2], f[3]);
      }
    }
  }
}

// acc[d] += P B: P the C fragments of a 16 x NP*8 product (p, or ds),
// rounded to T, B the NP * 8 rows of `bt` (R elements a row), its columns
// col0 .. col0 + 8 ND.  bf16: two adjacent C fragments packed are the A
// fragment of one k16 step.  float32: 3xTF32 on m16n8k8, whose A fragment
// wants columns t and t + 4 where the C fragment holds 2t and 2t + 1, so the
// k index runs in the order (0, 2, 4, 6, 1, 3, 5, 7) of each 8, on P and on
// B alike, and P never leaves its registers; the product is summed apart
// and added to acc in float32, against the tensor cores' truncating
// accumulation.
template <typename T, int NP, int ND, int R>
__device__ __forceinline__ void mma_p_rows(float (&acc)[ND][4], const float (&p)[NP][4], const T* bt,
                                           int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float ot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) {
        uint32_t pb[4], ps[4], bf[4];
        split_tf32(p[nt][0], pb[0], ps[0]);
        split_tf32(p[nt][2], pb[1], ps[1]);
        split_tf32(p[nt][1], pb[2], ps[2]);
        split_tf32(p[nt][3], pb[3], ps[3]);
        const float* r = reinterpret_cast<const float*>(bt) + (nt * 8 + 2 * t) * R + col0 + d * 8 + g;
        split_tf32(r[0], bf[0], bf[2]);
        split_tf32(r[R], bf[1], bf[3]);
        mma_3xtf32(ot, pb, ps, bf);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[d][x] += ot[x];
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NP / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t f[4];  // b0, b1 of column n8 tiles 2dp and 2dp + 1
        ldsm_x4_trans(f, bt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * R + col0 + dp * 16 +
                             (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, f[0], f[1]);
        mma_bf16(acc[2 * dp + 1], pa, f[2], f[3]);
      }
    }
  }
}

// K8's online softmax over one 64-key tile: sc holds q k^T of rows row0,
// row0 + 8 (n8 tile nt: keys nt*8 + 2t, +1).  Logits scaled, plus the bias
// tile's entries (rows BS elements apart), in base 2 (times log2 e, so that
// p = exp2(x - m) takes one MUFU.EX2); a key `allow` refuses stays at the
// sentinel with p = 0.  Leaves p in sc, brings the running max m and this
// thread's share of the denominator l up to the tile, and rescales o.
template <typename T, int BS, int NO>
__device__ __forceinline__ void online_softmax(float (&sc)[8][4], const T* sb, const bool* allow,
                                               int row0, int t, float scale, float (&m)[2],
                                               float (&l)[2], float (&o)[NO][4]) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    const bool ok0 = allow[c], ok1 = allow[c + 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float b0, b1;
      load_pair(sb + (row0 + 8 * hr) * BS + c, b0, b1);
      float& x0 = sc[nt][2 * hr];
      float& x1 = sc[nt][2 * hr + 1];
      x0 = ok0 ? (x0 * scale + b0) * kLog2e : kNeg;
      x1 = ok1 ? (x1 * scale + b1) * kLog2e : kNeg;
      mx[hr] = fmaxf(mx[hr], fmaxf(x0, x1));
    }
  }
  float alpha[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr]);
    alpha[hr] = exp2f(m[hr] - m_new);  // 1 while the row has seen no allowed key
    m[hr] = m_new;
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    const bool ok[2] = {allow[c], allow[c + 1]};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p = ok[x & 1] ? exp2f(sc[nt][x] - m[x >> 1]) : 0.0f;
      sc[nt][x] = p;
      l[x >> 1] += p;
    }
  }
#pragma unroll
  for (int d = 0; d < NO; ++d) {
    o[d][0] *= alpha[0];
    o[d][1] *= alpha[0];
    o[d][2] *= alpha[1];
    o[d][3] *= alpha[1];
  }
}

// K8's end: l summed over the row's four threads, out = o / l into the
// block's columns col0 .. col0 + 8 NO of rows i, i + 8 (contiguous (B, L, H,
// DH)), and the lse (row bh of (B*H, L)) where write_lse; a row with no allowed key writes zeros
// and lse = +1e30
template <typename T, int NO>
__device__ __forceinline__ void store_out(T* out, float* lse, const float (&o)[NO][4],
                                          const float (&m)[2], float (&l)[2], int row_i, int L, int bh,
                                          int b, int H, int h, int DH, int col0, int t,
                                          bool write_lse) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int i = row_i + 8 * hr;
    if (i < L) {
      const bool has_keys = l[hr] > 0.0f;
      T* orow = out + (((long long)b * L + i) * H + h) * DH + 2 * t;
      orow += col0;
#pragma unroll
      for (int d = 0; d < NO; ++d)
        store_pair(orow + d * 8, has_keys ? o[d][2 * hr] / l[hr] : 0.0f,
                   has_keys ? o[d][2 * hr + 1] / l[hr] : 0.0f);
      if (t == 0 && write_lse)
        lse[(long long)bh * L + i] = has_keys ? (m[hr] + log2f(l[hr])) * kLn2 : kLseMasked;
    }
  }
}

// K8's tiles: BQ query rows (16 a warp), a ring of two stages of K, V and
// bias for 64 keys each, every row padded by 16 bytes (a third stage did not
// help at [attn]; PERF.md).  V holds the block's DV columns.  float32 at dh
// 256 takes one stage: two (302,080 bytes) pass the 232,448 a block may have.
template <typename T, int DH>
struct FwdTiles {
  static constexpr int DV = owned_dim<DH>();
  static constexpr int STAGES = (sizeof(T) == 4 && DH > 128) ? 1 : 2;
  static constexpr int BQ = kFwdWarps * 16;
  static constexpr int RS = DH + 16 / (int)sizeof(T);   // Q, K tile row (elements)
  static constexpr int RV = DV + 16 / (int)sizeof(T);   // V tile row
  static constexpr int BS = kBK + 16 / (int)sizeof(T);  // bias tile row
  static constexpr int KV = kBK * RS + kBK * RV;         // K and V elements of one ring stage
  static constexpr int STAGE = KV + BQ * BS;            // elements of one ring stage
  static constexpr int SMEM_BYTES = (BQ * RS + STAGES * STAGE) * (int)sizeof(T);
};

// bf16 at dh <= 32 fits 128 registers a thread, so 16 warps share an SM;
// the rest take what they need (up to 255) at one block an SM
template <typename T, int DH>
__global__ void __launch_bounds__(kFwdWarps * 32, (sizeof(T) == 2 && DH <= 32) ? 16 / kFwdWarps : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ bias, const uint8_t* __restrict__ kmask, int H, int L,
                 float scale, Strides st, int vec_qkv, int vec_bias, T* __restrict__ out,
                 float* __restrict__ lse) {
  using Tiles = FwdTiles<T, DH>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = kFwdWarps * 32, BQ = Tiles::BQ, RS = Tiles::RS, BS = Tiles::BS;
  constexpr int DV = Tiles::DV, RV = Tiles::RV, STAGES = Tiles::STAGES;
  constexpr int STAGE = Tiles::STAGE;
  constexpr int NO = DV / 8;                     // n8 tiles of the block's output
  constexpr int QK = kF32 ? DH / 8 : DH / 16;    // k steps of q k^T
  // f32 dh 128 and 256, bf16 dh 256 read Q from shared memory
  constexpr bool kHoldQ = kF32 ? DH <= 64 : DH <= 128;
  constexpr int QH = kHoldQ ? QK : 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sq = reinterpret_cast<T*>(smem_raw);  // [BQ][RS]
  __shared__ bool sallow[2][kBK];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's rows of the tile: row0, row0 + 8
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const T* biasb = bias + b * st.bb + h * st.bh;
  const uint8_t* kmb = kmask + (long long)b * L;
  const int n_tiles = (L + kBK - 1) / kBK;
  // the block's first output column; its columns of V
  const int hd0 = DV < DH ? blockIdx.z * DV : 0;
  if constexpr (DV < DH) vb += hd0;

  auto stage_k = [&](int s) { return sq + BQ * RS + s * STAGE; };
  auto stage_v = [&](int s) { return sq + BQ * RS + s * STAGE + kBK * RS; };
  auto stage_b = [&](int s) { return sq + BQ * RS + s * STAGE + Tiles::KV; };
  auto load_tile = [&](int jt) {  // key tile jt into its ring stage, one cp.async group
    const int s = jt & (STAGES - 1), j0 = jt * kBK;
    copy_rows<T, DH, kBK, NT>(stage_k(s), kb, st.kl, j0, L, vec_qkv);
    copy_rows<T, DV, kBK, NT>(stage_v(s), vb, st.vl, j0, L, vec_qkv);
    copy_bias<T, BQ, NT>(stage_b(s), biasb, st.bi, st.bj, i0, j0, L, vec_bias);
    if (threadIdx.x < kBK) {
      const int j = j0 + threadIdx.x;
      sallow[s][threadIdx.x] = j < L && kmb[j] != 0;
    }
    cp_async_commit();
  };

  copy_rows<T, DH, BQ, NT>(sq, qb, st.ql, i0, L, vec_qkv);
  load_tile(0);  // Q rides in tile 0's group

  float o[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  // rows row0, row0 + 8: the running max (base 2) and this thread's keys' share of l
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  uint32_t qa[QH][4], qs[QH][4];                   // Q's A fragments (f32: big, small)

  for (int jt = 0; jt < n_tiles; ++jt) {
    cp_async_wait_all();
    __syncthreads();  // tile jt landed for all; stage (jt + 1) & 1's readers are done
    if constexpr (STAGES == 2) {
      if (jt + 1 < n_tiles) load_tile(jt + 1);
    }
    if constexpr (kHoldQ) {
      if (jt == 0) {
#pragma unroll
        for (int kk = 0; kk < QH; ++kk) {
          if constexpr (kF32) {
            tf32_a_frag<RS>(reinterpret_cast<const float*>(sq), warp * 16 + g, kk * 8, t, qa[kk],
                            qs[kk]);
          } else {
            ldsm_x4(qa[kk], sq + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS +
                                kk * 16 + (lane >> 4) * 8);
          }
        }
      }
    }
    const int s = jt & (STAGES - 1);
    const T* sk = stage_k(s);
    const T* sv = stage_v(s);
    const T* sb = stage_b(s);

    // S = Q K^T: n8 tile nt holds keys nt*8 + 2t, +1 of rows row0 (c 0, 1), row0 + 8 (c 2, 3)
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
    if constexpr (!kHoldQ) {  // f32 dh 128 and 256, bf16 dh 256: Q's A fragments from shared memory
      mma_rows_t<T, 8, QK, RS>(sc, sq, sk, warp * 16, lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < QK; ++kk) {
        if constexpr (kF32) {
          uint32_t ab[4], as[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) ab[x] = qa[kk][x], as[x] = qs[kk][x];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float* kr = reinterpret_cast<const float*>(sk) + (nt * 8 + g) * RS + kk * 8 + t;
            uint32_t bf[4];
            split_tf32(kr[0], bf[0], bf[2]);
            split_tf32(kr[4], bf[1], bf[3]);
            mma_3xtf32(sc[nt], ab, as, bf);
          }
        } else {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t kf[4];  // b0, b1 of n8 tiles 2np and 2np + 1
            ldsm_x4(kf, sk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
            mma_bf16(sc[2 * np], qa[kk], kf[0], kf[1]);
            mma_bf16(sc[2 * np + 1], qa[kk], kf[2], kf[3]);
          }
        }
      }
    }

    // logits in base 2 (times log2 e, so that p = exp2(x - m) takes one MUFU.EX2) and the
    // online softmax; masked keys stay at the sentinel with p = 0.  online_softmax's steps
    // written out: called, they moved this kernel's machine code (sass_diff)
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const bool ok0 = sallow[s][c], ok1 = sallow[s][c + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float b0, b1;
        load_pair(sb + (row0 + 8 * hr) * BS + c, b0, b1);
        float& x0 = sc[nt][2 * hr];
        float& x1 = sc[nt][2 * hr + 1];
        x0 = ok0 ? (x0 * scale + b0) * kLog2e : kNeg;
        x1 = ok1 ? (x1 * scale + b1) * kLog2e : kNeg;
        mx[hr] = fmaxf(mx[hr], fmaxf(x0, x1));
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = exp2f(m[hr] - m_new);  // 1 while the row has seen no allowed key
      m[hr] = m_new;
      l[hr] *= alpha[hr];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const bool ok[2] = {sallow[s][c], sallow[s][c + 1]};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p = ok[x & 1] ? exp2f(sc[nt][x] - m[x >> 1]) : 0.0f;
        sc[nt][x] = p;
        l[x >> 1] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V; float32 writes mma_p_rows' steps out, as the softmax above
    if constexpr (kF32) {
      // The tensor cores truncate as they accumulate: summed over all L keys
      // that drifts past the float32 budget (4e-5 of max|out| at L = 4096),
      // so each tile's p v is summed apart and added to o in float32.
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        float ot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          // k order (0, 2, 4, 6, 1, 3, 5, 7) of keys nt*8..: the C fragment as the A fragment
          uint32_t pb[4], ps[4], bf[4];
          split_tf32(sc[nt][0], pb[0], ps[0]);
          split_tf32(sc[nt][2], pb[1], ps[1]);
          split_tf32(sc[nt][1], pb[2], ps[2]);
          split_tf32(sc[nt][3], pb[3], ps[3]);
          const float* vr = reinterpret_cast<const float*>(sv) + (nt * 8 + 2 * t) * RV + d * 8 + g;
          split_tf32(vr[0], bf[0], bf[2]);
          split_tf32(vr[RV], bf[1], bf[3]);
          mma_3xtf32(ot, pb, ps, bf);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) o[d][x] += ot[x];
      }
    } else {
      mma_p_rows<T, 8, NO, RV>(o, sc, sv, 0, lane);
    }
    if constexpr (STAGES == 1) {
      if (jt + 1 < n_tiles) {
        __syncthreads();  // every warp is done with the one stage
        load_tile(jt + 1);
      }
    }
  }

  // at dh 256 the first half's block writes the lse
  store_out<T, NO>(out, lse, o, m, l, i0 + row0, L, bh, b, H, h, DH, hd0, t, hd0 == 0);
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

// K9's shared memory: the block's 64 keys of K and V (resident), then a ring
// of two stages, each one query tile: Q, dO, the (BQ x 64) bias tile (which
// carries ds on its way out), lse and delta.  Rows are padded by 16 bytes.
// float32 at dh 256 takes 16-row query tiles: 32 (284,160 bytes) pass the
// 232,448 a block may have.
template <typename T, int DH>
struct BwdTiles {
  static constexpr int DV = owned_dim<DH>();                     // dk and dv columns a block owns
  static constexpr int BQ = DH >= 128 ? (sizeof(T) == 4 && DH > 128 ? 16 : 32) : 64;  // query rows a tile
  static constexpr int RS = DH + 16 / (int)sizeof(T);             // K, V, Q, dO tile row
  static constexpr int BS = kBK + 16 / (int)sizeof(T);            // bias (ds) tile row
  static constexpr int KV_BYTES = 2 * kBK * RS * (int)sizeof(T);
  static constexpr int STAGE_T = 2 * BQ * RS + BQ * BS;           // elements of T a stage
  static constexpr int STAGE_BYTES = STAGE_T * (int)sizeof(T) + 2 * BQ * (int)sizeof(float);
  static constexpr int SMEM_BYTES = KV_BYTES + 2 * STAGE_BYTES;
};

// the (BQ x 64) ds tile at (i0, j0) out of a tile whose rows are 64 elements
// plus 16 bytes apart, entries outside L skipped.  vec: bj == 1 and rows
// 16-byte aligned
template <typename T, int BQ, int NT>
__device__ __forceinline__ void store_ds(T* ds, const T* src, long long bi, long long bj, int i0,
                                         int j0, int L, bool vec) {
  constexpr int BS = kBK + 16 / (int)sizeof(T);
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T), CH = kBK / E;
    for (int e = threadIdx.x; e < BQ * CH; e += NT) {
      const int rr = e / CH, c = (e % CH) * E, i = i0 + rr, j = j0 + c;
      if (i >= L) continue;
      const T* s = src + rr * BS + c;
      T* d = ds + i * bi + j;
      if (j + E <= L) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      } else {
        for (int x = 0; x < E && j + x < L; ++x) d[x] = s[x];
      }
    }
  } else {
    for (int e = threadIdx.x; e < BQ * kBK; e += NT) {
      const int rr = e / kBK, c = e % kBK, i = i0 + rr, j = j0 + c;
      if (i < L && j < L) ds[i * bi + j * bj] = src[rr * BS + c];
    }
  }
}

// lse and delta of query rows [i0, i0 + BQ) into sl[0, BQ) and sl[BQ, 2 BQ)
// (cp.async); rows past L get lse +1e30 and delta 0, so p = 0 there
template <int BQ, int NT>
__device__ __forceinline__ void copy_lse_delta(float* sl, const float* lseb, const float* deltab,
                                               int i0, int L) {
  for (int e = threadIdx.x; e < BQ; e += NT) {
    const int i = i0 + e;
    if (i < L) {
      cp_async4(sl + e, lseb + i);
      cp_async4(sl + BQ + e, deltab + i);
    } else {  // p = 0 on rows past L
      sl[e] = kLseMasked;
      sl[BQ + e] = 0.0f;
    }
  }
}

// K9's p^T = exp(s^T scale + bias - lse) of one query tile, in place of s^T
// (c 0, 1: key key0, queries nt*8 + 2t, +1; c 2, 3: key0 + 8), on the keys
// `allow` lets through.  The bias tile's rows are BS elements apart; lse is
// +1e30 on fully masked rows and rows past L, so p is exactly 0 there.
template <typename T, int NQ, int BS>
__device__ __forceinline__ void bwd_probs(float (&p)[NQ][4], const T* sb, const float* slse,
                                          const bool (&allow)[2], int key0, int t, float scale) {
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) {
    const int c = nt * 8 + 2 * t;
    float l0, l1;
    load_pair(slse + c, l0, l1);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const T* br = sb + c * BS + key0 + 8 * hr;
      const float x0 = (p[nt][2 * hr] * scale + to_f<T>(br[0]) - l0) * kLog2e;
      const float x1 = (p[nt][2 * hr + 1] * scale + to_f<T>(br[BS]) - l1) * kLog2e;
      p[nt][2 * hr] = allow[hr] ? exp2f(x0) : 0.0f;
      p[nt][2 * hr + 1] = allow[hr] ? exp2f(x1) : 0.0f;
    }
  }
}

// K9's ds^T = p^T (dp^T - delta), in place of dp^T
template <int NQ>
__device__ __forceinline__ void bwd_ds(float (&dsa)[NQ][4], const float (&p)[NQ][4],
                                       const float* sdelta, int t) {
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) {
    float d0, d1;
    load_pair(sdelta + nt * 8 + 2 * t, d0, d1);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      dsa[nt][2 * hr] = p[nt][2 * hr] * (dsa[nt][2 * hr] - d0);
      dsa[nt][2 * hr + 1] = p[nt][2 * hr + 1] * (dsa[nt][2 * hr + 1] - d1);
    }
  }
}

// K9's ds out: each thread writes its ds^T entries over the bias entries it
// alone read (sb, rows BS elements apart), then, after one barrier, the
// block stores the tile by rows (store_ds)
template <typename T, int BQ, int NT, int NQ>
__device__ __forceinline__ void ds_out(T* dsb, T* sb, const float (&dsa)[NQ][4], int key0, int t,
                                       long long bi, long long bj, int i0, int j0, int L, bool vec) {
  constexpr int BS = kBK + 16 / (int)sizeof(T);
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) {
    const int c = nt * 8 + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      T* br = sb + c * BS + key0 + 8 * hr;
      br[0] = from_f<T>(dsa[nt][2 * hr]);
      br[BS] = from_f<T>(dsa[nt][2 * hr + 1]);
    }
  }
  __syncthreads();
  store_ds<T, BQ, NT>(dsb, sb, bi, bj, i0, j0, L, vec);
}

// K9's end: the block's dk (times scale) and dv columns hd0 .. hd0 + 8 ND
// of keys j, j + 8, contiguous (B, L, H, DH)
template <typename T, int ND>
__device__ __forceinline__ void store_dkdv(T* dk, T* dv, const float (&dka)[ND][4],
                                           const float (&dva)[ND][4], int key_j, int L, int b, int H,
                                           int h, int DH, int hd0, int t, float scale) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = key_j + 8 * hr;
    if (j < L) {
      const long long o = (((long long)b * L + j) * H + h) * DH + hd0 + 2 * t;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        store_pair(dk + o + d * 8, dka[d][2 * hr] * scale, dka[d][2 * hr + 1] * scale);
        store_pair(dv + o + d * 8, dva[d][2 * hr], dva[d][2 * hr + 1]);
      }
    }
  }
}

// bf16 at dh <= 32 is held to 128 registers, so four blocks share an SM
// (bytes spill, and it is faster all the same); the rest take what they
// need (up to 255)
template <typename T, int DH>
__global__ void __launch_bounds__(kBwdWarps * 32, (sizeof(T) == 2 && DH <= 32) ? 4 : 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ bias, const uint8_t* __restrict__ kmask,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, int H, int L, float scale, Strides st,
                 int vec_qkv, int vec_bias, int vec_ds, T* __restrict__ ds, T* __restrict__ dk,
                 T* __restrict__ dv) {
  using Tiles = BwdTiles<T, DH>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = kBwdWarps * 32, BQ = Tiles::BQ, RS = Tiles::RS, BS = Tiles::BS;
  constexpr int DV = Tiles::DV;
  constexpr int NQ = BQ / 8;                      // n8 tiles of s^T: the query tile
  constexpr int ND = DV / 8;                      // n8 tiles of the block's dk, dv columns
  constexpr int KS = kF32 ? DH / 8 : DH / 16;     // k steps over the head dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sk = reinterpret_cast<T*>(smem_raw);  // [64][RS]
  T* const sv = sk + kBK * RS;                   // [64][RS]
  auto stage = [&](int s) { return smem_raw + Tiles::KV_BYTES + s * Tiles::STAGE_BYTES; };
  auto stage_q = [&](int s) { return reinterpret_cast<T*>(stage(s)); };                   // [BQ][RS]
  auto stage_g = [&](int s) { return reinterpret_cast<T*>(stage(s)) + BQ * RS; };         // [BQ][RS]
  auto stage_b = [&](int s) { return reinterpret_cast<T*>(stage(s)) + 2 * BQ * RS; };     // [BQ][BS]
  auto stage_l = [&](int s) {  // lse [BQ], then delta [BQ]
    return reinterpret_cast<float*>(stage(s) + Tiles::STAGE_T * (int)sizeof(T));
  };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = warp * 16 + g;  // this thread's keys of the tile: key0, key0 + 8
  const T* qb = q + b * st.qb + h * st.qh;
  const T* gb = dout + b * st.gb + h * st.gh;
  const T* biasb = bias + b * st.bb + h * st.bh;
  T* dsb = ds + b * st.bb + h * st.bh;
  const float* lseb = lse + (long long)bh * L;
  const float* deltab = delta + (long long)bh * L;
  const int n_tiles = (L + BQ - 1) / BQ;
  const int hd0 = DV < DH ? blockIdx.z * DV : 0;  // the block's first dk, dv column

  auto load_tile = [&](int it) {  // query tile it into ring stage it & 1, one cp.async group
    const int s = it & 1, i0 = it * BQ;
    copy_rows<T, DH, BQ, NT>(stage_q(s), qb, st.ql, i0, L, vec_qkv);
    copy_rows<T, DH, BQ, NT>(stage_g(s), gb, st.gl, i0, L, vec_qkv);
    copy_bias<T, BQ, NT>(stage_b(s), biasb, st.bi, st.bj, i0, j0, L, vec_bias);
    copy_lse_delta<BQ, NT>(stage_l(s), lseb, deltab, i0, L);
    cp_async_commit();
  };

  copy_rows<T, DH, kBK, NT>(sk, k + b * st.kb + h * st.kh, st.kl, j0, L, vec_qkv);
  copy_rows<T, DH, kBK, NT>(sv, v + b * st.vb + h * st.vh, st.vl, j0, L, vec_qkv);
  load_tile(0);  // K and V ride in tile 0's group

  const uint8_t* kmb = kmask + (long long)b * L;
  bool allow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j0 + key0 + 8 * hr;
    allow[hr] = j < L && kmb[j] != 0;
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int x = 0; x < 4; ++x) dka[d][x] = dva[d][x] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed for all; stage (it + 1) & 1's ds is out
    if (it + 1 < n_tiles) load_tile(it + 1);
    const int s = it & 1, i0 = it * BQ;
    const T* sq = stage_q(s);
    const T* sg = stage_g(s);
    T* sb = stage_b(s);
    const float* sl = stage_l(s);

    // p^T = exp(s^T - lse), s^T = K Q^T
    float p[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
    mma_rows_t<T, NQ, KS, RS>(p, sk, sq, warp * 16, lane);
    bwd_probs<T, NQ, BS>(p, sb, sl, allow, key0, t, scale);
    mma_p_rows<T, NQ, ND, RS>(dva, p, sg, hd0, lane);  // dv += p^T dO, p in dO's dtype

    // ds^T = p^T (dp^T - delta), dp^T = V dO^T
    float dsa[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) dsa[nt][0] = dsa[nt][1] = dsa[nt][2] = dsa[nt][3] = 0.0f;
    mma_rows_t<T, NQ, KS, RS>(dsa, sv, sg, warp * 16, lane);
    bwd_ds<NQ>(dsa, p, sl + BQ, t);
    mma_p_rows<T, NQ, ND, RS>(dka, dsa, sq, hd0, lane);  // dk += ds^T Q, ds in q's dtype

    // ds out, by the blocks of the first dk, dv columns
    if (hd0 == 0) ds_out<T, BQ, NT, NQ>(dsb, sb, dsa, key0, t, st.bi, st.bj, i0, j0, L, vec_ds);
  }

  store_dkdv<T, ND>(dk, dv, dka, dva, j0 + key0, L, b, H, h, DH, hd0, t, scale);
}

// ---------------------------------------------------------------------------
// The chunked route: K8 and K9 at every head dim above 256
// ---------------------------------------------------------------------------
//
// Above dh 256 whole-dh rows of Q and K (K9: also of V and dO) no longer fit
// a block's shared memory beside the rest (float32 K8 at dh 512 would take
// 315,392 bytes, bf16 K9 at dh 1024 264,192 for K and V alone), so the
// products over the head dim run in chunks of 128 bytes a row (64 bf16 or 32
// float32 columns) that stream through a two-stage cp.async ring, and shared
// memory does not grow with dh.  The wrapper hands in dh rounded up to 128
// (zero-padded); the kernels take it as a runtime argument.  Each block owns
// 128 columns of the output (K9: of dk and dv), blockIdx.z choosing which, as
// the dh 256 build owns half; every block of a row recomputes the whole
// q k^T (K9: and dO v^T), so at dh D the products over the head dim are done
// D / 128 times.  A simple design that keeps dh 128's accumulators.
//
//   K8: for each 64-key tile, s = sum over chunks c of q_c k_c^T in
//       registers, then the bias, the key mask, the sentinel and the online
//       softmax as the whole route does, and o += p v over the block's 128
//       columns of V.  Ring items are (key tile, chunk): Q's and K's chunk; an
//       item that starts a key tile also brings V's 128 columns, the bias
//       tile and the allowed flags, double-buffered by key tile.
//   K9: for each query tile, s^T = sum_c K_c Q_c^T and dp^T = sum_c V_c dO_c^T
//       (K and V now stream too), then p, dv += p^T dO_owned, ds, dk +=
//       ds^T q_owned, ds out by the z = 0 blocks.  Ring items are (query
//       tile, chunk): K's, V's, Q's and dO's chunk; an item that starts a
//       query tile also brings the block's 128 columns of Q and dO, the bias
//       tile, lse and delta.
//
// K8 in float32 and K9 in both dtypes sum each chunk's product apart and add
// it in float32, against the tensor cores' truncating accumulation over long
// head dims (as K8 sums p v a key tile at a time; mma_rows_t_chunk).
constexpr int kChunkBytes = 128;  // bytes of a row a head-dim chunk holds
constexpr int kOwned = 128;       // output (K8) or dk, dv (K9) columns a block owns

// mma_rows_t over one head-dim chunk.  With APART the chunk's product is
// summed apart and added to c in float32, against the tensor cores'
// truncating accumulation over long head dims: K8 does so in float32, K9 in
// both dtypes (its dp^T feeds ds = p (dp - delta), a difference of near
// numbers)
template <bool APART, typename T, int NR, int KS, int R>
__device__ __forceinline__ void mma_rows_t_chunk(float (&c)[NR][4], const T* at, const T* bt,
                                                 int a_row, int lane) {
  if constexpr (APART) {
    float ct[NR][4];
#pragma unroll
    for (int nt = 0; nt < NR; ++nt) ct[nt][0] = ct[nt][1] = ct[nt][2] = ct[nt][3] = 0.0f;
    mma_rows_t<T, NR, KS, R>(ct, at, bt, a_row, lane);
#pragma unroll
    for (int nt = 0; nt < NR; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) c[nt][x] += ct[nt][x];
  } else {
    mma_rows_t<T, NR, KS, R>(c, at, bt, a_row, lane);
  }
}

template <typename T>
struct ChunkedFwdTiles {
  static constexpr int DC = kChunkBytes / (int)sizeof(T);  // head-dim columns a chunk
  static constexpr int BQ = kFwdWarps * 16;
  static constexpr int RC = DC + 16 / (int)sizeof(T);      // Q, K chunk row
  static constexpr int RV = kOwned + 16 / (int)sizeof(T);  // V tile row
  static constexpr int BS = kBK + 16 / (int)sizeof(T);     // bias tile row
  static constexpr int CHUNK = BQ * RC + kBK * RC;         // elements of a chunk stage
  static constexpr int TILE = kBK * RV + BQ * BS;          // elements of a key tile's stage
  static constexpr int SMEM_BYTES = 2 * (CHUNK + TILE) * (int)sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
flash_fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ bias, const uint8_t* __restrict__ kmask, int H, int L,
                         int DH, float scale, Strides st, int vec_qkv, int vec_bias,
                         T* __restrict__ out, float* __restrict__ lse) {
  using Tiles = ChunkedFwdTiles<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = kFwdWarps * 32, BQ = Tiles::BQ, DC = Tiles::DC, RC = Tiles::RC;
  constexpr int RV = Tiles::RV, BS = Tiles::BS;
  constexpr int NO = kOwned / 8;                 // n8 tiles of the block's output
  constexpr int KC = kF32 ? DC / 8 : DC / 16;    // k steps of a chunk

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const base = reinterpret_cast<T*>(smem_raw);
  __shared__ bool sallow[2][kBK];
  auto chunk_q = [&](int s) { return base + s * Tiles::CHUNK; };                // [BQ][RC]
  auto chunk_k = [&](int s) { return base + s * Tiles::CHUNK + BQ * RC; };      // [64][RC]
  auto tile_v = [&](int u) { return base + 2 * Tiles::CHUNK + u * Tiles::TILE; };  // [64][RV]
  auto tile_b = [&](int u) { return base + 2 * Tiles::CHUNK + u * Tiles::TILE + kBK * RV; };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * BQ;
  const int hd0 = blockIdx.z * kOwned;  // the block's first output column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's rows of the tile: row0, row0 + 8
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh + hd0;
  const T* biasb = bias + b * st.bb + h * st.bh;
  const uint8_t* kmb = kmask + (long long)b * L;
  const int n_chunks = DH / DC, n_tiles = (L + kBK - 1) / kBK, n_items = n_tiles * n_chunks;

  auto load_item = [&](int n) {  // (key tile, chunk) n into ring stage n & 1, one cp.async group
    const int jt = n / n_chunks, c = n - jt * n_chunks, s = n & 1, j0 = jt * kBK;
    copy_rows<T, DC, BQ, NT>(chunk_q(s), qb + c * DC, st.ql, i0, L, vec_qkv);
    copy_rows<T, DC, kBK, NT>(chunk_k(s), kb + c * DC, st.kl, j0, L, vec_qkv);
    if (c == 0) {  // the key tile's V columns, bias and allowed flags
      const int u = jt & 1;
      copy_rows<T, kOwned, kBK, NT>(tile_v(u), vb, st.vl, j0, L, vec_qkv);
      copy_bias<T, BQ, NT>(tile_b(u), biasb, st.bi, st.bj, i0, j0, L, vec_bias);
      if (threadIdx.x < kBK) {
        const int j = j0 + threadIdx.x;
        sallow[u][threadIdx.x] = j < L && kmb[j] != 0;
      }
    }
    cp_async_commit();
  };

  load_item(0);
  float o[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float sc[8][4];  // S = Q K^T of the key tile, summed over chunks (layout as in K8)

  for (int n = 0; n < n_items; ++n) {
    const int jt = n / n_chunks, c = n - jt * n_chunks;
    cp_async_wait_all();
    __syncthreads();  // item n landed for all; stage (n + 1) & 1's readers are done
    if (n + 1 < n_items) load_item(n + 1);
    if (c == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
    }
    mma_rows_t_chunk<kF32, T, 8, KC, RC>(sc, chunk_q(n & 1), chunk_k(n & 1), warp * 16, lane);
    if (c != n_chunks - 1) continue;

    // the key tile's logits are whole: the online softmax and p v, as K8's
    const int u = jt & 1;
    online_softmax<T, BS, NO>(sc, tile_b(u), sallow[u], row0, t, scale, m, l, o);
    mma_p_rows<T, 8, NO, RV>(o, sc, tile_v(u), 0, lane);
  }

  // the first columns' block writes the lse
  store_out<T, NO>(out, lse, o, m, l, i0 + row0, L, bh, b, H, h, DH, hd0, t, blockIdx.z == 0);
}

// K9's chunked shared memory: a ring of two stages of (query tile, chunk)
// items, K's, V's, Q's and dO's chunk, then two stages of a query tile's
// own data: Q's and dO's 128 owned columns, the bias tile (which carries ds
// out), lse and delta.  float32 takes 16-row query tiles, bf16 32, as the dh
// 256 build (the dk and dv accumulators of 128 columns leave no registers
// for more).
template <typename T>
struct ChunkedBwdTiles {
  static constexpr int DC = kChunkBytes / (int)sizeof(T);
  static constexpr int BQ = sizeof(T) == 4 ? 16 : 32;
  static constexpr int RC = DC + 16 / (int)sizeof(T);      // K, V, Q, dO chunk row
  static constexpr int RO = kOwned + 16 / (int)sizeof(T);  // owned Q, dO row
  static constexpr int BS = kBK + 16 / (int)sizeof(T);     // bias (ds) tile row
  static constexpr int CHUNK = 2 * kBK * RC + 2 * BQ * RC;  // elements of a chunk stage
  static constexpr int TILE_T = 2 * BQ * RO + BQ * BS;      // elements of T of a tile stage
  static constexpr int TILE_BYTES = TILE_T * (int)sizeof(T) + 2 * BQ * (int)sizeof(float);
  static constexpr int SMEM_BYTES = 2 * CHUNK * (int)sizeof(T) + 2 * TILE_BYTES;
};

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
flash_bwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ bias, const uint8_t* __restrict__ kmask,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, int H, int L, int DH, float scale,
                         Strides st, int vec_qkv, int vec_bias, int vec_ds, T* __restrict__ ds,
                         T* __restrict__ dk, T* __restrict__ dv) {
  using Tiles = ChunkedBwdTiles<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = kBwdWarps * 32, BQ = Tiles::BQ, DC = Tiles::DC, RC = Tiles::RC;
  constexpr int RO = Tiles::RO, BS = Tiles::BS;
  constexpr int NQ = BQ / 8;                      // n8 tiles of s^T: the query tile
  constexpr int ND = kOwned / 8;                  // n8 tiles of the block's dk, dv columns
  constexpr int KC = kF32 ? DC / 8 : DC / 16;     // k steps of a chunk

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const base = reinterpret_cast<T*>(smem_raw);
  auto chunk_k = [&](int s) { return base + s * Tiles::CHUNK; };                          // [64][RC]
  auto chunk_v = [&](int s) { return base + s * Tiles::CHUNK + kBK * RC; };               // [64][RC]
  auto chunk_q = [&](int s) { return base + s * Tiles::CHUNK + 2 * kBK * RC; };           // [BQ][RC]
  auto chunk_g = [&](int s) { return base + s * Tiles::CHUNK + 2 * kBK * RC + BQ * RC; }; // [BQ][RC]
  auto tile = [&](int u) { return smem_raw + 2 * Tiles::CHUNK * (int)sizeof(T) + u * Tiles::TILE_BYTES; };
  auto tile_q = [&](int u) { return reinterpret_cast<T*>(tile(u)); };                     // [BQ][RO]
  auto tile_g = [&](int u) { return reinterpret_cast<T*>(tile(u)) + BQ * RO; };           // [BQ][RO]
  auto tile_b = [&](int u) { return reinterpret_cast<T*>(tile(u)) + 2 * BQ * RO; };       // [BQ][BS]
  auto tile_l = [&](int u) {  // lse [BQ], then delta [BQ]
    return reinterpret_cast<float*>(tile(u) + Tiles::TILE_T * (int)sizeof(T));
  };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * kBK;
  const int hd0 = blockIdx.z * kOwned;  // the block's first dk, dv column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = warp * 16 + g;  // this thread's keys of the tile: key0, key0 + 8
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const T* gb = dout + b * st.gb + h * st.gh;
  const T* biasb = bias + b * st.bb + h * st.bh;
  T* dsb = ds + b * st.bb + h * st.bh;
  const float* lseb = lse + (long long)bh * L;
  const float* deltab = delta + (long long)bh * L;
  const int n_chunks = DH / DC, n_tiles = (L + BQ - 1) / BQ, n_items = n_tiles * n_chunks;

  auto load_item = [&](int n) {  // (query tile, chunk) n into ring stage n & 1, one cp.async group
    const int it = n / n_chunks, c = n - it * n_chunks, s = n & 1, i0 = it * BQ;
    copy_rows<T, DC, kBK, NT>(chunk_k(s), kb + c * DC, st.kl, j0, L, vec_qkv);
    copy_rows<T, DC, kBK, NT>(chunk_v(s), vb + c * DC, st.vl, j0, L, vec_qkv);
    copy_rows<T, DC, BQ, NT>(chunk_q(s), qb + c * DC, st.ql, i0, L, vec_qkv);
    copy_rows<T, DC, BQ, NT>(chunk_g(s), gb + c * DC, st.gl, i0, L, vec_qkv);
    if (c == 0) {  // the query tile's owned columns, bias, lse and delta
      const int u = it & 1;
      copy_rows<T, kOwned, BQ, NT>(tile_q(u), qb + hd0, st.ql, i0, L, vec_qkv);
      copy_rows<T, kOwned, BQ, NT>(tile_g(u), gb + hd0, st.gl, i0, L, vec_qkv);
      copy_bias<T, BQ, NT>(tile_b(u), biasb, st.bi, st.bj, i0, j0, L, vec_bias);
      copy_lse_delta<BQ, NT>(tile_l(u), lseb, deltab, i0, L);
    }
    cp_async_commit();
  };

  load_item(0);

  const uint8_t* kmb = kmask + (long long)b * L;
  bool allow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j0 + key0 + 8 * hr;
    allow[hr] = j < L && kmb[j] != 0;
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int x = 0; x < 4; ++x) dka[d][x] = dva[d][x] = 0.0f;
  float p[NQ][4], dsa[NQ][4];  // s^T, then p^T; dp^T, then ds^T

  for (int n = 0; n < n_items; ++n) {
    const int it = n / n_chunks, c = n - it * n_chunks;
    cp_async_wait_all();
    __syncthreads();  // item n landed for all; stage (n + 1) & 1's readers are done
    if (n + 1 < n_items) load_item(n + 1);
    if (c == 0) {
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) p[nt][x] = dsa[nt][x] = 0.0f;
    }
    const int s = n & 1;
    mma_rows_t_chunk<true, T, NQ, KC, RC>(p, chunk_k(s), chunk_q(s), warp * 16, lane);
    mma_rows_t_chunk<true, T, NQ, KC, RC>(dsa, chunk_v(s), chunk_g(s), warp * 16, lane);
    if (c != n_chunks - 1) continue;

    // s^T and dp^T are whole: p, dv, ds and dk as K9's
    const int u = it & 1, i0 = it * BQ;
    T* sb = tile_b(u);
    const float* sl = tile_l(u);
    bwd_probs<T, NQ, BS>(p, sb, sl, allow, key0, t, scale);
    mma_p_rows<T, NQ, ND, RO>(dva, p, tile_g(u), 0, lane);  // dv += p^T dO, p in dO's dtype
    bwd_ds<NQ>(dsa, p, sl + BQ, t);
    mma_p_rows<T, NQ, ND, RO>(dka, dsa, tile_q(u), 0, lane);  // dk += ds^T Q, ds in q's dtype
    if (blockIdx.z == 0) ds_out<T, BQ, NT, NQ>(dsb, sb, dsa, key0, t, st.bi, st.bj, i0, j0, L, vec_ds);
  }

  store_dkdv<T, ND>(dk, dv, dka, dva, j0 + key0, L, b, H, h, DH, hd0, t, scale);
}

Strides make_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                 s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
}


bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// every stride a multiple of 16 bytes
bool strides16(std::initializer_list<long long> strides, int esize) {
  for (long long s : strides)
    if ((s * esize) % 16 != 0) return false;
  return true;
}

template <typename T, int DH>
int fwd(int B, int H, int L, float scale, const void* q, const void* k, const void* v,
        const void* bias, const uint8_t* kmask, const Strides& st, void* out, float* lse,
        cudaStream_t stream) {
  using Tiles = FwdTiles<T, DH>;
  const int smem = Tiles::SMEM_BYTES;
  const int esize = (int)sizeof(T);
  const int vec_qkv = aligned16(q) && aligned16(k) && aligned16(v) &&
                      strides16({st.qb, st.ql, st.qh, st.kb, st.kl, st.kh, st.vb, st.vl, st.vh},
                                esize);
  const int vec_bias = st.bj == 1 && aligned16(bias) && strides16({st.bb, st.bh, st.bi}, esize);
  auto kern = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (L + Tiles::BQ - 1) / Tiles::BQ, DH / Tiles::DV);
  kern<<<grid, kFwdWarps * 32, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                               (const T*)bias, kmask, H, L, scale, st, vec_qkv,
                                               vec_bias, (T*)out, lse);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int bwd(int B, int H, int L, float scale, const void* q, const void* k, const void* v,
        const void* bias, const uint8_t* kmask, const void* g, const float* lse,
        const float* delta, const Strides& st, void* ds, void* dk, void* dv,
        cudaStream_t stream) {
  const int smem = BwdTiles<T, DH>::SMEM_BYTES;
  const int esize = (int)sizeof(T);
  const int vec_qkv = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(g) &&
                      strides16({st.qb, st.ql, st.qh, st.kb, st.kl, st.kh, st.vb, st.vl, st.vh,
                                 st.gb, st.gl, st.gh},
                                esize);
  const bool bias_rows = st.bj == 1 && strides16({st.bb, st.bh, st.bi}, esize);
  const int vec_bias = bias_rows && aligned16(bias), vec_ds = bias_rows && aligned16(ds);
  auto kern = flash_bwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (L + kBK - 1) / kBK, DH / BwdTiles<T, DH>::DV);
  kern<<<grid, kBwdWarps * 32, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                               (const T*)bias, kmask, (const T*)g, lse, delta, H,
                                               L, scale, st, vec_qkv, vec_bias, vec_ds, (T*)ds,
                                               (T*)dk, (T*)dv);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_chunked(int B, int H, int L, int dh, float scale, const void* q, const void* k,
                const void* v, const void* bias, const uint8_t* kmask, const Strides& st, void* out,
                float* lse, cudaStream_t stream) {
  using Tiles = ChunkedFwdTiles<T>;
  const int smem = Tiles::SMEM_BYTES;
  const int esize = (int)sizeof(T);
  const int vec_qkv = aligned16(q) && aligned16(k) && aligned16(v) &&
                      strides16({st.qb, st.ql, st.qh, st.kb, st.kl, st.kh, st.vb, st.vl, st.vh},
                                esize);
  const int vec_bias = st.bj == 1 && aligned16(bias) && strides16({st.bb, st.bh, st.bi}, esize);
  auto kern = flash_fwd_chunked_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (L + Tiles::BQ - 1) / Tiles::BQ, dh / kOwned);
  kern<<<grid, kFwdWarps * 32, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                               (const T*)bias, kmask, H, L, dh, scale, st, vec_qkv,
                                               vec_bias, (T*)out, lse);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_chunked(int B, int H, int L, int dh, float scale, const void* q, const void* k,
                const void* v, const void* bias, const uint8_t* kmask, const void* g,
                const float* lse, const float* delta, const Strides& st, void* ds, void* dk,
                void* dv, cudaStream_t stream) {
  const int smem = ChunkedBwdTiles<T>::SMEM_BYTES;
  const int esize = (int)sizeof(T);
  const int vec_qkv = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(g) &&
                      strides16({st.qb, st.ql, st.qh, st.kb, st.kl, st.kh, st.vb, st.vl, st.vh,
                                 st.gb, st.gl, st.gh},
                                esize);
  const bool bias_rows = st.bj == 1 && strides16({st.bb, st.bh, st.bi}, esize);
  const int vec_bias = bias_rows && aligned16(bias), vec_ds = bias_rows && aligned16(ds);
  auto kern = flash_bwd_chunked_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (L + kBK - 1) / kBK, dh / kOwned);
  kern<<<grid, kBwdWarps * 32, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                               (const T*)bias, kmask, (const T*)g, lse, delta, H,
                                               L, dh, scale, st, vec_qkv, vec_bias, vec_ds, (T*)ds,
                                               (T*)dk, (T*)dv);
  return (int)cudaGetLastError();
}

constexpr int kErrUnsupported = -1;

// what one launch's grid takes: B*h blocks along x, 64-row tiles along y
bool grid_fits(int B, int H, int L) {
  return (long long)B * H <= 0x7fffffffLL && (L + kBK - 1) / kBK <= 65535;
}

// the built head dims take their own instantiation; a multiple of 128 above
// 256 (up to 65535 * 128, the grid's z) the chunked route
#define PS_CASE(CALL, D) \
  case D: return dtype == 0 ? CALL(float, D) : CALL(__nv_bfloat16, D);
#define PS_DISPATCH(CALL, CHUNKED)                                                  \
  switch (dh) {                                                                     \
    PS_CASE(CALL, 16)                                                               \
    PS_CASE(CALL, 32)                                                               \
    PS_CASE(CALL, 64)                                                               \
    PS_CASE(CALL, 128)                                                              \
    PS_CASE(CALL, 256)                                                              \
    default:                                                                        \
      if (dh > 256 && dh % kOwned == 0 && dh / kOwned <= 65535)                     \
        return dtype == 0 ? CHUNKED(float) : CHUNKED(__nv_bfloat16);                \
      return kErrUnsupported;                                                       \
  }

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, k, v, bias and out alike); dh 16, 32,
// 64, 128 or 256, or a multiple of 128 above 256 (the chunked route);
// ops/flash_attn.py stages any other dh into the next of these, zero-padded,
// with scale 1/sqrt of its own dh.
// `strides` holds the 16 element strides of Strides (the dO entries are not
// read).  kmask: contiguous uint8 (B, L).  out: contiguous (B, L, H, dh);
// lse: contiguous f32 (B, H, L).  Returns cudaGetLastError() (0 = launched)
// or -1 for an unsupported dtype or dh, or B*H past 2^31 - 1 or L past
// 65535 * 64.
extern "C" int ps_flash_fwd(int device, int dtype, int B, int H, int L, int dh, float scale,
                            const void* q, const void* k, const void* v, const void* bias,
                            const uint8_t* kmask, const long long* strides, void* out,
                            float* lse, void* stream) {
  if (dtype != 0 && dtype != 1) return kErrUnsupported;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaSuccess;
  if (!grid_fits(B, H, L)) return kErrUnsupported;
  const Strides st = make_strides(strides);
  cudaStream_t s = (cudaStream_t)stream;
#define PS_FWD(T, D) fwd<T, D>(B, H, L, scale, q, k, v, bias, kmask, st, out, lse, s)
#define PS_FWD_CHUNKED(T) fwd_chunked<T>(B, H, L, dh, scale, q, k, v, bias, kmask, st, out, lse, s)
  PS_DISPATCH(PS_FWD, PS_FWD_CHUNKED)
#undef PS_FWD_CHUNKED
#undef PS_FWD
}

// As ps_flash_fwd, plus dO (through its strides), lse
// and delta (contiguous f32 (B, H, L)); writes ds with the bias's strides,
// dk and dv contiguous (B, L, H, dh).
extern "C" int ps_flash_bwd(int device, int dtype, int B, int H, int L, int dh, float scale,
                            const void* q, const void* k, const void* v, const void* bias,
                            const uint8_t* kmask, const void* g, const float* lse,
                            const float* delta, const long long* strides, void* ds, void* dk,
                            void* dv, void* stream) {
  if (dtype != 0 && dtype != 1) return kErrUnsupported;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaSuccess;
  if (!grid_fits(B, H, L)) return kErrUnsupported;
  const Strides st = make_strides(strides);
  cudaStream_t s = (cudaStream_t)stream;
#define PS_BWD(T, D) bwd<T, D>(B, H, L, scale, q, k, v, bias, kmask, g, lse, delta, st, ds, dk, dv, s)
#define PS_BWD_CHUNKED(T) \
  bwd_chunked<T>(B, H, L, dh, scale, q, k, v, bias, kmask, g, lse, delta, st, ds, dk, dv, s)
  PS_DISPATCH(PS_BWD, PS_BWD_CHUNKED)
#undef PS_BWD_CHUNKED
#undef PS_BWD
}
