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
// the two halves of the head dim along z.
//
// Head dims.  Built for dh 16, 32, 64, 128 and 256; the wrapper runs any dh
// up to 256 on the next of these, its q, k, v and dO zero-padded (the Pallas
// kernels take any dh as one block).  dh 256 (the [mfu-peak] width, node
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
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      if constexpr (kF32) {
        uint32_t ab[4], as[4];
        if constexpr (kHoldQ) {
#pragma unroll
          for (int x = 0; x < 4; ++x) ab[x] = qa[kk][x], as[x] = qs[kk][x];
        } else {
          tf32_a_frag<RS>(reinterpret_cast<const float*>(sq), warp * 16 + g, kk * 8, t, ab, as);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* kr = reinterpret_cast<const float*>(sk) + (nt * 8 + g) * RS + kk * 8 + t;
          uint32_t bf[4];
          split_tf32(kr[0], bf[0], bf[2]);
          split_tf32(kr[4], bf[1], bf[3]);
          mma_3xtf32(sc[nt], ab, as, bf);
        }
      } else if constexpr (kHoldQ) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];  // b0, b1 of n8 tiles 2np and 2np + 1
          ldsm_x4(kf, sk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * RS + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * np], qa[kk], kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qa[kk], kf[2], kf[3]);
        }
      } else {  // bf16 dh 256: Q's A fragment of this k step from shared memory
        uint32_t qr[4];
        ldsm_x4(qr, sq + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, sk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * RS + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * np], qr, kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qr, kf[2], kf[3]);
        }
      }
    }

    // logits in base 2 (times log2 e, so that p = exp2(x - m) takes one MUFU.EX2) and the
    // online softmax; masked keys stay at the sentinel with p = 0
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

    // O += P V
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
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // p in bf16 (the value dtype): n8 tiles 2kk, 2kk + 1 are one k16 step
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DV / 16; ++dp) {
          uint32_t vf[4];  // b0, b1 of head-dim n8 tiles 2dp and 2dp + 1
          ldsm_x4_trans(vf, sv + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RV + dp * 16 +
                                (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    if constexpr (STAGES == 1) {
      if (jt + 1 < n_tiles) {
        __syncthreads();  // every warp is done with the one stage
        load_tile(jt + 1);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int i = i0 + row0 + 8 * hr;
    if (i < L) {
      const bool has_keys = l[hr] > 0.0f;
      T* orow = out + (((long long)b * L + i) * H + h) * DH + 2 * t;
      if constexpr (DV < DH) orow += hd0;
#pragma unroll
      for (int d = 0; d < NO; ++d)
        store_pair(orow + d * 8, has_keys ? o[d][2 * hr] / l[hr] : 0.0f,
                   has_keys ? o[d][2 * hr + 1] / l[hr] : 0.0f);
      if constexpr (DV == DH) {
        if (t == 0) lse[(long long)bh * L + i] = has_keys ? (m[hr] + log2f(l[hr])) * kLn2 : kLseMasked;
      } else {  // dh 256: the first half's block writes the lse
        if (t == 0 && hd0 == 0)
          lse[(long long)bh * L + i] = has_keys ? (m[hr] + log2f(l[hr])) * kLn2 : kLseMasked;
      }
    }
  }
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
    float* sl = stage_l(s);
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

  // c += A rows^T, A this warp's 16 rows of `at` (K or V), rows the BQ rows
  // of `rt` (Q or dO): c[nt] holds rows nt*8 + 2t, +1 of rt.  A's fragments
  // are read at each use (held in registers for the block, they cost
  // occupancy and ran slower)
  auto mma_rows_t = [&](float(&c)[NQ][4], const T* at, const T* rt) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];  // f32: big, small
      if constexpr (kF32) {
        tf32_a_frag<RS>(reinterpret_cast<const float*>(at), warp * 16 + g, kk * 8, t, ab, as);
      } else {
        ldsm_x4(ab, at + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS + kk * 16 +
                        (lane >> 4) * 8);
      }
      if constexpr (kF32) {
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const float* r = reinterpret_cast<const float*>(rt) + (nt * 8 + g) * RS + kk * 8 + t;
          uint32_t bf[4];
          split_tf32(r[0], bf[0], bf[2]);
          split_tf32(r[4], bf[1], bf[3]);
          mma_3xtf32(c[nt], ab, as, bf);
        }
      } else {
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t f[4];  // b0, b1 of n8 tiles 2np and 2np + 1
          ldsm_x4(f, rt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * RS + kk * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(c[2 * np], ab, f[0], f[1]);
          mma_bf16(c[2 * np + 1], ab, f[2], f[3]);
        }
      }
    }
  };

  // acc += P rows, P the C fragments of p^T or ds^T (16 keys x BQ queries),
  // rounded to T (bf16: packed into A fragments), rows the BQ rows of `rt`
  // (dO or Q), their columns hd0.. hd0 + DV.  float32 sums the tile's product
  // apart and adds it in float32.
  auto mma_p_rows = [&](float(&acc)[ND][4], const float(&p)[NQ][4], const T* rt) {
    if constexpr (kF32) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float ot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          // k order (0, 2, 4, 6, 1, 3, 5, 7) of queries nt*8..: the C fragment as the A fragment
          uint32_t pb[4], ps[4], bf[4];
          split_tf32(p[nt][0], pb[0], ps[0]);
          split_tf32(p[nt][2], pb[1], ps[1]);
          split_tf32(p[nt][1], pb[2], ps[2]);
          split_tf32(p[nt][3], pb[3], ps[3]);
          const float* r = reinterpret_cast<const float*>(rt) + (nt * 8 + 2 * t) * RS + hd0 + d * 8 + g;
          split_tf32(r[0], bf[0], bf[2]);
          split_tf32(r[RS], bf[1], bf[3]);
          mma_3xtf32(ot, pb, ps, bf);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[d][x] += ot[x];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                                pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                                pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                                pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DV / 16; ++dp) {
          uint32_t f[4];  // b0, b1 of head-dim n8 tiles 2dp and 2dp + 1
          ldsm_x4_trans(f, rt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS + hd0 + dp * 16 +
                               (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa, f[0], f[1]);
          mma_bf16(acc[2 * dp + 1], pa, f[2], f[3]);
        }
      }
    }
  };

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

    // p^T = exp(s^T - lse) on allowed keys: c 0, 1 key key0, queries nt*8 + 2t, +1; c 2, 3 key0 + 8
    float p[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
    mma_rows_t(p, sk, sq);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int c = nt * 8 + 2 * t;
      float l0, l1;
      load_pair(sl + c, l0, l1);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const T* br = sb + c * BS + key0 + 8 * hr;
        // lse is +1e30 on fully masked rows and rows past L, so p is exactly 0 there
        const float x0 = (p[nt][2 * hr] * scale + to_f<T>(br[0]) - l0) * kLog2e;
        const float x1 = (p[nt][2 * hr + 1] * scale + to_f<T>(br[BS]) - l1) * kLog2e;
        p[nt][2 * hr] = allow[hr] ? exp2f(x0) : 0.0f;
        p[nt][2 * hr + 1] = allow[hr] ? exp2f(x1) : 0.0f;
      }
    }
    mma_p_rows(dva, p, sg);  // dv += p^T dO, p in dO's dtype

    // ds^T = p^T (dp^T - delta), dp^T = V dO^T
    float dsa[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) dsa[nt][0] = dsa[nt][1] = dsa[nt][2] = dsa[nt][3] = 0.0f;
    mma_rows_t(dsa, sv, sg);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      float d0, d1;
      load_pair(sl + BQ + nt * 8 + 2 * t, d0, d1);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dsa[nt][2 * hr] = p[nt][2 * hr] * (dsa[nt][2 * hr] - d0);
        dsa[nt][2 * hr + 1] = p[nt][2 * hr + 1] * (dsa[nt][2 * hr + 1] - d1);
      }
    }
    mma_p_rows(dka, dsa, sq);  // dk += ds^T Q, ds in q's dtype

    // ds out (by the blocks of the first dk, dv columns): over the bias
    // entries this thread alone read, then the tile by rows
    if (hd0 == 0) {
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
      store_ds<T, BQ, NT>(dsb, sb, st.bi, st.bj, i0, j0, L, vec_ds);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j0 + key0 + 8 * hr;
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

constexpr int kErrUnsupported = -1;

// what one launch's grid takes: B*h blocks along x, 64-row tiles along y
bool grid_fits(int B, int H, int L) {
  return (long long)B * H <= 0x7fffffffLL && (L + kBK - 1) / kBK <= 65535;
}

#define PS_CASE(CALL, D) \
  case D: return dtype == 0 ? CALL(float, D) : CALL(__nv_bfloat16, D);
#define PS_DISPATCH(CALL) \
  switch (dh) {           \
    PS_CASE(CALL, 16)     \
    PS_CASE(CALL, 32)     \
    PS_CASE(CALL, 64)     \
    PS_CASE(CALL, 128)    \
    PS_CASE(CALL, 256)    \
    default: return kErrUnsupported; \
  }

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, k, v, bias and out alike); dh 16, 32,
// 64, 128 or 256 (ops/flash_attn.py stages any other dh up to 256 into the
// next of these, zero-padded, with scale 1/sqrt of its own dh).
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
  PS_DISPATCH(PS_FWD)
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
  PS_DISPATCH(PS_BWD)
#undef PS_BWD
}
