// Flash pair-bias attention, forward (K8) and backward (K9), for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the TPU kernels protstruc_tpu/ops/flash_attn.py: _fwd_kernel
// (:79, launched by _fwd_call at :145) and _bwd_kernel (:184, launched by
// _bwd_call).  The op is softmax(q k^T * scale + bias) v over the keys that
// `kmask` allows, per (batch, head):
//
//   K8, one block per (b*h, tile of 64 query rows), 16 rows a warp:
//       loops over 64-key tiles with a running max m, denominator l and a
//       float32 accumulator (registers), then writes out = acc / l and
//       lse = m + log(l).  A query row with no allowed key writes zeros and
//       lse = +1e30, so K9 recomputes p = 0 there and every gradient through
//       the row is 0.  Masked logits use the finite sentinel -1e30, and p = 0
//       is selected for them (no exp of a masked logit is used).
//   K9, one block per (b*h, 64-key tile): loops over 64-query tiles,
//       recomputes p = exp(s - lse), accumulates dv += p^T dO and
//       dk += ds^T q * scale in registers (so no atomics: each block owns its
//       keys), and streams ds = p * (dp - delta) out in the bias's dtype and
//       layout.  delta = sum(dO * out) and dq = ds k * scale are plain
//       PyTorch outside the kernel, as in the JAX package.
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
// Registers a thread (-Xptxas -v, sm_90a; _build/libflash_attn-*.log):
// bf16 dh 16/32/64/128: 128/126/173/236; float32: 165/249/255/255.  float32 dh 64 and 128 spill 8 and 4 bytes a thread (no
// model of the repo runs them); the rest do not.  K9: 58-128, no spills.
//
// K9 stays a float32 FMA-loop kernel over tiles staged in shared memory (one
// shared load per FMA), bound by shared-memory bandwidth; it takes dh 16 to
// 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "device_scope.cuh"

namespace {

constexpr int kBQ = 64;        // K9: query rows per tile
constexpr int kBK = 64;        // keys per tile (K8 and K9)
constexpr int kFwdWarps = 4;   // K8: warps a block, 16 query rows each
constexpr int kThreads = 256;  // K9: four threads per tile row
constexpr int kW = kBK + 1;    // K9: padded score-tile row
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

// v rounded to T and back (exact for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f<T>(from_f<T>(v)); }

// ---------------------------------------------------------------------------
// K8: asynchronous copies, fragments and tensor-core products
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a tf32 value (24 of the float's bits kept)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b at float32 accuracy from three TF32 products, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const uint32_t (&b)[4]) {
  mma_tf32(c, a_small, b[0], b[1]);  // b: big0, big1, small0, small1
  mma_tf32(c, a_big, b[2], b[3]);
  mma_tf32(c, a_big, b[0], b[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the m16n8k8 A fragment (big and small) of rows row0 and row0 + 8, columns
// k0 + t and k0 + t + 4 of a float32 tile with row stride RS
template <int RS>
__device__ __forceinline__ void tf32_a_frag(const float* tile, int row0, int k0, int t,
                                            uint32_t (&big)[4], uint32_t (&small)[4]) {
  const float* p = tile + row0 * RS + k0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * RS], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * RS + 4], big[3], small[3]);
}

// K8's tiles: BQ query rows (16 a warp), a ring of two stages of K, V and
// bias for 64 keys each, every row padded by 16 bytes (a third stage did not
// help at [attn]; PERF.md)
template <typename T, int DH>
struct FwdTiles {
  static constexpr int BQ = kFwdWarps * 16;
  static constexpr int RS = DH + 16 / (int)sizeof(T);   // Q, K, V tile row (elements)
  static constexpr int BS = kBK + 16 / (int)sizeof(T);  // bias tile row
  static constexpr int STAGE = 2 * kBK * RS + BQ * BS;  // elements of one ring stage
  static constexpr int SMEM_BYTES = (BQ * RS + 2 * STAGE) * (int)sizeof(T);
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
  constexpr int STAGE = Tiles::STAGE;
  constexpr int NO = DH / 8;                     // n8 tiles of the output
  constexpr int QK = kF32 ? DH / 8 : DH / 16;    // k steps of q k^T
  constexpr bool kHoldQ = !kF32 || DH <= 64;     // f32 dh 128 reads Q from shared memory
  constexpr int QH = kHoldQ ? QK : 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sq = reinterpret_cast<T*>(smem_raw);  // [BQ][RS]
  __shared__ bool sallow[2][kBK];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's rows of the tile: row0, row0 + 8
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const T* biasb = bias + b * st.bb + h * st.bh;
  const uint8_t* kmb = kmask + (long long)b * L;
  const int n_tiles = (L + kBK - 1) / kBK;

  auto stage_k = [&](int s) { return sq + BQ * RS + s * STAGE; };
  auto stage_v = [&](int s) { return sq + BQ * RS + s * STAGE + kBK * RS; };
  auto stage_b = [&](int s) { return sq + BQ * RS + s * STAGE + 2 * kBK * RS; };
  auto load_tile = [&](int jt) {  // key tile jt into ring stage jt & 1, one cp.async group
    const int s = jt & 1, j0 = jt * kBK;
    copy_rows<T, DH, kBK, NT>(stage_k(s), kb, st.kl, j0, L, vec_qkv);
    copy_rows<T, DH, kBK, NT>(stage_v(s), vb, st.vl, j0, L, vec_qkv);
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
    if (jt + 1 < n_tiles) load_tile(jt + 1);
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
    const int s = jt & 1;
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
          const float* vr = reinterpret_cast<const float*>(sv) + (nt * 8 + 2 * t) * RS + d * 8 + g;
          split_tf32(vr[0], bf[0], bf[2]);
          split_tf32(vr[RS], bf[1], bf[3]);
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
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vf[4];  // b0, b1 of head-dim n8 tiles 2dp and 2dp + 1
          ldsm_x4_trans(vf, sv + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS + dp * 16 +
                                (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
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
#pragma unroll
      for (int d = 0; d < NO; ++d)
        store_pair(orow + d * 8, has_keys ? o[d][2 * hr] / l[hr] : 0.0f,
                   has_keys ? o[d][2 * hr + 1] / l[hr] : 0.0f);
      if (t == 0) lse[(long long)bh * L + i] = has_keys ? (m[hr] + log2f(l[hr])) * kLn2 : kLseMasked;
    }
  }
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

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
  dim3 grid((L + Tiles::BQ - 1) / Tiles::BQ, B * H);
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

#define PS_CASE(CALL, D) \
  case D: return dtype == 0 ? CALL(float, D) : CALL(__nv_bfloat16, D);
#define PS_DISPATCH(CALL) \
  switch (dh) {           \
    PS_CASE(CALL, 16)     \
    PS_CASE(CALL, 32)     \
    PS_CASE(CALL, 64)     \
    PS_CASE(CALL, 128)    \
    default: return kErrUnsupported; \
  }

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, k, v, bias and out alike); dh 16, 32,
// 64 or 128.
// `strides` holds the 16 element strides of Strides (the dO entries are not
// read).  kmask: contiguous uint8 (B, L).  out: contiguous (B, L, H, dh);
// lse: contiguous f32 (B, H, L).  Returns cudaGetLastError() (0 = launched)
// or -1 for an unsupported dtype or dh.
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
  const Strides st = make_strides(strides);
  cudaStream_t s = (cudaStream_t)stream;
#define PS_BWD(T, D) bwd<T, D>(B, H, L, scale, q, k, v, bias, kmask, g, lse, delta, st, ds, dk, dv, s)
  PS_DISPATCH(PS_BWD)
#undef PS_BWD
}
