// The per-pair arithmetic of the trRosetta pair maps, shared by K1
// (pair_maps.cu), its backward K2 (pair_maps_bwd.cu) and the roofline probes
// (pair_maps_probe.cu), so that every library evaluates one copy of it, and
// the tile skeleton that K1, K2 and K3 (model_features.cu) run.  The libraries
// that include it are built with -fmad=false (ops/cuda_lib.py): each product
// and sum rounds once, in the order the plain PyTorch versions
// (ops/pair_maps.py, ops/model_features.py) evaluate them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlotFloats = 5 * 3;   // atom slots 0-4 (N, CA, C, O, CB), xyz each

// atom slots on the residue's atom axis (vocab.py ATOM)
constexpr int kN = 0, kCA = 1, kO = 3, kCB = 4;

// bit k selects map k in this order: d_ca, d_cb, d_no, omega, theta, phi
constexpr int kDCa = 1, kDCb = 2, kDNo = 4, kOmega = 8, kTheta = 16, kPhi = 32;
constexpr int kAllMaps = 63;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* s, int slot) {
  return V3{s[3 * slot], s[3 * slot + 1], s[3 * slot + 2]};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ bool eq(V3 a, V3 b) { return a.x == b.x && a.y == b.y && a.z == b.z; }
__device__ __forceinline__ float dist(V3 a, V3 b) {
  V3 d = sub(a, b);
  return sqrtf(dot(d, d));
}

// K1's atan2: libdevice's atan2f (the TPU kernel's minimax atan2 existed only
// because Mosaic cannot lower atan2)
struct Atan2f {
  __device__ __forceinline__ float operator()(float y, float x) const { return atan2f(y, x); }
};

// Residue i's atoms and the terms of K1's maps (and K3's features) that
// depend on residue i alone, built once per i-row and handed to every pair
// of the row.  Hoisting them changes no value: each is the same expression
// the pair would evaluate.
struct PairI {
  V3 n, ca, cb;
  V3 cab;        // CA_i - CB_i: omega's b0 and phi's ba
  V3 tb1;        // CB_i - CA_i: theta's b1
  V3 tn0;        // theta's n0 = (N_i - CA_i) x (CB_i - CA_i)
  float tnh;     // theta's -|b1|
  bool eq_ca_cb, eq_n_cb, eq_n_ca;
  bool ba_zero;  // phi's |ba| == 0
};

// Residue j's atoms and omega's j-only terms.
struct PairJ {
  V3 ca, cb, o;
  V3 ob2;        // CB_j - CA_j: omega's b2
  bool eq_ca_cb;
};

// The i-side and j-side terms of the maps `mask` selects (the others stay 0,
// so a probe that asks for fewer maps does no more work than before the split).
__device__ __forceinline__ PairI pair_i(V3 n, V3 ca, V3 cb, int mask) {
  PairI s{};
  s.n = n, s.ca = ca, s.cb = cb;
  if (mask & (kOmega | kPhi)) s.cab = sub(ca, cb);
  if (mask & kOmega) s.eq_ca_cb = eq(ca, cb);
  if (mask & kTheta) {
    s.tb1 = sub(cb, ca);
    s.tn0 = cross(sub(n, ca), s.tb1);
    s.tnh = -sqrtf(dot(s.tb1, s.tb1));
    s.eq_n_cb = eq(n, cb);
    s.eq_n_ca = eq(n, ca);
  }
  if (mask & kPhi) s.ba_zero = dot(s.cab, s.cab) == 0.0f;
  return s;
}

__device__ __forceinline__ PairJ pair_j(V3 ca, V3 cb, V3 o, int mask) {
  PairJ s{};
  s.ca = ca, s.cb = cb, s.o = o;
  if (mask & kOmega) {
    s.ob2 = sub(cb, ca);
    s.eq_ca_cb = eq(ca, cb);
  }
  return s;
}

// signed dihedral with n0 = b0 x b1 and -|b1| given, through the
// scalar-triple-product identity ((b0 x b1) x (b2 x b1)) . b1 = -(b1 . b1) ((b0 x b1) . b2)
template <class Atan2>
__device__ __forceinline__ float dihedral_n0(V3 n0, V3 b1, V3 b2, float neg_len_b1, Atan2 atan2_) {
  V3 n1 = cross(b2, b1);
  float x = dot(n0, n1) + 0.0f;   // + 0.0f turns -0 into +0 before atan2
  float y = neg_len_b1 * dot(n0, b2) + 0.0f;
  return atan2_(y, x);
}

// the dihedral a-b-c-d from its arms b0 = a - b, b1 = c - b, b2 = d - c
template <class Atan2>
__device__ __forceinline__ float dihedral_arms(V3 b0, V3 b1, V3 b2, Atan2 atan2_) {
  return dihedral_n0(cross(b0, b1), b1, b2, -sqrtf(dot(b1, b1)), atan2_);
}

// planar angle between the arms ba and bc; NaN on a zero-length arm (the
// phi-map diagonal)
template <class Atan2>
__device__ __forceinline__ float planar_angle_arms(V3 ba, V3 bc, bool ba_zero, Atan2 atan2_) {
  V3 cr = cross(ba, bc);
  float ang = atan2_(sqrtf(dot(cr, cr)), dot(ba, bc));
  bool zero = dot(bc, bc) == 0.0f || ba_zero;
  return zero ? __int_as_float(0x7fc00000) : ang;
}

// K1's maps of one (i, j) pair, those `mask` selects, each handed to
// store(k, value) with k the map's bit position:
//   d_ca = |CA_i - CA_j|   omega = dihedral(CA_i, CB_i, CA_j, CB_j)
//   d_cb = |CB_i - CB_j|   theta = dihedral(N_i, CA_i, CB_i, CB_j)
//   d_no = |N_i - O_j|     phi   = angle(CA_i, CB_i, CB_j)
// Degenerate pairs are found by exact coordinate equality on the inputs and
// pinned to 0; NaN coordinates compare unequal, so missing atoms keep their
// NaN.  `I` must hold the i-side of at least `mask`.
template <class Atan2, class Store>
__device__ __forceinline__ void pair_maps_pair(const PairI& I, const PairJ& J, int mask,
                                               Atan2 atan2_, Store store) {
  if (mask & kDCa) store(0, dist(I.ca, J.ca));
  if (mask & kDCb) store(1, dist(I.cb, J.cb));
  if (mask & kDNo) store(2, dist(I.n, J.o));
  if (mask & kOmega) {
    bool deg = (eq(I.ca, J.ca) && eq(I.cb, J.cb)) || J.eq_ca_cb || I.eq_ca_cb;
    store(3, deg ? 0.0f : dihedral_arms(I.cab, sub(J.ca, I.cb), J.ob2, atan2_));
  }
  if (mask & kTheta) {
    bool deg = (I.eq_n_cb && eq(I.ca, J.cb)) || eq(I.cb, J.cb) || I.eq_n_ca;
    store(4, deg ? 0.0f : dihedral_n0(I.tn0, I.tb1, sub(J.cb, I.cb), I.tnh, atan2_));
  }
  if (mask & kPhi) store(5, planar_angle_arms(I.cab, sub(J.cb, I.cb), I.ba_zero, atan2_));
}

// The same for one pair from staged atom slots 0-4 of residue i (ri) and
// residue j (rj), map by map, each map's own i-side and j-side built for it
// alone (the probes' skeleton): each map's terms live only as long as that
// map, and residue i's atoms are read from shared memory where a map needs
// them, which keeps the probe kernels at their registers (32-40) and times
// from before the split (PERF.md).
template <class Atan2, class Store>
__device__ __forceinline__ void pair_maps_at(const float* ri, const float* rj, int mask,
                                             Atan2 atan2_, Store store) {
  const V3 ca_j = load3(rj, kCA), cb_j = load3(rj, kCB), o_j = load3(rj, kO);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int bit = 1 << k;
    if (mask & bit)
      pair_maps_pair(pair_i(load3(ri, kN), load3(ri, kCA), load3(ri, kCB), bit),
                     pair_j(ca_j, cb_j, o_j, bit), bit, atan2_, store);
  }
}

// Stage atom slots 0-4 of `n` residues from r0 of one batch entry's xyz
// (L, A, 3) into shared memory, straight from the strided layout (no packing
// pass); residues past L read as 0 and are never written out.
__device__ __forceinline__ void stage_slots(float* dst, const float* base, int r0, int n, int L,
                                            int64_t res_stride, int tid, int nthreads) {
  for (int k = tid; k < n * kSlotFloats; k += nthreads) {
    int r = r0 + k / kSlotFloats;
    dst[k] = r < L ? base[r * res_stride + k % kSlotFloats] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// The tile skeleton of K1, K2 and K3.
//
// A block of kPairWarps warps owns tiles of kPairTileI i-rows by kPairTileJ
// j-columns of one batch entry; warp w walks the tile's rows w, w +
// kPairWarps, ...  In K1 and K3 lane l of every warp owns the kPairsJ
// consecutive columns j0 + kPairsJ l ..., so a warp spans the tile's width
// and writes 16 contiguous bytes a lane, 512 a warp, of each f32 output row;
// a thread builds the i-side of each of its rows once (PairI) and evaluates
// the row's kPairsJ pairs as kPairsJ independent chains.  K2 (the strided
// walk) reads a cotangent per pair instead of writing a value: lane l owns
// the columns j0 + l + 32 q (q < kPairsJ), so that each of a warp's loads is
// 128 contiguous bytes, every lane walks every row (K2 sums a row over the
// warp's lanes), and after the tile's rows the block meets at a barrier and
// runs the caller's end-of-tile work.
//
// The walk is planned by the wrappers (ops/pair_maps.py tile_plan) and
// handed to the launch as a PairPlan: the tile shape (checked against the
// one compiled here), the tile counts, the grid and the store rule.  The
// tiles are numbered t = (b * tiles_i + ti) * tiles_j + tj, and block k
// takes t = k, k + grid, ...: one flat index, so B is bounded by nothing but
// int64.  The wrappers launch one block a tile (a persistent grid of 4
// blocks an SM walking the tiles ran 12% slower for K1; PERF.md).
//
// Stores: the pairs of (b, i, j..j+3) start at element ((b L + i) L + j),
// with j a multiple of kPairsJ, so when L is a multiple of kPairsJ every
// run of 4 pairs is whole and 16-byte aligned (f32 and int32 outputs, K3's
// 6-plane f32 and bf16 runs) or 8-byte aligned (bf16 planes).  The plan's
// `vector` says so, and then every run is one vector store; otherwise every
// pair takes scalar stores.  The output base pointers must be 16-byte
// aligned (the wrappers allocate them).
//
// Staging: residue i's N, CA, CB (9 floats) and residue j's CA, CB[, O]
// (6 or 9) come straight from xyz (B, L, A, 3) at a 12 A-byte stride, not
// 16-byte aligned, by 4-byte loads, once a tile.  The i-side is kept
// residue-major (a warp reads one row's atoms as a broadcast), the j-side
// component-major at a stride of kPairTileJ + 4 floats (a lane reads one
// component of its four columns as one 16-byte load, a warp 512 contiguous
// bytes, conflict-free).  The j-side is read where a row needs it rather
// than held in registers across the rows: the registers, not the shared
// loads, bound how many warps an SM keeps, and the arithmetic needs them.
// ---------------------------------------------------------------------------

constexpr int kPairsJ = 4;                       // consecutive j a thread owns
constexpr int kPairTileJ = 32 * kPairsJ;         // 128: one warp spans the tile's width
constexpr int kPairWarps = 8;
constexpr int kPairTileI = 32;                   // 4 rows a warp
constexpr int kPairThreads = 32 * kPairWarps;
constexpr int kJStride = kPairTileJ + 4;         // staged floats of one j-side component

static_assert(kPairTileI % kPairWarps == 0, "every warp walks as many rows");

}  // namespace

// The walk of one launch, as ops/pair_maps.py tile_plan builds it (the same
// fields in the same order as its ctypes structure).  At namespace scope:
// the libraries' C entries take it by value.
struct PairPlan {
  int pairs_j, tile_j, tile_i, warps;   // the tile shape
  int tiles_j, tiles_i;                 // tiles along j and i of one batch entry
  int grid;                             // blocks launched
  int vector;                           // 1: every run of kPairsJ pairs is one vector store
};

namespace {

// Whether the kernels can take plan p for (B, Li, Lj): its tile shape is
// the one compiled here, its tiles cover the Li rows and Lj columns, and it
// asks for vector stores only where every run is whole and aligned (a row
// starts at element (b Li + i) Lj, so Lj a multiple of kPairsJ).
__host__ __forceinline__ bool plan_fits(const PairPlan& p, int Li, int Lj) {
  return p.pairs_j == kPairsJ && p.tile_j == kPairTileJ && p.tile_i == kPairTileI &&
         p.warps == kPairWarps && p.grid > 0 && (int64_t)p.tiles_j * kPairTileJ >= Lj &&
         (int64_t)p.tiles_i * kPairTileI >= Li && (!p.vector || Lj % kPairsJ == 0);
}

__host__ __forceinline__ bool plan_fits(const PairPlan& p, int L) { return plan_fits(p, L, L); }

// the staged atoms: i-side N, CA, CB; j-side CA, CB, O
__device__ __forceinline__ int i_slot(int a) { return a == 2 ? kCB : a; }
__device__ __forceinline__ int j_slot(int a) { return a == 0 ? kCA : (a == 1 ? kCB : kO); }

// Atom a (0 CA, 1 CB, 2 O) of a lane's kPairsJ columns from the j stage
// (sjl: the stage at the lane's first column), by three 16-byte shared
// loads.  The loads are volatile so that they stay where a row needs them:
// hoisted out of the row loop, they would hold 12 registers an atom.
__device__ __forceinline__ void load_j_atom(const float* sjl, int a, V3 (&out)[kPairsJ]) {
  float4 c[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(sjl + (3 * a + f) * kJStride);
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(c[f].x), "=f"(c[f].y), "=f"(c[f].z), "=f"(c[f].w)
                 : "r"(addr));
  }
  out[0] = V3{c[0].x, c[1].x, c[2].x}, out[1] = V3{c[0].y, c[1].y, c[2].y};
  out[2] = V3{c[0].z, c[1].z, c[2].z}, out[3] = V3{c[0].w, c[1].w, c[2].w};
}

// Atom a of the lane's column q alone, by three 4-byte shared loads (volatile
// for the same reason).
__device__ __forceinline__ V3 load_j_one(const float* sjl, int a, int q) {
  float c[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(sjl + (3 * a + f) * kJStride + q);
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(c[f]) : "r"(addr));
  }
  return V3{c[0], c[1], c[2]};
}

// Where a tile lies: batch entry b, tile row ti and column tj, first row i0
// and column j0.
struct PairTile {
  int64_t b;
  int ti, tj, i0, j0;
};

// no end-of-tile work (K1, K3)
struct NoTileEnd {
  __device__ __forceinline__ void operator()(const PairTile&) const {}
};

// Walk the tiles of (B, L) that plan p lays out, with a kPairThreads-thread
// block.  NJ = 3 stages the j-side CA, CB, O (K1, K2), NJ = 2 CA and CB (K3);
// `mask` selects the i-side terms to build (K1's map bitmask; K3 all of
// them).
//  * Not Strided (K1, K3): `row(I, sjl, o, nj, vec, wide)` evaluates and
//    stores the pairs (b, i, j .. j + nj - 1) of residue i's side I and the
//    lane's staged columns sjl (load_j_atom, load_j_one), the first at
//    element o of a (B, L, L) output, by vector stores when `vec`; `wide`
//    (the same in every lane of the warp) when the plan stores vectors and
//    the tile is whole, so that every lane of the warp holds a whole run and
//    the warp's runs are one contiguous stretch.  A lane with no column of
//    the tile idles.
//  * Strided (K2): `row(ri, sjl, tile, i)` takes row i of `tile` in every
//    lane, with residue i's staged N, CA, CB at ri and the lane's first
//    staged column at sjl (its column q at sjl + 32 q, each component
//    kJStride floats apart); then, once every warp is done with the tile,
//    `tile_end(tile)`.
//
// The rectangular form (K1's xyz_j mode) takes the rows from xyz (B, Li, A,
// 3) and the columns from xyz_j (B, Lj, A, 3) into a (B, Li, Lj) output;
// the square form is xyz_j = xyz, Li = Lj = L, the same addresses.
template <int NJ, bool Strided = false, class Row, class TileEnd = NoTileEnd>
__device__ __forceinline__ void pair_tiles(const float* __restrict__ xyz,
                                           const float* __restrict__ xyz_j, int B, int Li,
                                           int Lj, int A, PairPlan p, int mask, const Row& row,
                                           const TileEnd& tile_end = TileEnd{}) {
  __shared__ float si[kPairTileI * 9];
  __shared__ __align__(16) float sj[3 * NJ * kJStride];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_tiles = (int64_t)B * p.tiles_i * p.tiles_j;
  const int64_t res_stride = (int64_t)A * 3;

  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tj = (int)(t % p.tiles_j);
    const int64_t bi = t / p.tiles_j;
    const int ti = (int)(bi % p.tiles_i);
    const int64_t b = bi / p.tiles_i;
    const int i0 = ti * kPairTileI, j0 = tj * kPairTileJ;
    const float* base_i = xyz + b * Li * res_stride;
    const float* base_j = xyz_j + b * Lj * res_stride;
    const PairTile tile{b, ti, tj, i0, j0};

    __syncthreads();  // the previous tile's reads of si and sj are done
    for (int k = tid; k < kPairTileI * 9; k += kPairThreads) {
      const int r = i0 + k / 9, f = k % 9;
      si[k] = r < Li ? base_i[r * res_stride + 3 * i_slot(f / 3) + f % 3] : 0.0f;
    }
    for (int k = tid; k < kPairTileJ * 3 * NJ; k += kPairThreads) {
      const int c = k / (3 * NJ), f = k % (3 * NJ), r = j0 + c;
      sj[f * kJStride + c] = r < Lj ? base_j[r * res_stride + 3 * j_slot(f / 3) + f % 3] : 0.0f;
    }
    __syncthreads();

    const int jt = j0 + (Strided ? lane : kPairsJ * lane);
    if (!Strided && jt >= Lj) continue;
    const int nj = min(kPairsJ, Lj - jt);
    const float* sjl = sj + (jt - j0);
    const bool vec = p.vector != 0, wide = vec && j0 + kPairTileJ <= Lj;

    for (int r = warp; r < kPairTileI; r += kPairWarps) {
      const int i = i0 + r;
      if (i >= Li) break;
      const float* ri = si + r * 9;
      if constexpr (Strided) {
        row(ri, sjl, tile, i);
      } else {
        const PairI I = pair_i(load3(ri, 0), load3(ri, 1), load3(ri, 2), mask);
        row(I, sjl, (b * Li + i) * Lj + jt, nj, vec, wide);
      }
    }
    if constexpr (Strided) {
      __syncthreads();  // every warp's rows of the tile are done
      tile_end(tile);
    }
  }
}

// The square walk of (B, L): K2, K3 and K1 without xyz_j.
template <int NJ, bool Strided = false, class Row, class TileEnd = NoTileEnd>
__device__ __forceinline__ void pair_tiles(const float* __restrict__ xyz, int B, int L, int A,
                                           PairPlan p, int mask, const Row& row,
                                           const TileEnd& tile_end = TileEnd{}) {
  pair_tiles<NJ, Strided>(xyz, xyz, B, L, L, A, p, mask, row, tile_end);
}

}  // namespace
