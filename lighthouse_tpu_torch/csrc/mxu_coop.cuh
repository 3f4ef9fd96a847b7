// Montgomery product on the 31 x 13-bit plane by a group of G ranks per lane,
// one rank per warp, in blocks of 32 lanes (group.cuh with L = kGroupLanes):
// the core of kernels 7 (csrc/mxu.cu), 4m and 5m (csrc/chain.cu), the 13-bit
// twin of mont_coop.cuh's mont_group_core.  The chains' operands and results
// are shared-memory Lanes; kernel 7 reads its operands straight from their
// global planes (PlaneIn) in phase 1, the only phase that reads them.
//
// The same limbs as lh::mont_core_mxu (mxu.cuh), step for step, in eight
// barrier phases:
//
//   1. to13 of both operands: each rank a block of 64/G limbs of one
//      operand, unrolled at compile time (to13 is exact in value with one
//      carry pass, so a block reads only the 15-bit limbs whose chunks reach
//      it or the column below).
//   2. t = a13 * b13: the 32 x 32 padded schoolbook in G tiles of 8 x 128/G
//      products, one per rank, summed into the lane's t columns by shared
//      atomics.  Each product is below 8193^2 < 2^26.01 and each column below
//      31 * 8193^2 < 2^31: exact integers whatever order the ranks add in.
//   3. Three 13-bit carry passes over t's 61 columns: each rank a block of
//      64/G columns from a window three columns below it (a pass is
//      one-step: column k reads columns k and k - 1).
//   4. m = Toeplitz(P'13)[0:32] @ T on the FP64 tensor cores (mxu.cuh's
//      DMMA): 4 row tiles x 4 n-tiles of 8 lanes, 16 tile pairs dealt to the
//      warps, each up to 8 k-tiles, the all-zero ones skipped.  B is the
//      lanes' t rows 0..31, read in place from the block's shared arrays (the
//      rows 30, 31 reach only C rows 30, 31, which are not kept); each warp
//      writes its C rows straight into the lanes' m columns.
//   5. Three passes over m's 30 columns (rows 30, 31 set to zero for B).
//   6. u = Toeplitz(P13)[0:64] @ M: 32 tile pairs, dealt in the same way.
//   7. Three passes over u, s = t + u kept, and each rank's carry map.
//   8. The 61-step carry of t + u: each rank's carry-in composed from the
//      maps of the ranks below, then its block and two columns past it;
//      columns 30..60 are the output's strict 13-bit limbs, and each rank
//      forms the to15 limbs whose first 13-bit limb lies in its block.
//
// Merging phases (each rank forming its own tile's to13 limbs, the passes
// formed where the DMMA loads its B rows) takes away three barriers but
// repeats work, and ran slower on the card (PERF.md).
//
// The carry maps: after three passes every column of t and of u is at most
// 2^13 (a pass leaves (c & M13) + (c_prev >> 13): raw sums below 2^31 give
// at most 270,334, then 8,223, then 8,192), so a column of t + u is at most
// 2^14 and with a carry-in of at most 2 the carry out is again at most 2.
// Each rank records its block's carry out for the carry-ins 0, 1 and 2
// (tests/test_torch_mxu.py computes the bound).
//
// The tile pairs of a DMMA phase are dealt by n-tile j = r % 4 and a run of
// row tiles in the order 0, 3, 1, 2 (4, 7, 5, 6 for u): neighbouring pairs
// of that order hold 10 nonzero k-tiles between them, so the warps' shares
// are even at G = 8 (m: 10 k-tiles a warp, u: 20) and at G = 16 for u
// (m: 2 to 8).  Every mma.sync is made by one whole warp, as in kernel 2m.
// A rank's choices (its to13 block, its run of row tiles, its carry block)
// are warp-uniform branches among compile-time variants, so the loops in
// them unroll with constant indices.
//
// Shared memory: per lane 192 + G rows of work, at a row stride of kRow
// words for the block's 32 lanes; per block the Toeplitz tables (1 KB).
// Work regions, reused as their values die:
//   kA (32 rows): to13(a) [1-2]; m's raw columns [4-5]
//   kB (32 rows): to13(b) [1-2]; m after its passes [5-6]
//   kC (64 rows): t's column sums [2-3]; u's raw columns [6-7]; zero again
//                 after phase 8 (the caller zeroes them once before the
//                 first product, at the latest in phase 1, which does not
//                 touch them)
//   kS (64 rows): t after its passes [3-7]; s = t + u [7-8]
//   kMap (G rows): the carry maps [7-8]
//
// Compiled for the host (tests/torch_host_cuda.py) a block is one lane, the
// DMMA tile pairs come from mxu_host.h's toeplitz_rows (a rank computes its
// row tiles of n-tile 0, the one that holds lane 0), and the phases run
// their ranks up or down, as group.cuh describes.
#pragma once

#include "group.cuh"
#include "mont_coop.cuh"
#include "mxu.cuh"

namespace lh {
namespace coop13 {

using coop::Lane;

// Words between two rows of a block's work arrays: row k of lane slot s at
// p[k * kRow + s].  On the card mxu.cuh's kStride (40): the DMMA's B loads,
// rows 4c + q of lanes 8j + g, then fall in 32 distinct banks.  On the host
// a block is one lane.
constexpr int kRow = kGroupLanes == 1 ? 1 : kStride;

// The work regions, in rows (see the header).
constexpr int kA = 0;
constexpr int kB = 32;
constexpr int kC = 64;
constexpr int kS = 128;
constexpr int kMap = 192;
template <int G>
constexpr int kWorkRows = kMap + G;
template <int G>
constexpr int kWorkWords = kWorkRows<G> * kRow;  // a block's work, in words
constexpr int kTabWords = 2 * kTab * 2;          // the two Toeplitz tables of doubles

// A block's shared array of `words` uint32 words, 16-byte aligned (the tables
// are doubles): dynamic shared memory on the card, a local array on the host.
#ifdef __CUDACC__
#define LH_COOP13_SHARED(name, words) extern __shared__ __align__(16) uint32_t name[]
#else
#define LH_COOP13_SHARED(name, words) alignas(16) uint32_t name[words]
#endif

// Word k of one lane's (26, n) limb plane in global memory, read only (the
// operands of kernel 7).
struct PlaneIn {
  const uint32_t* p;
  int n, lane;
  __device__ __forceinline__ uint32_t operator()(int k) const {
    return p[static_cast<size_t>(k) * n + lane];
  }
};

// A block's work rows.
struct Work {
  uint32_t* p;
  __device__ __forceinline__ uint32_t* rows(int row) const { return p + row * kRow; }
  // this thread's lane's view of the rows from `row` on
  __device__ __forceinline__ Lane lane(int row) const {
    return Lane{p + row * kRow + group_slot<32>(), kRow};
  }
};

// Fill the block's Toeplitz tables (tab[0]: P'13, tab[1]: P13, diagonal d at
// entry d + kTabOff, zero outside 0..30), the entries dealt to the threads;
// rank r's share in its phase.
template <int G>
__device__ __forceinline__ void fill_tables(int r, double* tab) {
  for (int i = r * kGroupLanes + group_slot<32>(); i < 2 * kTab; i += G * kGroupLanes) {
    const int d = i % kTab - kTabOff;
    const uint32_t* c = i < kTab ? kPPrime13 : kP13;
    tab[i] = (d >= 0 && d < NL13) ? static_cast<double>(c[d]) : 0.0;
  }
}

// Rank r's share of clearing t's column sums (region kC).
template <int G>
__device__ __forceinline__ void clear_sums(int r, const Work& w) {
  const Lane c = w.lane(kC);
#pragma unroll
  for (int i = 0; i < 64 / G; ++i) c(r + i * G) = 0;
}

// Limbs [K0, K0 + NK) of to13(a) (pallas_mxu._to13 after its one carry
// pass; limb 31, the padding, zero) into o: 15-bit limb i sits at bit 15 i =
// 13 q + rr and splits into 13-bit chunks at columns q, q + 1 and, where
// QMAX15 << rr reaches bit 26, q + 2; the limbs need the raw columns K0 - 1
// .. K0 + NK - 1, so only the 15-bit limbs that reach them are read.
template <int K0, int NK, class In>
__device__ __forceinline__ void to13_block(In a, uint32_t (&o)[NK]) {
  uint32_t raw[NK + 1];  // raw column K0 - 1 + c
#pragma unroll
  for (int c = 0; c < NK + 1; ++c) raw[c] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int q = 15 * i / 13, rr = 15 * i % 13;
    const bool third = (QMAX15 << rr) >> 26;
    if (q + (third ? 2 : 1) < K0 - 1 || q > K0 + NK - 1) continue;
    const uint32_t v = a(i) << rr;
    const int c = q - (K0 - 1);
    if (c >= 0 && c <= NK) raw[c] += v & M13;
    if (c + 1 >= 0 && c + 1 <= NK) raw[c + 1] += (v >> 13) & M13;
    if (third && c + 2 >= 0 && c + 2 <= NK) raw[c + 2] += v >> 26;
  }
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    o[k] = K0 + k < NL13 ? (raw[k + 1] & M13) + (K0 + k > 0 ? raw[k] >> 13 : 0u) : 0u;
  }
}

// Block s of NK limbs of to13(a) (a warp-uniform choice among 32 / NK
// compile-time blocks).
template <int NK, int S = 0, class In>
__device__ __forceinline__ void to13_blocks(int s, In a, uint32_t (&o)[NK]) {
  if constexpr (S < 32 / NK) {
    if (s == S) {
      to13_block<S * NK, NK>(a, o);
    } else {
      to13_blocks<NK, S + 1>(s, a, o);
    }
  }
}

// Phase 1: rank r's block of to13 of the two operands: ranks 0 .. G/2 - 1
// the limbs of a, the others those of b, 64 / G limbs each.
template <int G, class In>
__device__ __forceinline__ void to13_limbs(int r, In xa, In xb, Lane a13, Lane b13) {
  constexpr int NK = 64 / G;
  const int s = r % (G / 2);
  uint32_t o[NK];
  to13_blocks<NK>(s, r < G / 2 ? xa : xb, o);
  const Lane dst = r < G / 2 ? a13 : b13;
#pragma unroll
  for (int k = 0; k < NK; ++k) dst(s * NK + k) = o[k];
}

// Phase 2: rank r's 8 x 128/G tile of the 32 x 32 padded schoolbook a13 *
// b13, summed in registers into its partial columns and added to t's sums.
template <int G>
__device__ __forceinline__ void ab_tile(int r, Lane a13, Lane b13, Lane tsums) {
  constexpr int TI = 8, TJ = 128 / G;
  static_assert(G == 8 || G == 16, "tiles for 8 or 16 ranks");
  const int i0 = (r % 4) * TI, j0 = (r / 4) * TJ;
  uint32_t xs[TI], ys[TJ], c[TI + TJ - 1];
#pragma unroll
  for (int i = 0; i < TI; ++i) xs[i] = a13(i0 + i);
#pragma unroll
  for (int j = 0; j < TJ; ++j) ys[j] = b13(j0 + j);
#pragma unroll
  for (int k = 0; k < TI + TJ - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int j = 0; j < TJ; ++j) c[i + j] += xs[i] * ys[j];
  }
#pragma unroll
  for (int k = 0; k < TI + TJ - 1; ++k) atomicAdd(&tsums(i0 + j0 + k), c[k]);
}

// Three 13-bit carry passes over the columns [c0, c0 + BW) of src, from a
// window three columns below them: v[k] = column c0 + k after the passes
// (columns below 0 are 0, so column 0 keeps its low 13 bits, as in
// compress13).
template <int BW>
__device__ __forceinline__ void passes3(int c0, Lane src, uint32_t (&v)[BW]) {
  uint32_t w[BW + 3];
#pragma unroll
  for (int k = 0; k < BW + 3; ++k) w[k] = c0 + k - 3 >= 0 ? src(c0 + k - 3) : 0u;
#pragma unroll
  for (int k = BW + 2; k >= 1; --k) w[k] = (w[k] & M13) + (w[k - 1] >> 13);
#pragma unroll
  for (int k = BW + 2; k >= 2; --k) w[k] = (w[k] & M13) + (w[k - 1] >> 13);
#pragma unroll
  for (int k = 0; k < BW; ++k) v[k] = (w[k + 3] & M13) + (w[k + 2] >> 13);
}

// Phase 3: t after its passes, rank r's block of 64 / G of the 61 columns.
template <int G>
__device__ __forceinline__ void t_passes(int r, const Work& w) {
  constexpr int BW = 64 / G;
  const int c0 = r * BW;
  uint32_t v[BW];
  passes3<BW>(c0, w.lane(kC), v);
  const Lane t = w.lane(kS);
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    if (c0 + k < NC13) t(c0 + k) = v[k];
  }
}

// Row tile at position p of the order 0, 3, 1, 2, 4, 7, 5, 6.
__device__ __forceinline__ int row_tile(int p) {
  const int v = p & 3;
  return (p & ~3) + (v == 0 ? 0 : v == 1 ? 3 : v - 1);
}

// Phase 5: m after its passes, rank r's block of 32 / G rows (30 columns,
// rows 30 and 31 zero: the B operand of u).
template <int G>
__device__ __forceinline__ void m_passes(int r, const Work& w) {
  constexpr int BW = 32 / G;
  const int c0 = r * BW;
  uint32_t v[BW];
  passes3<BW>(c0, w.lane(kA), v);
  const Lane m = w.lane(kB);
#pragma unroll
  for (int k = 0; k < BW; ++k) m(c0 + k) = c0 + k < NLOW ? v[k] : 0u;
}

#ifdef __CUDACC__
// Phases 4 and 6 for the warps of row-tile run H0: y = Toeplitz(C)[0:8 RT] @ X
// on n-tile j (lanes 8j .. 8j + 7) of the block's 32 lanes, the run's RT * 4
// / G row tiles of row_tile's order from H0 * RT * 4 / G, C the 13-bit limbs
// of P' (which = kMxuPPrime) or P (kMxuP).  X is the lanes' 32 rows from
// xrow; y's rows below NY are written from yrow.  The row tiles' DMMA chains
// interleave, each split over the even and odd k-tiles (the sums are exact
// integers, so the order changes no bit).  Warp-cooperative: every thread of
// the warp calls it together.
template <int G, int RT, int NY, int H0>
__device__ __forceinline__ void toeplitz_run(int j, int which, const Work& w, int xrow, int yrow,
                                             const double* tab) {
  constexpr int PER = RT * 4 / G;  // row tiles per warp
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const uint32_t* x = w.rows(xrow) + 8 * j + g;
  double b[8];  // B[q][g] of k-tile c: row 4c + q of lane 8j + g
#pragma unroll
  for (int c = 0; c < 8; ++c) b[c] = static_cast<double>(x[(4 * c + q) * kRow]);
  const double* diag = tab + which * kTab + kTabOff + g - q;
  double d[PER][2][2];  // [row tile][k-tile parity]: D[g][2q], D[g][2q + 1]
#pragma unroll
  for (int p = 0; p < PER; ++p) d[p][0][0] = d[p][0][1] = d[p][1][0] = d[p][1][1] = 0.0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // k-tile c: limbs 4c .. 4c + 3
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int rt = row_tile(H0 * PER + p);
      // the tile's diagonals are 8 rt - 4 c - 3 .. 8 rt - 4 c + 7; C is zero
      // outside 0..30
      if (8 * rt - 4 * c + 7 < 0 || 8 * rt - 4 * c - 3 >= NL13) continue;
      dmma(d[p][c & 1][0], d[p][c & 1][1], diag[8 * rt - 4 * c], b[c]);
    }
  }
  uint32_t* y = w.rows(yrow) + 8 * j + 2 * q;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int row = 8 * row_tile(H0 * PER + p) + g;  // lanes 8j + 2q, 8j + 2q + 1
    if (row < NY) {
      *reinterpret_cast<uint2*>(y + row * kRow) =
          make_uint2(__double2uint_rz(d[p][0][0] + d[p][1][0]),
                     __double2uint_rz(d[p][0][1] + d[p][1][1]));
    }
  }
}

// Phases 4 and 6: rank r's tile pairs, n-tile r % 4 of row-tile run r / 4
// (a warp-uniform choice among G / 4 compile-time runs).
template <int G, int RT, int NY, int H0 = 0>
__device__ __forceinline__ void toeplitz_pairs(int r, int which, const Work& w, int xrow,
                                               int yrow, const double* tab) {
  static_assert(G % 4 == 0 && RT * 4 % G == 0, "whole row tiles per warp");
  if constexpr (H0 < G / 4) {
    if (r >> 2 == H0) {
      toeplitz_run<G, RT, NY, H0>(r & 3, which, w, xrow, yrow, tab);
    } else {
      toeplitz_pairs<G, RT, NY, H0 + 1>(r, which, w, xrow, yrow, tab);
    }
  }
}
#else
template <int G, int RT, int NY>
inline void toeplitz_pairs(int r, int which, const Work& w, int xrow, int yrow, const double*) {
  constexpr int PER = RT * 4 / G;
  if (r % 4 != 0) return;  // n-tiles 1..3 hold no lane on the host
  for (int p = 0; p < PER; ++p) {
    toeplitz_rows(which, w.rows(xrow), w.rows(yrow), 8 * row_tile((r / 4) * PER + p), NY);
  }
}
#endif

// Phase 7: u after its passes, s = t + u in place of t, and the carry map of
// rank r's block of 64 / G columns: two bits per carry-in 0, 1, 2 giving the
// carry out.
template <int G>
__device__ __forceinline__ void tail_sums(int r, const Work& w) {
  constexpr int BW = 64 / G;
  const int c0 = r * BW;
  uint32_t uv[BW];
  passes3<BW>(c0, w.lane(kC), uv);
  const Lane s = w.lane(kS);
  uint32_t m0 = 0, m1 = 1, m2 = 2;
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    if (c0 + k < NC13) {
      const uint32_t x = s(c0 + k) + uv[k];
      s(c0 + k) = x;
      m0 = (x + m0) >> 13;
      m1 = (x + m1) >> 13;
      m2 = (x + m2) >> 13;
    }
  }
  w.lane(kMap)(r) = m0 | (m1 << 2) | (m2 << 4);
}

// Phase 8 for rank R (a compile-time constant): the carry into its block of
// 64 / G columns from the maps of the ranks below, then the 61-step carry
// through the block and two columns past it (the next block's first sums,
// already kept), which gives every 13-bit limb j, j + 1, j + 2 (columns
// 30 + j, ...) of the to15 limbs q whose first limb j = 15 q / 13 lies in the
// block: limb q collects bits [15 q, 15 q + 15) of limbs j, j + 1 and, where
// 15 q is 12 bits into limb j, j + 2.  Those limbs are stored as out(q) by
// live lanes.  Blocks wholly below column 30 store nothing.
template <int G, int R, class Out>
__device__ __forceinline__ void tail_out(const Work& w, Out out, bool live) {
  constexpr int BW = 64 / G, c0 = R * BW;
  if constexpr (c0 + BW > NLOW && c0 < NC13) {
    const Lane cmap = w.lane(kMap), s = w.lane(kS);
    uint32_t maps[R];  // the maps below, loaded at once, then composed in registers
#pragma unroll
    for (int q = 0; q < R; ++q) maps[q] = cmap(q);
    uint32_t c = 0;
#pragma unroll
    for (int q = 0; q < R; ++q) c = (maps[q] >> (2 * c)) & 3u;
    uint32_t v[BW + 2];  // the 13-bit limbs of columns c0 .. c0 + BW + 1 (0 past 60)
#pragma unroll
    for (int k = 0; k < BW + 2; ++k) {
      if (c0 + k < NC13) {
        const uint32_t x = s(c0 + k) + c;
        c = x >> 13;
        v[k] = x & M13;
      } else {
        v[k] = 0;
      }
    }
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int j = 15 * q / 13, rr = 15 * q % 13, at = NLOW + j - c0;
      if (at < 0 || at >= BW) continue;
      uint32_t acc = (v[at] >> rr) + (v[at + 1] << (13 - rr));
      if (26 - rr < 15) acc += v[at + 2] << (26 - rr);
      if (live) out(q) = acc & MASK;
    }
  }
}

// Phase 8: rank r's tail_out (a warp-uniform choice among G compile-time
// blocks).
template <int G, class Out, int R = 0>
__device__ __forceinline__ void tail_out_rank(int r, const Work& w, Out out, bool live) {
  if constexpr (R < G) {
    if (r == R) {
      tail_out<G, R>(w, out, live);
    } else {
      tail_out_rank<G, Out, R + 1>(r, w, out, live);
    }
  }
}

// out = xa * xb * R^-1 on the 13-bit plane, operands quasi-15 limbs (26
// words each: Lanes in shared memory or PlaneIns in global memory), output
// strict 15-bit limbs (a Plane in global memory or a Lane in shared memory);
// w's column sums (region kC) zero on entry to phase 2 and on exit; tab
// filled by fill_tables before phase 4.  `first(r)` runs in phase 1 (work
// that writes neither operand and touches no work region, except that it may
// clear kC and fill tab, which phase 1 does not use), `last(r)` in phase 8
// (work that neither reads out nor touches a work region).  out may alias xa
// or xb: only phase 1 reads them.  Every thread of the block calls it.
template <int G, class In, class Out, class First, class Last>
__device__ __forceinline__ void mont_group_mxu_core(In xa, In xb, const Work& w,
                                                    const double* tab, Out out, bool live,
                                                    First first, Last last) {
  LH_RANKS(G, to13_limbs<G>(r, xa, xb, w.lane(kA), w.lane(kB)); first(r))
  LH_RANKS(G, ab_tile<G>(r, w.lane(kA), w.lane(kB), w.lane(kC)))
  LH_RANKS(G, t_passes<G>(r, w))
  LH_RANKS(G, toeplitz_pairs<G, 4, NLOW>(r, kMxuPPrime, w, kS, kA, tab))
  LH_RANKS(G, m_passes<G>(r, w))
  LH_RANKS(G, toeplitz_pairs<G, 8, NC13>(r, kMxuP, w, kB, kC, tab))
  LH_RANKS(G, tail_sums<G>(r, w))
  LH_RANKS(G, tail_out_rank<G>(r, w, out, live); clear_sums<G>(r, w); last(r))
}

}  // namespace coop13
}  // namespace lh
