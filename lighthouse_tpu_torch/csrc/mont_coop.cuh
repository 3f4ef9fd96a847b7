// Montgomery product on 26 x 15-bit limbs by a group of G threads per lane
// (kernel 1's cooperative core; group.cuh gives the layout and the phases).
//
// The same limbs as lh::mont_core (mont.cuh), step for step.  Each of the
// three schoolbooks (a * b, t * P' for m, m * P) is cut into G tiles of
// TI x TJ products, one per rank.  A rank forms the split lo/hi halves of
// its tile's products (the split happens before the sum, as in the
// reference, because the bytes depend on it), sums them into TI + TJ
// partial columns in registers, and adds those into the lane's column sums
// in shared memory.  The column sums are exact integer sums (below 2^21), so
// the order in which the ranks add does not change a bit.
//
// m is the low 26 columns of t * P' after two carry passes, exactly as
// low_product forms it (m is quasi-normalized and not unique): a product
// with i + j >= 26 lands in column 26 or above, so the full schoolbook's
// low 26 columns are the low product's, and tiles lying wholly above
// column 25 are skipped.  A carry pass (compress1) is one-step: column k
// reads only columns k and k - 1, so both passes over any run of columns
// need only a window that starts two columns below it.
//
// The final 52-step carry over t + u is the one serial part; its result is
// fixed by the values.  Each rank computes its block's carry-out for every
// carry-in that can occur (0, 1 or 2: after two passes every column of t and
// of u is at most 2^15, so a column of t + u plus a carry of at most 2 stays
// below 3 * 2^15), then a rank composes the maps of the ranks below it to
// find its own carry-in and finishes its block.  The carry passes are done
// where their results are read (a tile's operand limbs, a block of t + u),
// from the column sums, so the product takes six phases.
//
// Every rank runs the same instructions: the tile and the block are
// compile-time shapes at a rank-dependent offset, the operands in registers.
// Operand arrays are padded with zeros to 28 limbs so that every tile has
// the same shape.
//
// Shared memory per lane: 248 words of operands and column sums, G words
// of carry maps; per block, P' and P.
#pragma once

#include "group.cuh"
#include "mont.cuh"

namespace lh {
namespace coop {

constexpr int NW = 2 * NL;  // columns of a full schoolbook
constexpr int NP = 28;      // operand limbs with the zero padding
constexpr int NC = 64;      // column words of a schoolbook's sums and passes

// Tile and block shapes for G ranks: a TI x TJ tile of the (28 x 28 padded)
// schoolbook per rank, the tiles in ceil(26 / TI) rows; a block of W of the
// 52 columns of t + u per rank.
template <int G>
struct Shape;
template <>
struct Shape<4> {
  static constexpr int TI = 13, TJ = 13, W = 13;
};
template <>
struct Shape<16> {
  static constexpr int TI = 7, TJ = 7, W = 4;
};

// Word k of one per-lane shared array ([word][lanes of the block] layout).
struct Lane {
  uint32_t* p;
  int lanes;
  __device__ __forceinline__ uint32_t& operator()(int k) const { return p[k * lanes]; }
};

// Rank r's tile of the 28 x 28 padded schoolbook: rows [i0, i0 + TI),
// columns [j0, j0 + TJ).
template <int G>
__device__ __forceinline__ void tile_origin(int r, int& i0, int& j0) {
  using S = Shape<G>;
  constexpr int rows_of_tiles = (NL + S::TI - 1) / S::TI;
  i0 = (r % rows_of_tiles) * S::TI;
  j0 = (r / rows_of_tiles) * S::TJ;
}

// The tile's products xs[i] * ys[j] (limbs i0 + i and j0 + j): lo halves at
// column i + j, hi halves at i + j + 1, summed in registers and added to
// dst's columns.  With LOW only columns below 26 are added (m's schoolbook).
template <int G, bool LOW>
__device__ __forceinline__ void tile_products(int i0, int j0, const uint32_t (&xs)[Shape<G>::TI],
                                              const uint32_t (&ys)[Shape<G>::TJ], Lane dst) {
  using S = Shape<G>;
  uint32_t c[S::TI + S::TJ];
#pragma unroll
  for (int k = 0; k < S::TI + S::TJ; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < S::TI; ++i) {
#pragma unroll
    for (int j = 0; j < S::TJ; ++j) {
      const uint32_t p = xs[i] * ys[j];
      c[i + j] += p & MASK;
      c[i + j + 1] += p >> 15;
    }
  }
#pragma unroll
  for (int k = 0; k < S::TI + S::TJ; ++k) {
    if (!LOW || i0 + j0 + k < NL) atomicAdd(&dst(i0 + j0 + k), c[k]);
  }
}

// Both carry passes over the columns [c0, c0 + BW) of the sums src, from a
// window that starts two columns below them: v[k] = column c0 + k after the
// passes (columns below 0 are 0; column 0 keeps its low 15 bits).
template <int BW>
__device__ __forceinline__ void passes(int c0, Lane src, uint32_t (&v)[BW]) {
  uint32_t w[BW + 2];
#pragma unroll
  for (int k = 0; k < BW + 2; ++k) w[k] = c0 + k - 2 >= 0 ? src(c0 + k - 2) : 0;
#pragma unroll
  for (int k = BW + 1; k >= 1; --k) w[k] = (w[k] & MASK) + (w[k - 1] >> 15);
#pragma unroll
  for (int k = 0; k < BW; ++k) v[k] = (w[k + 2] & MASK) + (w[k + 1] >> 15);
}

// t = a * b: rank r's tile, operands from shared memory.
template <int G>
__device__ __forceinline__ void t_tile(int r, Lane xa, Lane xb, Lane tsums) {
  using S = Shape<G>;
  int i0, j0;
  tile_origin<G>(r, i0, j0);
  uint32_t xs[S::TI], ys[S::TJ];
#pragma unroll
  for (int i = 0; i < S::TI; ++i) xs[i] = xa(i0 + i);
#pragma unroll
  for (int j = 0; j < S::TJ; ++j) ys[j] = xb(j0 + j);
  tile_products<G, false>(i0, j0, xs, ys, tsums);
}

// The low 26 columns of t * P' (m before its passes): rank r's tile, t's
// limbs from the passes over t's sums, P' from the block's table; a tile
// wholly above column 25 is skipped.
template <int G>
__device__ __forceinline__ void m_tile(int r, Lane tsums, const uint32_t* pp, Lane msums) {
  using S = Shape<G>;
  int i0, j0;
  tile_origin<G>(r, i0, j0);
  if (i0 + j0 >= NL) return;
  uint32_t xs[S::TI], ys[S::TJ];
  passes<S::TI>(i0, tsums, xs);
#pragma unroll
  for (int j = 0; j < S::TJ; ++j) ys[j] = pp[j0 + j];
  tile_products<G, true>(i0, j0, xs, ys, msums);
}

// u = m * P: rank r's tile, m's limbs from the passes over its sums (zero
// past limb 25), P from the block's table.
template <int G>
__device__ __forceinline__ void u_tile(int r, Lane msums, const uint32_t* pl, Lane usums) {
  using S = Shape<G>;
  int i0, j0;
  tile_origin<G>(r, i0, j0);
  uint32_t xs[S::TI], ys[S::TJ];
  passes<S::TI>(i0, msums, xs);
#pragma unroll
  for (int i = 0; i < S::TI; ++i) xs[i] = i0 + i < NL ? xs[i] : 0u;
#pragma unroll
  for (int j = 0; j < S::TJ; ++j) ys[j] = pl[j0 + j];
  tile_products<G, false>(i0, j0, xs, ys, usums);
}

// Rank r's block of W columns: t and u after their passes, s = t + u kept
// in dst, and the block's carry map, two bits per carry-in 0, 1, 2 giving
// the carry out.
template <int G>
__device__ __forceinline__ void tail_sums(int r, Lane tsums, Lane usums, Lane dst, Lane cmap) {
  constexpr int BW = Shape<G>::W;
  const int c0 = r * BW;
  uint32_t tv[BW], uv[BW];
  passes<BW>(c0, tsums, tv);
  passes<BW>(c0, usums, uv);
  uint32_t m0 = 0, m1 = 1, m2 = 2;
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    if (c0 + k < NW) {
      const uint32_t s = tv[k] + uv[k];
      dst(c0 + k) = s;
      m0 = (s + m0) >> 15;
      m1 = (s + m1) >> 15;
      m2 = (s + m2) >> 15;
    }
  }
  cmap(r) = m0 | (m1 << 2) | (m2 << 4);
}

// The carry into rank r's block from the maps of the ranks below, then the
// block's part of the 52-step carry; columns 26..51 are the output limbs.
template <int G>
__device__ __forceinline__ void tail_carry(int r, Lane s, Lane cmap, uint32_t* __restrict__ out,
                                           int n, int lane, bool live) {
  constexpr int BW = Shape<G>::W;
  const int c0 = r * BW;
  if (c0 + BW <= NL || c0 >= NW) return;
  uint32_t c = 0;
  for (int q = 0; q < r; ++q) c = (cmap(q) >> (2 * c)) & 3u;
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    if (c0 + k < NW) {
      const uint32_t v = s(c0 + k) + c;
      c = v >> 15;
      if (c0 + k >= NL && live) out[static_cast<size_t>(c0 + k - NL) * n + lane] = v & MASK;
    }
  }
}

// Shared words per lane of mont_group: a and b (28 each, later s), the
// column sums of a * b, of t * P' and of m * P, and the carry maps (G);
// then, once per block, P' and P padded to 28 limbs.
template <int G>
constexpr int kGroupWords = 2 * NP + 3 * NC + G;
template <int G, int L>
constexpr int kGroupShared = kGroupWords<G> * kLanes<L> + 2 * NP;

// out = a * b * R^-1 (mod P) for lane `lane`, by the G threads of its group
// in a block of L lanes; sm: the block's shared array of kGroupShared<G, L>
// words.  Every thread of the block calls it (the phases end in block
// barriers); only live lanes store.
template <int G, int L>
__device__ __forceinline__ void mont_group(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           uint32_t* __restrict__ out, int n, int lane, bool live,
                                           uint32_t* sm) {
  constexpr int S = kLanes<L>;
  uint32_t* base = sm + group_slot<L>();
  const Lane xa{base, S}, xb{base + NP * S, S}, tsums{base + 2 * NP * S, S},
      msums{base + (2 * NP + NC) * S, S}, usums{base + (2 * NP + 2 * NC) * S, S},
      cmap{base + (2 * NP + 3 * NC) * S, S};
  const Lane s = xa;  // a and b are dead once the sums of a * b are formed
  uint32_t* const pp = sm + kGroupWords<G> * S;  // P' then P, 28 words each
  uint32_t* const pl = pp + NP;
  // a and b into shared memory with zero padding, the column sums cleared,
  // the table of P' and P filled; the words dealt to the threads
  LH_RANKS_OF(G, L, for (int i = r; i < NP; i += G) {
    xa(i) = i < NL ? a[static_cast<size_t>(i) * n + lane] : 0u;
    xb(i) = i < NL ? b[static_cast<size_t>(i) * n + lane] : 0u;
  } for (int k = r; k < NC; k += G) tsums(k) = msums(k) = usums(k) = 0;
  for (int i = r * S + group_slot<L>(); i < NP; i += G * S) {
    pp[i] = i < NL ? kPPrime[i] : 0u;
    pl[i] = i < NL ? kP[i] : 0u;
  })
  LH_RANKS_OF(G, L, t_tile<G>(r, xa, xb, tsums))
  LH_RANKS_OF(G, L, m_tile<G>(r, tsums, pp, msums))
  LH_RANKS_OF(G, L, u_tile<G>(r, msums, pl, usums))
  LH_RANKS_OF(G, L, tail_sums<G>(r, tsums, usums, s, cmap))
  LH_RANKS_OF(G, L, tail_carry<G>(r, s, cmap, out, n, lane, live))
}

}  // namespace coop
}  // namespace lh
