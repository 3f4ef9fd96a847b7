// Montgomery product on 26 x 15-bit limbs by a group of G threads per lane
// (kernel 1's cooperative core, also the 15-bit chains' products and
// squares in csrc/chain.cu; group.cuh gives the layout and the phases).
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
// compile-time shapes at a rank-dependent offset, the operands in registers
// (the square's t phase has two such paths, see sq_tile).
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

// Word k of one lane's (26, n) limb plane in global memory.
struct Plane {
  uint32_t* p;
  int n, lane;
  __device__ __forceinline__ uint32_t& operator()(int k) const {
    return p[static_cast<size_t>(k) * n + lane];
  }
};

// The shared words one product works in besides its operands: the column
// sums of t = a * b, of t * P' and of m * P (NC words each), the carry maps
// (G words) and s = t + u (NW words; may alias the operands where they are
// dead by the tail, as in mont_group).
struct Work {
  Lane tsums, msums, usums, cmap, s;
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
// block's part of the 52-step carry; columns 26..51 are the output limbs,
// limb k stored as out(k) = v (a Plane in global memory or a Lane in shared
// memory), by live lanes only.
template <int G, class Out>
__device__ __forceinline__ void tail_carry(int r, Lane s, Lane cmap, Out out, bool live) {
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
      if (c0 + k >= NL && live) out(c0 + k - NL) = v & MASK;
    }
  }
}

// t = a * a for the square (pallas_fp._wide_square): the j >= i triangle of
// the 28 x 28 padded schoolbook, the diagonal products a_i * a_i split as
// they are, a cross product (j > i) doubled before its split, as
// a_i * (2 a_j) (the same 32-bit value, below 2^31.02).  With Shape<16>'s
// 7 x 7 tiles, 4 tiles straddle the diagonal, 6 lie above it and 6 below
// (skipped).  So that no rank forms more than 28 products (a full tile is
// 49): ranks 0-3 take the triangle of diagonal tile r; ranks 4-15 take half
// of an upper tile each, rows 0-3 or rows 3-6 with row 3 zeroed (the first
// half holds it).  Ranks 0-3 run one code path, ranks 4-15 the other (one
// shape at rank-dependent offsets); a warp holds 32 / L ranks in order, so
// at L = 8 or more no warp diverges.
//
// Column sums stay exact: column k of the triangle holds at most 13 lo
// halves (< 2^15) and 13 hi halves (a doubled product's <= 66,049), at most
// 1,284,608 < 2^21 (tests/test_torch_chains.py computes it).
template <int G>
__device__ __forceinline__ void sq_tile(int r, Lane xa, Lane tsums) {
  static_assert(G == 16, "the square's tiles are dealt for 16 ranks");
  constexpr int T = Shape<G>::TI, H = 4;
  static_assert(T == Shape<G>::TJ && 2 * H - 1 == T, "square 7 x 7 tiles, halved at row 3");
  if (r < 4) {
    const int o = r * T;
    uint32_t xs[T], c[2 * T];
#pragma unroll
    for (int i = 0; i < T; ++i) xs[i] = xa(o + i);
#pragma unroll
    for (int k = 0; k < 2 * T; ++k) c[k] = 0;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const uint32_t d = xs[i] * xs[i];
      c[2 * i] += d & MASK;
      c[2 * i + 1] += d >> 15;
      const uint32_t x2 = xs[i] + xs[i];
#pragma unroll
      for (int j = i + 1; j < T; ++j) {
        const uint32_t p = x2 * xs[j];
        c[i + j] += p & MASK;
        c[i + j + 1] += p >> 15;
      }
    }
#pragma unroll
    for (int k = 0; k < 2 * T; ++k) atomicAdd(&tsums(2 * o + k), c[k]);
  } else {
    // upper tile u = (bi, bj): (0,1) (0,2) (0,3) (1,2) (1,3) (2,3); half h
    const int u = (r - 4) >> 1, h = (r - 4) & 1;
    const int bi = (u >= 3) + (u >= 5);
    const int bj = u + 1 - 2 * (u >= 3) - (u >= 5);
    const int i0 = bi * T + (H - 1) * h, j0 = bj * T;
    uint32_t xs[H], ys[T];
#pragma unroll
    for (int i = 0; i < H; ++i) xs[i] = i == 0 && h ? 0u : xa(i0 + i);
#pragma unroll
    for (int j = 0; j < T; ++j) ys[j] = 2 * xa(j0 + j);
    uint32_t c[H + T];
#pragma unroll
    for (int k = 0; k < H + T; ++k) c[k] = 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const uint32_t p = xs[i] * ys[j];
        c[i + j] += p & MASK;
        c[i + j + 1] += p >> 15;
      }
    }
#pragma unroll
    for (int k = 0; k < H + T; ++k) atomicAdd(&tsums(i0 + j0 + k), c[k]);
  }
}

// Rank r's share of clearing the column sums (before a product's t phase).
template <int G>
__device__ __forceinline__ void clear_sums(int r, const Work& w) {
  for (int k = r; k < NC; k += G) w.tsums(k) = w.msums(k) = w.usums(k) = 0;
}

// The four phases after t's column sums: m, u = m * P, and the tail into
// out.  `last(r)` runs in the last phase beside the tail, which reads only s
// and the carry maps and writes only out: work that touches none of them
// (clearing the sums for the next product, an Fp2 chain's linear ops).
template <int G, int L, class Out, class Last>
__device__ __forceinline__ void mont_group_reduce(const Work& w, const uint32_t* pp,
                                                  const uint32_t* pl, Out out, bool live,
                                                  Last last) {
  LH_RANKS_OF(G, L, m_tile<G>(r, w.tsums, pp, w.msums))
  LH_RANKS_OF(G, L, u_tile<G>(r, w.msums, pl, w.usums))
  LH_RANKS_OF(G, L, tail_sums<G>(r, w.tsums, w.usums, w.s, w.cmap))
  LH_RANKS_OF(G, L, tail_carry<G>(r, w.s, w.cmap, out, live); last(r))
}

// out = xa * xb * R^-1, the operands in shared memory (28 words each, zero
// past limb 25), w's column sums zero on entry.  `first(r)` runs in the t
// phase (work that reads no column sum and writes none of the operands),
// `last(r)` as in mont_group_reduce.  out may alias xa or xb: the tail
// reads neither.
template <int G, int L, class Out, class First, class Last>
__device__ __forceinline__ void mont_group_core(Lane xa, Lane xb, const Work& w,
                                                const uint32_t* pp, const uint32_t* pl, Out out,
                                                bool live, First first, Last last) {
  LH_RANKS_OF(G, L, t_tile<G>(r, xa, xb, w.tsums); first(r))
  mont_group_reduce<G, L>(w, pp, pl, out, live, last);
}

// out = xa * xa * R^-1 by the triangle square (pallas_fp._mont_sqr_core;
// mont.cuh mont_sqr_core): only the t phase differs from mont_group_core.
// Not mont_group_core(xa, xa), whose column sums are not the reference's
// (tests/test_torch_chains.py pins the difference).
template <int G, int L, class Out, class First, class Last>
__device__ __forceinline__ void mont_group_sqr_core(Lane xa, const Work& w, const uint32_t* pp,
                                                    const uint32_t* pl, Out out, bool live,
                                                    First first, Last last) {
  LH_RANKS_OF(G, L, sq_tile<G>(r, xa, w.tsums); first(r))
  mont_group_reduce<G, L>(w, pp, pl, out, live, last);
}

// Fill a block's table of P' and P (28 words each, zero past limb 25): the
// words dealt to the block's threads, rank r's share in its phase.
template <int G, int L>
__device__ __forceinline__ void fill_constants(int r, uint32_t* pp, uint32_t* pl) {
  for (int i = r * kLanes<L> + group_slot<L>(); i < NP; i += G * kLanes<L>) {
    pp[i] = i < NL ? kPPrime[i] : 0u;
    pl[i] = i < NL ? kP[i] : 0u;
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
// in a block of L lanes, a and b read from and out written to (26, n) limb
// planes in global memory; sm: the block's shared array of
// kGroupShared<G, L> words.  Every thread of the block calls it (the phases
// end in block barriers); only live lanes store.
template <int G, int L>
__device__ __forceinline__ void mont_group(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           uint32_t* __restrict__ out, int n, int lane, bool live,
                                           uint32_t* sm) {
  constexpr int S = kLanes<L>;
  uint32_t* base = sm + group_slot<L>();
  const Lane xa{base, S}, xb{base + NP * S, S};
  // s = xa: a and b are dead once the sums of a * b are formed
  const Work w{{base + 2 * NP * S, S}, {base + (2 * NP + NC) * S, S},
               {base + (2 * NP + 2 * NC) * S, S}, {base + (2 * NP + 3 * NC) * S, S}, xa};
  uint32_t* const pp = sm + kGroupWords<G> * S;  // P' then P, 28 words each
  uint32_t* const pl = pp + NP;
  // a and b into shared memory with zero padding, the column sums cleared,
  // the table of P' and P filled; the words dealt to the threads
  LH_RANKS_OF(G, L, for (int i = r; i < NP; i += G) {
    xa(i) = i < NL ? a[static_cast<size_t>(i) * n + lane] : 0u;
    xb(i) = i < NL ? b[static_cast<size_t>(i) * n + lane] : 0u;
  } clear_sums<G>(r, w);
  fill_constants<G, L>(r, pp, pl))
  const auto none = [](int) {};
  mont_group_core<G, L>(xa, xb, w, pp, pl, Plane{out, n, lane}, live, none, none);
}

}  // namespace coop
}  // namespace lh
