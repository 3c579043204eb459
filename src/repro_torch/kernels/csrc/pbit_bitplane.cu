// Multi-spin-coded lattice sweep: 32 replica lanes per uint32 word, one
// color phase per launch over the sites of that color, in a color-major
// layout of the per-lane LFSR columns.
//
// Replaces repro/kernels/pbit_bitplane.py::pbit_bitplane_sweep (Pallas
// body _bitplane_kernel) together with the word loop of
// repro/kernels/ops.py::pbit_bitplane_sweep_op.  Per word: the six
// neighbor words XOR their sign and AND their nonzero mask, a carry-save
// adder tree gives the 3 bit-slices of the +1-contribution count c in
// [0, 6] for all 32 lanes at once; per live lane: the draw of that lane's
// LFSR column, the LUT row rows[t, lane] and the accept
// u >= T[row][base + 2c]; the lane-masked color mask merges the accepted
// bits and per-lane flip counts are taken per bit.
//
// What bounds it on this card: the per-lane LFSR columns.  Each decided
// lane-site reads and writes a 4 B state, 256 MB a phase at L=100, R=64,
// five times the 50 MB L2, so a launch streams them from device memory:
// 76 us at the data sheet's 3.35 TB/s, 97-100 us for a kernel that only
// reads, steps and writes them in this pattern (32 rows at stride n a
// thread; wider accesses per row read no faster).  Everything else has
// to hide under that stream.  The per-lane integer work does not, at
// about 40 instructions a lane-site (the earlier design: 144 us a
// launch), and the reads of a site's other operands add to it.
//
// What this design does about it:
// - Color-lazy LFSR.  A site's state never depends on the spins, and only
//   the draw of the phase whose mask holds the site is used.  So the
//   launch of phase k touches only the sites of color k: it advances each
//   live lane's state n_colors times, keeps the (k+1)-th state as the draw
//   (every lane takes the same steps, with no per-step test of k), and
//   writes it back once.  Sites in no mask (padding, or masks 0 in every
//   phase) advance n_colors times in the launch of phase 0.  The state
//   after a sweep is bitwise the reference's.
// - Color-major layout.  The LFSR columns live in color order (no-mask
//   sites first, then color 0, 1, ...): the lattice engine holds its
//   bit-plane state so between calls, and only the natural-layout wrapper
//   (the reference's API) permutes them in and out.  The read-only
//   per-site words come in the same order, so every per-site read of a
//   phase is contiguous.  The spin words stay in the natural layout (the
//   neighbor reads need it) and are updated in place: the wrapper has
//   checked that no site is in two phases' masks and no two neighbors in
//   one, so a phase reads no word it writes.
// - One thread per site for all its word planes.  The natural index
//   perm[p], its coordinates and the site's read-only operands are read
//   or computed once a site: one packed word holds the six signs and six
//   nonzero masks (all-ones or zero words, one bit each) and base, so a
//   phase reads 8 B a site and the own-color mask word, 4 B a site and
//   plane, besides states and spins.  The planes are taken in turn: one
//   plane a thread (a grid W times as tall) ran 116-118 us against
//   107-108 us at L=100, and 15.9 us against 14.4 us on the 50^3 bricks of
//   a (2,2,2) mesh, whose phases fill under two blocks an SM.  A phase
//   smaller still (a small brick, where the serial planes of too few
//   threads would leave SMs idle) splits its planes into groups on the
//   grid's y axis, a thread taking its site's planes of one group: the
//   wrapper chooses the groups from the phase's size, W and the card's
//   SMs (pbit_bitplane.py::plane_groups).
// - A lane loop of about 19 instructions a lane-site: the steps, one
//   select of the draw, the count's offset from a nibble word (the three
//   count slices regrouped once a word so that lane b's count is 3 bits
//   of one register), one shared load of the threshold, and the accept
//   as one add whose top bit is the answer (the table holds 2^31 - T, so
//   bit 31 of (2^31 - T) + (u >> 8) is u >> 8 >= T).
// - The LUT in shared memory.  A block stages, for each lane of its
//   planes, the entries of its LUT row that any base + 2c can reach, laid
//   out [plane][index][lane], clamped to the row at staging: no row base
//   and no clamp in the lane loop.  Where that table would pass the
//   wrapper's budget (wide LUTs from fields), the gather from global
//   memory stays (kSharedLut = false), clamp included.
// - Flip counts: a 32 x 32 bit transpose across the warp (5 shuffle
//   rounds, each a funnel shift and a masked merge), so warp lane b holds
//   bit b of every thread's changed bits; one popcount, one shared atomic
//   per lane and plane, one global atomic per lane per block.
// - Source and destination columns.  A phase loads each of its
//   positions' states from s_src and stores them to s_dst.  The wrapper
//   passes the call's input columns as the source in its first sweep and
//   its output as both afterwards; each position lies in exactly one
//   phase's range, so the first sweep writes every position of the output
//   once, the input is never written, and no copy of the columns is made.
//   A launch whose source is its destination runs the in-place instance
//   (kInPlace), which reads and writes through s_dst alone, so both
//   pointers keep __restrict__.  Its stores take their stride through
//   opaque(), or the compiler keeps the 32 load addresses for them (172
//   registers, one block per SM: 136 us a launch against 112 us).
//
// Site indices are 32-bit (the wrappers keep X*Y*Z < 2^30); only the lane
// stride of the LFSR columns (lane * n, which may pass 2^31 at many lanes)
// is 64-bit.  All states of a word are loaded before its lane loop, so
// their loads are in flight together; the lane loop is unrolled, for 2 and
// 3 colors with the steps unrolled too.
//
// Grid: (positions of the phase / 256, plane groups).
#include <type_traits>

#include "common.cuh"

namespace repro_torch {

// The packed read-only word of a site: bit d the sign of direction d, bit
// 6 + d its nonzero mask, bits 12-31 base as a signed 20-bit integer.
constexpr int kBaseShift = 12;

// What the lane loop adds u >> 8 to: 2^31 - T, so that bit 31 of the sum
// is u >> 8 >= T.  A threshold above 2^31 (which no u >> 8 < 2^24 meets)
// is taken as 2^31, so that the sum stays below 2^31 and nothing accepts.
__device__ __forceinline__ uint32_t accept_base(uint32_t t) {
  return 0x80000000u - min(t, 0x80000000u);
}

// The draw of a decided lane: the state advanced n_colors times, the
// (color+1)-th of them kept.
template <int kColors>
__device__ __forceinline__ uint32_t draw_and_step(uint32_t& st, int color,
                                                  int n_colors) {
  if (kColors == 2) {
    const uint32_t s1 = xorshift32(st), s2 = xorshift32(s1);
    st = s2;
    return color == 0 ? s1 : s2;
  } else if (kColors == 3) {
    const uint32_t s1 = xorshift32(st), s2 = xorshift32(s1),
                   s3 = xorshift32(s2);
    st = s3;
    return color == 0 ? s1 : (color == 1 ? s2 : s3);
  } else {
    uint32_t s = st, draw = 0;
    for (int q = 0; q < n_colors; ++q) {
      s = xorshift32(s);
      if (q == color) draw = s;
    }
    st = s;
    return draw;
  }
}

template <int kColors>
__device__ __forceinline__ uint32_t sweep_steps(uint32_t s, int n_colors) {
  if (kColors > 0) {
#pragma unroll
    for (int q = 0; q < kColors; ++q) s = xorshift32(s);
  } else {
    for (int q = 0; q < n_colors; ++q) s = xorshift32(s);
  }
  return s;
}

// What a thread knows of its site across its planes.
struct SiteOps {
  int i;            // natural index
  Site c;
  uint32_t pk;      // packed signs and nonzeros (base above them)
  int bs;           // base (less the staged table's first index)
};

// Launch-wide operands (the words and columns it writes are kernel
// parameters of their own, so that they keep __restrict__).
struct Phase {
  const uint32_t* mask_cm;   // (W, n) own-color mask words
  Six<uint32_t> halo;
  const uint32_t* lut;
  int lw, R, X, Y, Z, n, color, n_colors, span;
};

template <typename T>
__device__ __forceinline__ T* at(T* p, int b, unsigned bytes) {
  using Byte = typename std::conditional<std::is_const<T>::value,
                                         const char, char>::type;
  return reinterpret_cast<T*>(reinterpret_cast<Byte*>(p) +
                              static_cast<unsigned long long>(b) * bytes);
}

// A value the compiler cannot prove equal to the one it was given.  The
// in-place instance loads and stores the same states; with the stores'
// stride laundered through it, the compiler recomputes their addresses
// instead of keeping the 32 load addresses live (172 registers, one block
// per SM).
__device__ __forceinline__ unsigned opaque(unsigned v) {
  asm volatile("" : "+r"(v));
  return v;
}

// One word plane of one site: load the plane's live states, decide or
// step them, store them; returns the changed spin bits.  kFull: all 32
// lanes live (no lane test).
template <int kColors, bool kInPlace, bool kSharedLut, bool kFull>
__device__ __forceinline__ uint32_t plane(
    uint32_t* __restrict__ mw, const uint32_t* __restrict__ s_src,
    uint32_t* __restrict__ s_dst, const Phase& ph, const SiteOps& o, int p,
    int w, int live, bool decide, const uint32_t* tab, const int* row_base) {
  const int n = ph.n;
  const long long lane0 = static_cast<long long>(w) * 32;
  uint32_t* dp = s_dst + lane0 * n + p;
  const uint32_t* sp = kInPlace ? dp : s_src + lane0 * n + p;
  // lane b's state lies b * 4n bytes on (4n < 2^32: one wide multiply-add
  // an address)
  const unsigned n4 = 4u * static_cast<unsigned>(n);
  // the own mask word is loaded with the states (loaded after the lane
  // loop, its latency showed: 115 us a launch against 110 us)
  const uint32_t mk =
      decide ? __ldg(ph.mask_cm + static_cast<long long>(w) * n + p) : 0u;
  // loaded in lane order, the order the lane loop takes them (in the
  // opposite order a launch ran 124 us against 110 us)
  uint32_t st[32];
#pragma unroll
  for (int b = 0; b < 32; ++b)
    if (kFull || b < live) st[b] = *at(sp, b, n4);
  uint32_t diff = 0;
  if (!decide) {
    // a site in no phase's mask: the whole sweep's steps at once
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (kFull || b < live) st[b] = sweep_steps<kColors>(st[b], ph.n_colors);
  } else {
    uint32_t* m = mw + static_cast<long long>(w) * n;
    uint32_t nb[6];
    neighbors<uint32_t>(m, ph.halo, o.i, o.c, w, ph.X, ph.Y, ph.Z, nb);
    uint32_t t[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const uint32_t sg = 0u - ((o.pk >> d) & 1u);
      const uint32_t nz = 0u - ((o.pk >> (6 + d)) & 1u);
      t[d] = (nb[d] ^ sg) & nz;
    }
    // carry-save adder tree: c = b0 + 2 b1 + 4 b2 for every lane
    const uint32_t s1 = t[0] ^ t[1] ^ t[2];
    const uint32_t c1 = (t[0] & t[1]) | (t[2] & (t[0] ^ t[1]));
    const uint32_t s2 = t[3] ^ t[4] ^ t[5];
    const uint32_t c2 = (t[3] & t[4]) | (t[5] & (t[3] ^ t[4]));
    const uint32_t b0 = s1 ^ s2;
    const uint32_t k = s1 & s2;
    const uint32_t b1 = c1 ^ c2 ^ k;
    const uint32_t b2 = (c1 & c2) | (k & (c1 ^ c2));

    // The counts as nibbles: nibble j of cn[k] is lane 4j + k's count
    // (lanes k, k + 4, ... sit 4 bits apart in each slice already).
    uint32_t cn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      constexpr uint32_t kM = 0x11111111u;
      cn[q] = ((b0 >> q) & kM) | (((b1 >> q) & kM) << 1) |
              (((b2 >> q) & kM) << 2);
    }
    // kSharedLut: this site's entries of plane w, [count index][lane]
    const char* tw = reinterpret_cast<const char*>(
        tab + (w * ph.span + o.bs) * 32);
    // thr holds 2^31 - T, so bit 31 of thr + (u >> 8) is u >> 8 >= T
    uint32_t upd = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (kFull || b < live) {
        const uint32_t u = draw_and_step<kColors>(st[b], ph.color,
                                                  ph.n_colors);
        const int j = 4 * (b >> 2);
        const uint32_t nib = cn[b & 3];
        // count c of lane b, times 256: the byte offset of its entry
        const unsigned c256 = (j >= 8 ? nib >> (j - 8) : nib << (8 - j)) &
                              0x700u;
        uint32_t thr;
        if (kSharedLut) {
          thr = reinterpret_cast<const uint32_t*>(tw + c256)[b];
        } else {
          int idx = o.bs + static_cast<int>(c256 >> 7);
          idx = idx < 0 ? 0 : (idx > ph.lw - 1 ? ph.lw - 1 : idx);
          thr = accept_base(__ldg(ph.lut + row_base[w * 32 + b] + idx));
        }
        upd |= ((thr + (u >> 8)) >> 31) << b;
      }
    }
    const uint32_t old = m[o.i];
    const uint32_t nv = (old & ~mk) | (upd & mk);
    m[o.i] = nv;
    diff = old ^ nv;
  }
  const unsigned n4s = opaque(n4);
#pragma unroll
  for (int b = 0; b < 32; ++b)
    if (kFull || b < live) *at(dp, b, n4s) = st[b];
  return diff;
}

// Adds to counts[b] the number of the warp's threads whose bit b of x is
// set, for each b (all 32 threads of the warp call it): a 32 x 32 bit
// transpose across the warp, after which thread b holds bit b of every
// thread's word.  At round k a thread swaps with the thread 2^k away the
// bits j whose bit k differs from its own lane's: it keeps `keep` and
// takes the rest from its partner's word rotated into place.
__device__ __forceinline__ void count_bits(uint32_t x, unsigned* counts) {
  if (!__any_sync(0xffffffffu, x != 0)) return;
  const unsigned lane = threadIdx.x & 31;
  // bits j with j & 2^k set
  constexpr uint32_t kHi[5] = {0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u,
                               0xFF00FF00u, 0xFFFF0000u};
#pragma unroll
  for (int k = 4; k >= 0; --k) {
    const bool up = lane & (1u << k);
    const uint32_t keep = up ? kHi[k] : ~kHi[k];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, 1 << k);
    x = (x & keep) |
        (__funnelshift_l(y, y, up ? 32 - (1 << k) : 1 << k) & ~keep);
  }
  const unsigned k = static_cast<unsigned>(__popc(x));
  if (k) atomicAdd(&counts[lane], k);
}

template <int kColors, bool kInPlace, bool kSharedLut>
__global__ void __launch_bounds__(kBlock)
bitplane_color_kernel(uint32_t* __restrict__ mw,
                      const uint32_t* __restrict__ s_src,
                      uint32_t* __restrict__ s_dst, Phase ph,
                      const int32_t* __restrict__ perm,
                      const uint32_t* __restrict__ packed,
                      const int32_t* __restrict__ rows_t, int W, int idx_lo,
                      int lo, int hi, int decide_lo,
                      uint32_t* __restrict__ flips) {
  // [W * 32] flip counts, then the LUT table [W][span][32] (kSharedLut) or
  // the lanes' row bases rows_t[lane] * lw
  extern __shared__ uint32_t smem[];
  unsigned* block_flips = smem;
  uint32_t* tab = smem + W * 32;
  int* row_base = reinterpret_cast<int*>(tab);
  const int R = ph.R;
  for (int k = threadIdx.x; k < W * 32; k += kBlock) {
    block_flips[k] = 0;
    if (!kSharedLut) row_base[k] = k < R ? rows_t[k] * ph.lw : 0;
  }
  // this block's word planes [w0, w1): all of them unless the grid has a
  // plane axis
  const int per = (W + gridDim.y - 1) / gridDim.y;
  const int w0 = blockIdx.y * per;
  const int w1 = w0 + per < W ? w0 + per : W;
  if (kSharedLut) {
    for (int k = w0 * ph.span * 32 + threadIdx.x; k < w1 * ph.span * 32;
         k += kBlock) {
      const int lane = (k >> 5) / ph.span * 32 + (k & 31);
      int idx = idx_lo + (k >> 5) % ph.span;
      idx = idx < 0 ? 0 : (idx > ph.lw - 1 ? ph.lw - 1 : idx);
      tab[k] = lane < R ? accept_base(ph.lut[rows_t[lane] * ph.lw + idx])
                        : 0u;
    }
  }
  __syncthreads();

  if (kColors > 0) ph.n_colors = kColors;
  const int p = lo + blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = p < hi;
  const bool decide = active && p >= decide_lo;
  SiteOps o{};
  if (decide) {
    o.i = perm[p];
    o.c = site_of(o.i, ph.Y, ph.Z);
    o.pk = packed[p];
    o.bs = (static_cast<int>(o.pk) >> kBaseShift) - (kSharedLut ? idx_lo : 0);
  }
  for (int w = w0; w < w1; ++w) {
    const int live = R - w * 32 < 32 ? R - w * 32 : 32;
    uint32_t diff = 0;
    if (active) {
      diff = live == 32
          ? plane<kColors, kInPlace, kSharedLut, true>(
                mw, s_src, s_dst, ph, o, p, w, live, decide, tab, row_base)
          : plane<kColors, kInPlace, kSharedLut, false>(
                mw, s_src, s_dst, ph, o, p, w, live, decide, tab, row_base);
    }
    count_bits(diff, block_flips + w * 32);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < R; k += kBlock)
    if (block_flips[k]) atomicAdd(&flips[k], block_flips[k]);
}

template <int kColors, bool kInPlace>
void launch(bool shared_lut, dim3 grid, size_t smem, cudaStream_t stream,
            uint32_t* mw, const uint32_t* s_src, uint32_t* s_dst,
            const Phase& ph, const int32_t* perm, const uint32_t* packed,
            const int32_t* rows_t, int W, int idx_lo, int lo, int hi,
            int decide_lo, uint32_t* flips) {
  auto kern = shared_lut ? bitplane_color_kernel<kColors, kInPlace, true>
                         : bitplane_color_kernel<kColors, kInPlace, false>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kern<<<grid, kBlock, smem, stream>>>(mw, s_src, s_dst, ph, perm, packed,
                                       rows_t, W, idx_lo, lo, hi, decide_lo,
                                       flips);
}

}  // namespace repro_torch

// One color phase of the bit-plane sweep over the positions [lo, hi) of
// the color-major order; positions below decide_lo (the no-mask class,
// only in phase 0's range) advance n_colors steps and decide nothing.
// mw (W, X, Y, Z) uint32 words, updated in place; s_src and s_dst (R, n)
// uint32 LFSR columns in color-major order, each position of the range
// read from s_src and written to s_dst (they may be equal); perm (n,) int32
// natural site of each position; rows_t (R,) int32 LUT rows of this
// sweep; mask_cm (W, n) uint32 each position's own-color mask word;
// packed (n,) uint32 each position's signs, nonzeros and base (see
// kBaseShift), all in color-major order; halos (W, plane) uint32; lut
// (n_rows, lw) uint32; span > 0 stages the LUT entries [idx_lo, idx_lo +
// span) of each lane's row in shared memory (the wrapper keeps every
// base + 2c there), span == 0 gathers from global memory; groups > 1
// splits the word planes into that many groups on the grid's y axis (a
// thread takes its site's planes of one group); flips (R,) uint32
// accumulates.  Returns cudaGetLastError().
extern "C" int pbit_bitplane_color_phase(
    void* mw, const void* s_src, void* s_dst, const void* perm,
    const void* rows_t, const void* mask_cm, const void* packed,
    const void* const* halos, const void* lut, int lw,
    int W, int R, int X, int Y, int Z, int lo, int hi, int decide_lo,
    int color, int n_colors, int idx_lo, int span, int groups, void* flips,
    void* stream) {
  using namespace repro_torch;
  Phase ph;
  ph.mask_cm = static_cast<const uint32_t*>(mask_cm);
  ph.halo = six<uint32_t>(halos);
  ph.lut = static_cast<const uint32_t*>(lut);
  ph.lw = lw;
  ph.R = R;
  ph.X = X;
  ph.Y = Y;
  ph.Z = Z;
  ph.n = X * Y * Z;
  ph.color = color;
  ph.n_colors = n_colors;
  ph.span = span;
  const bool shared_lut = span > 0;
  const dim3 grid(blocks_for(hi - lo), groups);
  const size_t smem =
      4 * static_cast<size_t>(W) * 32 * (1 + (shared_lut ? span : 1));
  const bool in_place = s_src == s_dst;
  using Launch = decltype(&launch<2, true>);
  const Launch go = n_colors == 2 ? (in_place ? launch<2, true>
                                              : launch<2, false>)
                    : n_colors == 3 ? (in_place ? launch<3, true>
                                                : launch<3, false>)
                                    : (in_place ? launch<0, true>
                                                : launch<0, false>);
  go(shared_lut, grid, smem, static_cast<cudaStream_t>(stream),
     static_cast<uint32_t*>(mw), static_cast<const uint32_t*>(s_src),
     static_cast<uint32_t*>(s_dst), ph,
     static_cast<const int32_t*>(perm), static_cast<const uint32_t*>(packed),
     static_cast<const int32_t*>(rows_t), W, idx_lo, lo, hi, decide_lo,
     static_cast<uint32_t*>(flips));
  return static_cast<int>(cudaGetLastError());
}
