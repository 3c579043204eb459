// Multi-spin-coded lattice sweep: 32 replica lanes per uint32 word, one
// color phase per launch over the sites of that color, in a color-major
// layout of the per-lane LFSR columns.
//
// Replaces repro/kernels/pbit_bitplane.py::pbit_bitplane_sweep (Pallas
// body _bitplane_kernel) together with the word loop of
// repro/kernels/ops.py::pbit_bitplane_sweep_op.  Per word: the six
// neighbor words XOR their sign plane and AND their nonzero plane, a
// carry-save adder tree gives the 3 bit-slices of the +1-contribution
// count c in [0, 6] for all 32 lanes at once; per live lane: the draw of
// that lane's LFSR column, the LUT row rows[t, lane] and the accept
// u >= T[row][base + 2c]; the lane-masked color mask merges the accepted
// bits and per-lane flip counts are taken per bit.
//
// What bounds it on this card: the per-lane LFSR columns.  The word math
// is a few dozen logic ops per 32 lanes; each lane reads and writes a 4 B
// state, 256 MB per phase at L=100, R=64 if every lane-site is touched,
// five times the 50 MB L2, so it streams from device memory.  The earlier
// design touched every lane-site every phase and ran the per-lane loop at
// masked-off sites too.
//
// What this design does about it:
// - Color-lazy LFSR.  A site's state never depends on the spins, and only
//   the draw of the phase whose mask holds the site is used.  So the
//   launch of phase k touches only the sites of color k: it advances each
//   live lane's state k+1 times, decides with that draw, advances it
//   n_colors-k-1 more times and writes it back once.  Sites in no mask
//   (padding, or masks 0 in every phase) advance n_colors times in the
//   launch of phase 0.  The state after a sweep is bitwise the
//   reference's; LFSR traffic halves, and the lane loop runs only where
//   its result is kept.
// - Color-major layout.  In the natural (R, X, Y, Z) layout the sites of
//   one checkerboard color are every other z, so a warp would fetch whole
//   32 B sectors and use half of each.  The wrapper permutes the LFSR
//   columns into color order (no-mask sites first, then color 0, 1, ...)
//   on entry and back on exit, and gives the read-only planes (signs,
//   nonzeros, base, the own-color mask word) in the same order, so every
//   per-site read of a phase is contiguous.  The spin words stay in the
//   natural layout (the neighbor reads need it) and are updated in place:
//   the wrapper has checked that no site is in two phases' masks and no
//   two neighbors in one, so a phase reads no word it writes.
// - The per-lane LUT row base rows[t, lane] * lw is read once per block
//   into shared memory; site indices are 32-bit (the wrappers keep
//   X*Y*Z < 2^30); only the lane stride of the LFSR columns (lane * n,
//   which may pass 2^31 at many lanes) is 64-bit.  All 32 states of a
//   word are loaded before the lane loop, so their loads are in flight
//   together; the xorshift steps are unrolled for 2 and 3 colors (a
//   version compiled per (color count, color) measured slower).
//   Per-lane flips: one warp ballot per bit, shared memory, one atomic per
//   lane per block.
//
// Grid: (positions of the phase / 256, W).
#include "common.cuh"

namespace repro_torch {

// xorshift32 steps q of a sweep with lo <= q < hi; kColors > 0 is the
// sweep's phase count, known at compile time, and unrolls them
// (predicated, no loop).
template <int kColors>
__device__ __forceinline__ uint32_t steps(uint32_t s, int lo, int hi) {
  if (kColors > 0) {
#pragma unroll
    for (int q = 0; q < kColors; ++q)
      if (q >= lo && q < hi) s = xorshift32(s);
  } else {
    for (int q = lo; q < hi; ++q) s = xorshift32(s);
  }
  return s;
}

template <int kColors>
__global__ void __launch_bounds__(kBlock)
bitplane_color_kernel(uint32_t* __restrict__ mw,
                      uint32_t* __restrict__ s_cm,
                      const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ rows_t,
                      const uint32_t* __restrict__ mask_cm,
                      Six<uint32_t> sign_cm, Six<uint32_t> nz_cm,
                      const int32_t* __restrict__ base_cm, Six<uint32_t> halo,
                      const uint32_t* __restrict__ lut, int lw, int R,
                      int X, int Y, int Z, int lo, int hi, int decide_lo,
                      int color, int n_colors, uint32_t* __restrict__ flips) {
  __shared__ unsigned block_flips[32];
  __shared__ int row_base[32];
  const int w = blockIdx.y;
  const int lane0 = w * 32;
  const int live = R - lane0 < 32 ? R - lane0 : 32;
  if (threadIdx.x < 32) {
    block_flips[threadIdx.x] = 0;
    row_base[threadIdx.x] =
        threadIdx.x < live ? rows_t[lane0 + threadIdx.x] * lw : 0;
  }
  __syncthreads();

  if (kColors > 0) n_colors = kColors;
  const int n = X * Y * Z;
  const int p = lo + blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t diff = 0;
  if (p < hi) {
    uint32_t* sp = s_cm + static_cast<long long>(lane0) * n + p;
    uint32_t st[32];
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (b < live) st[b] = sp[static_cast<long long>(b) * n];
    if (p < decide_lo) {
      // a site in no phase's mask: the whole sweep's steps at once
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (b < live) st[b] = steps<kColors>(st[b], 0, n_colors);
    } else {
      const int i = perm[p];
      uint32_t* m = mw + static_cast<long long>(w) * n;
      uint32_t nb[6];
      neighbors<uint32_t>(m, halo, i, site_of(i, Y, Z), w, X, Y, Z, nb);
      uint32_t t[6];
      for (int d = 0; d < 6; ++d)
        t[d] = (nb[d] ^ sign_cm.p[d][p]) & nz_cm.p[d][p];
      // carry-save adder tree: c = b0 + 2 b1 + 4 b2 for every lane
      const uint32_t s1 = t[0] ^ t[1] ^ t[2];
      const uint32_t c1 = (t[0] & t[1]) | (t[2] & (t[0] ^ t[1]));
      const uint32_t s2 = t[3] ^ t[4] ^ t[5];
      const uint32_t c2 = (t[3] & t[4]) | (t[5] & (t[3] ^ t[4]));
      const uint32_t b0 = s1 ^ s2;
      const uint32_t k = s1 & s2;
      const uint32_t b1 = c1 ^ c2 ^ k;
      const uint32_t b2 = (c1 & c2) | (k & (c1 ^ c2));

      const int bs = base_cm[p];
      uint32_t upd = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if (b < live) {
          const uint32_t s = steps<kColors>(st[b], 0, color + 1);
          const int c = static_cast<int>(((b0 >> b) & 1u)
                                         + 2u * ((b1 >> b) & 1u)
                                         + 4u * ((b2 >> b) & 1u));
          int idx = bs + 2 * c;
          idx = idx < 0 ? 0 : (idx > lw - 1 ? lw - 1 : idx);
          upd |= static_cast<uint32_t>((s >> 8) >= lut[row_base[b] + idx])
                 << b;
          st[b] = steps<kColors>(s, color + 1, n_colors);
        }
      }
      const uint32_t old = m[i];
      const uint32_t mk = mask_cm[static_cast<long long>(w) * n + p];
      const uint32_t nv = (old & ~mk) | (upd & mk);
      m[i] = nv;
      diff = old ^ nv;
    }
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (b < live) sp[static_cast<long long>(b) * n] = st[b];
  }

  // per-lane flip counts: warp lane b ends up holding the count of bit b
  const int lane = threadIdx.x & 31;
  unsigned mine = 0;
  for (int b = 0; b < 32; ++b) {
    const unsigned ballot = __ballot_sync(0xffffffffu, (diff >> b) & 1u);
    if (lane == b) mine = static_cast<unsigned>(__popc(ballot));
  }
  if (mine) atomicAdd(&block_flips[lane], mine);
  __syncthreads();
  if (threadIdx.x < live && block_flips[threadIdx.x])
    atomicAdd(&flips[lane0 + threadIdx.x], block_flips[threadIdx.x]);
}

}  // namespace repro_torch

// One color phase of the bit-plane sweep over the positions [lo, hi) of
// the color-major order; positions below decide_lo (the no-mask class,
// only in phase 0's range) advance n_colors steps and decide nothing.
// mw (W, X, Y, Z) uint32 words, updated in place; s_cm (R, n) uint32
// LFSR columns in color-major order, updated in place; perm (n,) int32
// natural site of each position; rows_t (R,) int32 LUT rows of this
// sweep; mask_cm (W, n) (each position's own-color mask word) and the
// six (n,) sign_cm / nz_cm planes uint32 and base_cm (n,) int32, all in
// color-major order; halos (W, plane) uint32; lut (n_rows, lw) uint32;
// flips (R,) uint32 accumulates.  Returns cudaGetLastError().
extern "C" int pbit_bitplane_color_phase(
    void* mw, void* s_cm, const void* perm, const void* rows_t,
    const void* mask_cm, const void* const* sign_cm,
    const void* const* nz_cm, const void* base_cm, const void* const* halos,
    const void* lut, int lw, int W, int R, int X, int Y, int Z, int lo,
    int hi, int decide_lo, int color, int n_colors, void* flips,
    void* stream) {
  using namespace repro_torch;
  const dim3 grid(blocks_for(hi - lo), static_cast<unsigned>(W));
  auto kern = n_colors == 2 ? bitplane_color_kernel<2>
              : n_colors == 3 ? bitplane_color_kernel<3>
                              : bitplane_color_kernel<0>;
  kern<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(mw), static_cast<uint32_t*>(s_cm),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(rows_t),
      static_cast<const uint32_t*>(mask_cm),
      six<uint32_t>(sign_cm), six<uint32_t>(nz_cm),
      static_cast<const int32_t*>(base_cm), six<uint32_t>(halos),
      static_cast<const uint32_t*>(lut), lw, R, X, Y, Z, lo, hi, decide_lo,
      color, n_colors, static_cast<uint32_t*>(flips));
  return static_cast<int>(cudaGetLastError());
}
