// Multi-spin-coded lattice sweep: 32 replica lanes per uint32 word, one
// color phase per launch over all W word planes.
//
// Replaces repro/kernels/pbit_bitplane.py::pbit_bitplane_sweep (Pallas
// body _bitplane_kernel) together with the word loop of
// repro/kernels/ops.py::pbit_bitplane_sweep_op.  Per word: the six
// neighbor words XOR their sign plane and AND their nonzero plane, a
// carry-save adder tree gives the 3 bit-slices of the +1-contribution
// count c in [0, 6] for all 32 lanes at once; per live lane: one
// xorshift32 step of that lane's LFSR column (every lane below R advances
// every phase, masked or not), the LUT row rows[t, lane] and the accept
// u >= T[row][base + 2c]; the lane-masked color mask merges the accepted
// bits and per-lane flip counts are taken per bit.
//
// Phase visibility as in pbit_lattice.cu: one launch per (sweep, color)
// phase, spins ping-ponged between two word buffers, LFSR columns
// advanced in place.  Grid (sites / 256, W).
//
// Bound on this card: the per-lane LFSR columns.  The word math is a few
// dozen logic ops per 32 lanes; each lane then reads and writes its 4 B
// LFSR state every phase (8 B per lane-site against 8 B per word-site of
// spins), so at R = 64 a phase streams ~0.5 GB of LFSR state — past the
// 50 MB L2, from device memory — and the per-lane loop's integer work
// (xorshift, bit extraction, threshold load) is of the same order.
// Per-lane flips are reduced with one warp ballot per bit, then shared
// memory, then one atomic per lane per block.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kBlock)
bitplane_phase_kernel(const uint32_t* __restrict__ mw_in,
                      uint32_t* __restrict__ mw_out,
                      const uint32_t* s_in, uint32_t* s_out,
                      const int32_t* __restrict__ rows_t,
                      const uint32_t* __restrict__ mask,
                      Six<uint32_t> sign, Six<uint32_t> nz,
                      const int32_t* __restrict__ base, Six<uint32_t> halo,
                      const uint32_t* __restrict__ lut, int lw, int R,
                      int X, int Y, int Z, uint32_t* __restrict__ flips) {
  __shared__ unsigned block_flips[32];
  if (threadIdx.x < 32) block_flips[threadIdx.x] = 0;
  __syncthreads();

  const int w = blockIdx.y;
  const int n = X * Y * Z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long off = static_cast<long long>(w) * n;
  uint32_t diff = 0;
  if (i < n) {
    const uint32_t* m = mw_in + off;
    uint32_t nb[6];
    neighbors<uint32_t>(m, halo, i, site_of(i, Y, Z), w, X, Y, Z, nb);
    uint32_t t[6];
    for (int d = 0; d < 6; ++d) t[d] = (nb[d] ^ sign.p[d][i]) & nz.p[d][i];
    // carry-save adder tree: c = b0 + 2 b1 + 4 b2 for every lane
    const uint32_t s1 = t[0] ^ t[1] ^ t[2];
    const uint32_t c1 = (t[0] & t[1]) | (t[2] & (t[0] ^ t[1]));
    const uint32_t s2 = t[3] ^ t[4] ^ t[5];
    const uint32_t c2 = (t[3] & t[4]) | (t[5] & (t[3] ^ t[4]));
    const uint32_t b0 = s1 ^ s2;
    const uint32_t k = s1 & s2;
    const uint32_t b1 = c1 ^ c2 ^ k;
    const uint32_t b2 = (c1 & c2) | (k & (c1 ^ c2));

    const int bs = base[i];
    const int lane0 = w * 32;
    const int live = R - lane0 < 32 ? R - lane0 : 32;
    uint32_t upd = 0;
    for (int b = 0; b < live; ++b) {
      const long long si = static_cast<long long>(lane0 + b) * n + i;
      const uint32_t s = xorshift32(s_in[si]);
      s_out[si] = s;
      const int c = static_cast<int>(((b0 >> b) & 1u) + 2u * ((b1 >> b) & 1u)
                                     + 4u * ((b2 >> b) & 1u));
      int idx = bs + 2 * c;
      idx = idx < 0 ? 0 : (idx > lw - 1 ? lw - 1 : idx);
      const uint32_t thr = lut[static_cast<long long>(rows_t[lane0 + b]) * lw + idx];
      upd |= static_cast<uint32_t>((s >> 8) >= thr) << b;
    }
    const uint32_t old = m[i];
    const uint32_t mk = mask[off + i];
    const uint32_t nv = (old & ~mk) | (upd & mk);
    mw_out[off + i] = nv;
    diff = old ^ nv;
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
  if (threadIdx.x < 32) {
    const int r = w * 32 + threadIdx.x;
    if (r < R && block_flips[threadIdx.x])
      atomicAdd(&flips[r], block_flips[threadIdx.x]);
  }
}

}  // namespace repro_torch

// One color phase of the bit-plane sweep.  mw (W, X, Y, Z) uint32 words;
// s (R, X, Y, Z) uint32 LFSR columns; rows_t (R,) int32 LUT rows of this
// sweep per lane; mask (W, X, Y, Z) lane-masked uint32 color mask;
// signs6 / nz6 (X, Y, Z) uint32; base (X, Y, Z) int32; halos (W, plane)
// uint32; lut (n_rows, lw) uint32; flips (R,) uint32 accumulates.
// Returns cudaGetLastError().
extern "C" int pbit_bitplane_phase(
    const void* mw_in, void* mw_out, const void* s_in, void* s_out,
    const void* rows_t, const void* mask, const void* const* signs6,
    const void* const* nz6, const void* base, const void* const* halos,
    const void* lut, int lw, int W, int R, int X, int Y, int Z, void* flips,
    void* stream) {
  using namespace repro_torch;
  const dim3 grid(blocks_for(X * Y * Z), static_cast<unsigned>(W));
  bitplane_phase_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mw_in), static_cast<uint32_t*>(mw_out),
      static_cast<const uint32_t*>(s_in), static_cast<uint32_t*>(s_out),
      static_cast<const int32_t*>(rows_t), static_cast<const uint32_t*>(mask),
      six<uint32_t>(signs6), six<uint32_t>(nz6),
      static_cast<const int32_t*>(base), six<uint32_t>(halos),
      static_cast<const uint32_t*>(lut), lw, R, X, Y, Z,
      static_cast<uint32_t*>(flips));
  return static_cast<int>(cudaGetLastError());
}
