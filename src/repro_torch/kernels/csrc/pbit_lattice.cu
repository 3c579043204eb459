// int8 fused lattice sweep, one color phase per launch.
//
// Replaces repro/kernels/pbit_lattice.py::pbit_brick_sweep_int (Pallas
// body _sweep_kernel_int): S sweeps x n_colors phases of one brick with
// the six halo planes held fixed; per phase the int32 field
// h_q + sum_d w_q[d] * m_d, one xorshift32 step of EVERY site's LFSR
// (masked or not), the LUT accept u = s >> 8 >= T[row][f + f_off], the
// masked write and the flip count.
//
// Phase visibility: the Pallas kernel holds the whole brick in one VMEM
// block so phase c+1 reads what phase c wrote; blocks of a CUDA grid
// cannot see each other's writes, so the wrapper launches this kernel once
// per (sweep, color) phase and ping-pongs the spins between two buffers
// (each launch reads m_in, writes every site of m_out).  The launch
// boundary orders the phases, and the out-of-place write gives the
// reference's phase semantics for any masks.  The LFSR column advances in
// place (each thread owns its site).  All R replicas share one launch:
// grid (sites / 256, R).
//
// Bound on this card: memory traffic.  Per replica-site and phase the
// kernel moves 1 B of spins in, 1 B out, 4 + 4 B of LFSR state and the
// 8 B of shared int8 constants (h_q, w_q, mask; shared by the R
// replicas); neighbor spins come from L1/L2.  At L=100 the working set
// of R = 4 replicas (two 4 MB spin buffers, 16 MB of LFSR state, 9 MB of
// constants) fits the 50 MB L2, so phases after the first of a call
// stream mostly from L2.  The accept is a
// direct threshold lookup (rows are monotone, so it equals the
// reference's rank-count form); the LUT is a few hundred bytes and stays
// in L1.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kBlock)
sweep_int_phase_kernel(const int8_t* __restrict__ m_in,
                       int8_t* __restrict__ m_out,
                       const uint32_t* s_in, uint32_t* s_out,
                       const int32_t* __restrict__ rows_t,
                       const int8_t* __restrict__ mask,
                       const int8_t* __restrict__ h_q, Six<int8_t> w,
                       Six<int8_t> halo, const uint32_t* __restrict__ lut,
                       int lw, int X, int Y, int Z,
                       uint32_t* __restrict__ flips) {
  const int r = blockIdx.y;
  const int n = X * Y * Z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long off = static_cast<long long>(r) * n;
  bool changed = false;
  if (i < n) {
    const int8_t* m = m_in + off;
    int8_t nb[6];
    neighbors<int8_t>(m, halo, i, site_of(i, Y, Z), r, X, Y, Z, nb);
    int f = h_q[i];
    for (int d = 0; d < 6; ++d) f += static_cast<int>(w.p[d][i]) * nb[d];
    const uint32_t s = xorshift32(s_in[off + i]);
    s_out[off + i] = s;
    int idx = f + (lw - 1) / 2;
    idx = idx < 0 ? 0 : (idx > lw - 1 ? lw - 1 : idx);
    const uint32_t thr = lut[static_cast<long long>(rows_t[r]) * lw + idx];
    const int8_t old = m[i];
    const int8_t nv = mask[i] ? ((s >> 8) >= thr ? 1 : -1) : old;
    m_out[off + i] = nv;
    changed = nv != old;
  }
  // one atomic per block: the changed sites of this replica
  const unsigned total = block_sum(changed ? 1u : 0u);
  if (threadIdx.x == 0 && total) atomicAdd(&flips[r], total);
}

}  // namespace repro_torch

// One color phase of the int8 sweep for R replicas.  m/s (R, X, Y, Z);
// rows_t (R,) int32 LUT rows of this sweep; mask (X, Y, Z) int8;
// h_q / w6 (X, Y, Z) int8; halos (R, plane) int8; lut (n_rows, lw)
// uint32; flips (R,) uint32 accumulates.  Returns cudaGetLastError().
extern "C" int pbit_sweep_int_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* rows_t, const void* mask, const void* h_q,
    const void* const* w6, const void* const* halos, const void* lut,
    int lw, int R, int X, int Y, int Z, void* flips, void* stream) {
  using namespace repro_torch;
  const dim3 grid(blocks_for(X * Y * Z), static_cast<unsigned>(R));
  sweep_int_phase_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m_in), static_cast<int8_t*>(m_out),
      static_cast<const uint32_t*>(s_in), static_cast<uint32_t*>(s_out),
      static_cast<const int32_t*>(rows_t), static_cast<const int8_t*>(mask),
      static_cast<const int8_t*>(h_q), six<int8_t>(w6), six<int8_t>(halos),
      static_cast<const uint32_t*>(lut), lw, X, Y, Z,
      static_cast<uint32_t*>(flips));
  return static_cast<int>(cudaGetLastError());
}
