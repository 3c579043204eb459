// Lattice p-bit color phases: int8 and f32, fused (with the flip count)
// and per phase.
//
// Replaces, in repro/kernels/pbit_lattice.py:
//   pbit_brick_sweep_int  (Pallas body _sweep_kernel_int)  by pbit_sweep_int_phase
//   pbit_brick_sweep      (Pallas body _sweep_kernel)      by pbit_sweep_f32_phase
//   pbit_brick_update_int (Pallas body _kernel_int)        by pbit_update_int_phase
//   pbit_brick_update     (Pallas body _kernel)            by pbit_update_f32_phase
// Each launch is one color phase of one brick for R replicas, with the six
// halo planes held fixed: per site the local field, one xorshift32 step of
// EVERY site's LFSR (masked or not), the accept and the masked write.  The
// site update is written once per precision (int_site, f32_site); the
// sweep entry points add the flip count, the update entry points do not.
//
// int8: the int32 field h_q + sum_d w_q[d] * m_d and the LUT accept
// u = s >> 8 >= T[row][f + f_off] (rows are monotone, so a direct lookup
// equals the reference's rank-count form; the LUT stays in L1).
// f32: the field h + wxm*xm + wxp*xp + wym*ym + wyp*yp + wzm*zm + wzp*zp in
// that order, act = beta * field, the optional fixed-point round (rintf:
// half to even, as jnp.round) and clip, and tanhf(act) + r >= 0 with the
// exact draw r = (s >> 8) * 2^-23 - 1.  Every product and sum is an
// explicit round-to-nearest intrinsic (and the library builds with
// --fmad=false), so the field and the activation round as the reference's
// do; tanhf is the CUDA math library's (no fast-math approximation), so the
// decision equals torch.tanh's on the card, and differs from XLA's tanh
// only where tanh(act) + r lies within a few ulp of 0.
//
// Phase visibility: the Pallas sweeps hold the whole brick in one VMEM
// block so phase c+1 reads what phase c wrote; blocks of a CUDA grid
// cannot see each other's writes, so the sweep wrappers launch once per
// (sweep, color) phase and ping-pong the spins between two buffers (each
// launch reads m_in and writes every site of m_out).  The launch boundary
// orders the phases, and the out-of-place write gives the reference's
// phase semantics for any masks.  The LFSR column advances in place (each
// thread owns its site).  All R replicas share one launch: grid
// (sites / 256, R).  The per-phase Pallas kernels tile x by bx to fit VMEM;
// the grid already tiles the brick here, so bx changes nothing.
//
// Bound on this card: memory traffic.  Per replica-site and phase a launch
// moves 1 B of spins in, 1 B out, 4 + 4 B of LFSR state, plus the shared
// constants per site (shared by the R replicas): 8 B on the int8 path
// (h_q, six w_q, mask), 29 B on the f32 path (f32 h and six w, int8
// mask).  Neighbor spins come from L1/L2.  At L=100 and R=4 the int8
// working set (two 4 MB spin buffers, 16 MB of LFSR state, 9 MB of
// constants, about 33 MB) fits the 50 MB L2; the f32 one (about 54 MB)
// does not quite, so its phases stream more from HBM.
#include "common.cuh"

namespace repro_torch {

// The optional fixed-point format of the f32 activation (s{a}{b}).
struct Fmt {
  int on;
  float step, lo, hi;
};

// New spin of site i of replica r on the int8 path; advances s.
__device__ __forceinline__ int8_t int_site(
    const int8_t* m, const Six<int8_t>& halo, int i, int r, int X, int Y,
    int Z, const int8_t* __restrict__ mask, const int8_t* __restrict__ h_q,
    const Six<int8_t>& w, const uint32_t* __restrict__ lut, int lw, int row,
    uint32_t& s) {
  int8_t nb[6];
  neighbors<int8_t>(m, halo, i, site_of(i, Y, Z), r, X, Y, Z, nb);
  int f = h_q[i];
  for (int d = 0; d < 6; ++d) f += static_cast<int>(w.p[d][i]) * nb[d];
  s = xorshift32(s);
  int idx = f + (lw - 1) / 2;
  idx = idx < 0 ? 0 : (idx > lw - 1 ? lw - 1 : idx);
  const uint32_t thr = lut[static_cast<long long>(row) * lw + idx];
  return mask[i] ? ((s >> 8) >= thr ? 1 : -1) : m[i];
}

// New spin of site i of replica r on the f32 path; advances s.
__device__ __forceinline__ int8_t f32_site(
    const int8_t* m, const Six<int8_t>& halo, int i, int r, int X, int Y,
    int Z, const int8_t* __restrict__ mask, const float* __restrict__ h,
    const Six<float>& w, float beta, const Fmt& fmt, uint32_t& s) {
  int8_t nb[6];
  neighbors<int8_t>(m, halo, i, site_of(i, Y, Z), r, X, Y, Z, nb);
  float f = h[i];
  for (int d = 0; d < 6; ++d)
    f = __fadd_rn(f, __fmul_rn(w.p[d][i], static_cast<float>(nb[d])));
  s = xorshift32(s);
  const float rnd = __fsub_rn(
      __fmul_rn(static_cast<float>(s >> 8), 2.0f / 16777216.0f), 1.0f);
  float act = __fmul_rn(beta, f);
  if (fmt.on)
    act = fminf(fmaxf(__fmul_rn(rintf(__fdiv_rn(act, fmt.step)), fmt.step),
                      fmt.lo), fmt.hi);
  return mask[i] ? (__fadd_rn(tanhf(act), rnd) >= 0.0f ? 1 : -1) : m[i];
}

// One int8 color phase; kCount adds each replica's changed sites to
// flips[r] (one atomic per block).
template <bool kCount>
__global__ void __launch_bounds__(kBlock)
int_phase_kernel(const int8_t* __restrict__ m_in, int8_t* __restrict__ m_out,
                 const uint32_t* s_in, uint32_t* s_out,
                 const int32_t* __restrict__ rows_t,
                 const int8_t* __restrict__ mask,
                 const int8_t* __restrict__ h_q, Six<int8_t> w,
                 Six<int8_t> halo, const uint32_t* __restrict__ lut, int lw,
                 int X, int Y, int Z, uint32_t* __restrict__ flips) {
  const int r = blockIdx.y;
  const int n = X * Y * Z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long off = static_cast<long long>(r) * n;
  bool changed = false;
  if (i < n) {
    const int8_t* m = m_in + off;
    uint32_t s = s_in[off + i];
    const int8_t nv = int_site(m, halo, i, r, X, Y, Z, mask, h_q, w, lut,
                               lw, rows_t[r], s);
    s_out[off + i] = s;
    m_out[off + i] = nv;
    changed = nv != m[i];
  }
  if constexpr (kCount) {
    const unsigned total = block_sum(changed ? 1u : 0u);
    if (threadIdx.x == 0 && total) atomicAdd(&flips[r], total);
  }
}

// One f32 color phase; kCount as above.
template <bool kCount>
__global__ void __launch_bounds__(kBlock)
f32_phase_kernel(const int8_t* __restrict__ m_in, int8_t* __restrict__ m_out,
                 const uint32_t* s_in, uint32_t* s_out,
                 const float* __restrict__ betas_t,
                 const int8_t* __restrict__ mask,
                 const float* __restrict__ h, Six<float> w, Six<int8_t> halo,
                 Fmt fmt, int X, int Y, int Z,
                 uint32_t* __restrict__ flips) {
  const int r = blockIdx.y;
  const int n = X * Y * Z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long off = static_cast<long long>(r) * n;
  bool changed = false;
  if (i < n) {
    const int8_t* m = m_in + off;
    uint32_t s = s_in[off + i];
    const int8_t nv = f32_site(m, halo, i, r, X, Y, Z, mask, h, w,
                               betas_t[r], fmt, s);
    s_out[off + i] = s;
    m_out[off + i] = nv;
    changed = nv != m[i];
  }
  if constexpr (kCount) {
    const unsigned total = block_sum(changed ? 1u : 0u);
    if (threadIdx.x == 0 && total) atomicAdd(&flips[r], total);
  }
}

template <bool kCount>
int launch_int(const void* m_in, void* m_out, const void* s_in, void* s_out,
               const void* rows_t, const void* mask, const void* h_q,
               const void* const* w6, const void* const* halos,
               const void* lut, int lw, int R, int X, int Y, int Z,
               void* flips, void* stream) {
  const dim3 grid(blocks_for(X * Y * Z), static_cast<unsigned>(R));
  int_phase_kernel<kCount><<<grid, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m_in), static_cast<int8_t*>(m_out),
      static_cast<const uint32_t*>(s_in), static_cast<uint32_t*>(s_out),
      static_cast<const int32_t*>(rows_t), static_cast<const int8_t*>(mask),
      static_cast<const int8_t*>(h_q), six<int8_t>(w6), six<int8_t>(halos),
      static_cast<const uint32_t*>(lut), lw, X, Y, Z,
      static_cast<uint32_t*>(flips));
  return static_cast<int>(cudaGetLastError());
}

template <bool kCount>
int launch_f32(const void* m_in, void* m_out, const void* s_in, void* s_out,
               const void* betas_t, const void* mask, const void* h,
               const void* const* w6, const void* const* halos, int fmt_on,
               float step, float lo, float hi, int R, int X, int Y, int Z,
               void* flips, void* stream) {
  const dim3 grid(blocks_for(X * Y * Z), static_cast<unsigned>(R));
  f32_phase_kernel<kCount><<<grid, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m_in), static_cast<int8_t*>(m_out),
      static_cast<const uint32_t*>(s_in), static_cast<uint32_t*>(s_out),
      static_cast<const float*>(betas_t), static_cast<const int8_t*>(mask),
      static_cast<const float*>(h), six<float>(w6), six<int8_t>(halos),
      Fmt{fmt_on, step, lo, hi}, X, Y, Z, static_cast<uint32_t*>(flips));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// Common arguments: m_in / m_out (R, X, Y, Z) int8, distinct; s_in /
// s_out (R, X, Y, Z) uint32, which may be the same buffer; mask (X, Y, Z)
// int8 (this color); w6 six and h one (X, Y, Z) constant arrays; halos six
// (R, plane) int8.  Each returns cudaGetLastError() right after the launch.

// int8 sweep phase: rows_t (R,) int32 LUT rows of this sweep; h_q / w6
// int8; lut (n_rows, lw) uint32; flips (R,) uint32 accumulates.
extern "C" int pbit_sweep_int_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* rows_t, const void* mask, const void* h_q,
    const void* const* w6, const void* const* halos, const void* lut,
    int lw, int R, int X, int Y, int Z, void* flips, void* stream) {
  return repro_torch::launch_int<true>(m_in, m_out, s_in, s_out, rows_t,
                                       mask, h_q, w6, halos, lut, lw, R, X,
                                       Y, Z, flips, stream);
}

// int8 single phase: as above, without the flip count.
extern "C" int pbit_update_int_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* rows_t, const void* mask, const void* h_q,
    const void* const* w6, const void* const* halos, const void* lut,
    int lw, int R, int X, int Y, int Z, void* stream) {
  return repro_torch::launch_int<false>(m_in, m_out, s_in, s_out, rows_t,
                                        mask, h_q, w6, halos, lut, lw, R, X,
                                        Y, Z, nullptr, stream);
}

// f32 sweep phase: betas_t (R,) f32 betas of this sweep; h / w6 f32;
// fmt_on, step, lo, hi the activation's fixed-point format (fmt_on = 0:
// none); flips (R,) uint32 accumulates.
extern "C" int pbit_sweep_f32_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* betas_t, const void* mask, const void* h,
    const void* const* w6, const void* const* halos, int fmt_on, float step,
    float lo, float hi, int R, int X, int Y, int Z, void* flips,
    void* stream) {
  return repro_torch::launch_f32<true>(m_in, m_out, s_in, s_out, betas_t,
                                       mask, h, w6, halos, fmt_on, step, lo,
                                       hi, R, X, Y, Z, flips, stream);
}

// f32 single phase: as above, without the flip count.
extern "C" int pbit_update_f32_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* betas_t, const void* mask, const void* h,
    const void* const* w6, const void* const* halos, int fmt_on, float step,
    float lo, float hi, int R, int X, int Y, int Z, void* stream) {
  return repro_torch::launch_f32<false>(m_in, m_out, s_in, s_out, betas_t,
                                        mask, h, w6, halos, fmt_on, step, lo,
                                        hi, R, X, Y, Z, nullptr, stream);
}
