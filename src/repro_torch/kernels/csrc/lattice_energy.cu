// Brick Ising energy, one f32 per replica.
//
// Replaces repro/kernels/lattice_energy.py::brick_energy (Pallas body
// _kernel): E = sum_i active_i * (-1/2 m_i sum_d w_d m_d - h_i m_i) with
// the neighbor spins read through the halo planes, on the f32 (unquantized)
// h and w6.  The Pallas kernel walks x-tiles in order and accumulates into
// one scalar; here every thread takes one site, a block reduces its sites
// with warp shuffles and shared memory, and one atomicAdd per block folds
// the block sum into out[r].  Grid (sites / 256, R).
//
// Bound on this card: memory traffic — 1 B of spins per replica-site plus
// 29 B of shared f32/int8 constants per site, ~17 flops per replica-site.
// Summation order differs from the reference; on +-J instances every
// partial sum is a half-integer below 2^22 at L=100, so any order gives
// the same f32 bits.  The per-site expression keeps the Pallas kernel's
// operation order and the library is built with --fmad=false, so products
// are rounded as the reference rounds them.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kBlock)
energy_kernel(const int8_t* __restrict__ m_all,
              const int8_t* __restrict__ active,
              const float* __restrict__ h, Six<float> w, Six<int8_t> halo,
              int X, int Y, int Z, float* __restrict__ out) {
  __shared__ float warp_sums[kBlock / 32];
  const int r = blockIdx.y;
  const int n = X * Y * Z;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float e = 0.0f;
  if (i < n) {
    const int8_t* m = m_all + static_cast<long long>(r) * n;
    int8_t nb[6];
    neighbors<int8_t>(m, halo, i, site_of(i, Y, Z), r, X, Y, Z, nb);
    float pair = w.p[0][i] * static_cast<float>(nb[0]);
    for (int d = 1; d < 6; ++d) pair = pair + w.p[d][i] * static_cast<float>(nb[d]);
    const float mc = static_cast<float>(m[i]);
    e = (-0.5f * (mc * pair) - h[i] * mc) * static_cast<float>(active[i]);
  }
  for (int o = 16; o > 0; o >>= 1) e += __shfl_down_sync(0xffffffffu, e, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x < 32) {
    e = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) e += __shfl_down_sync(0xffffffffu, e, o);
    if (threadIdx.x == 0) atomicAdd(&out[r], e);
  }
}

}  // namespace repro_torch

// Energies of R replicas of one brick.  m (R, X, Y, Z) int8; active
// (X, Y, Z) int8; h / w6 (X, Y, Z) f32; halos (R, plane) int8; out (R,)
// f32, zeroed by the caller.  Returns cudaGetLastError().
extern "C" int brick_energy(const void* m, const void* active, const void* h,
                            const void* const* w6, const void* const* halos,
                            int R, int X, int Y, int Z, void* out,
                            void* stream) {
  using namespace repro_torch;
  const dim3 grid(blocks_for(X * Y * Z), static_cast<unsigned>(R));
  energy_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m), static_cast<const int8_t*>(active),
      static_cast<const float*>(h), six<float>(w6), six<int8_t>(halos), X, Y,
      Z, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
