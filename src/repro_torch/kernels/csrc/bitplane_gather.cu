// ELL word gather and bit-sliced count of the +1 neighbour contributions
// of one colour's sites, for every partition of a one-process mesh.
//
// Replaces repro/kernels/ops.py::bitplane_gather_count_op (the plain jnp
// repro/kernels/ref.py::bitplane_gather_count_ref; it has no Pallas
// original), the field accumulator of the bit-plane path of
// repro/core/dsim_dist.py.  For partition k, word plane w and colour site
// i it gathers the D words mext[k, w, idx[k, i, d]], takes each one's
// contribution plane (word ^ signs[k, i, d]) & nz[k, i, d] and ripple-adds
// the D planes into bit-slice planes as the plain version does: a new
// slice is appended only when the count can reach the next power of two,
// so the result has ceil(log2(D+1)) slices, in the plain version's order
// and with its bits.
//
// One thread per (k, i): it loads the D indices, signs and nonzero masks
// once, into registers, and loops over the W word planes, so the
// lane-independent constants are read once and not W times.  D is a
// runtime value up to 31 (at most 5 slices); the register arrays are
// sized by a compile-time bucket of D (8, 16 or 32) so that every index
// into them is a constant.
//
// Grid: (K * nc / 256).
#include "common.cuh"

namespace repro_torch {

constexpr int kMaxSlices = 5;   // D <= 31

template <int kMaxD>
__global__ void __launch_bounds__(kBlock)
bitplane_gather_count_kernel(const uint32_t* __restrict__ mext,
                             const int32_t* __restrict__ idx,
                             const uint32_t* __restrict__ signs,
                             const uint32_t* __restrict__ nz,
                             uint32_t* __restrict__ out, int K, int W,
                             int n_ext, int nc, int D, int P) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(K) * nc) return;
  const int k = static_cast<int>(t / nc);
  const int i = static_cast<int>(t - static_cast<long long>(k) * nc);
  const long long row = t * D;
  int nb[kMaxD];
  uint32_t sg[kMaxD], nzm[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d < D) {
      nb[d] = idx[row + d];
      sg[d] = signs[row + d];
      nzm[d] = nz[row + d];
    }
  }
  const long long plane = static_cast<long long>(K) * W * nc;
  for (int w = 0; w < W; ++w) {
    const long long kw = static_cast<long long>(k) * W + w;
    const uint32_t* pool = mext + kw * n_ext;
    uint32_t sl[kMaxSlices];
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) sl[j] = 0u;
    int len = 0;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) {
        uint32_t carry = (pool[nb[d]] ^ sg[d]) & nzm[d];
#pragma unroll
        for (int j = 0; j < kMaxSlices; ++j) {
          if (j < len) {
            const uint32_t s = sl[j];
            sl[j] = s ^ carry;
            carry = s & carry;
          }
        }
        if ((1 << len) <= d + 1) {
#pragma unroll
          for (int j = 0; j < kMaxSlices; ++j)
            if (j == len) sl[j] = carry;
          ++len;
        }
      }
    }
    uint32_t* o = out + kw * nc + i;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j)
      if (j < P) o[j * plane] = sl[j];
  }
}

}  // namespace repro_torch

// mext (K, W, n_ext) uint32 word pools; idx (K, nc, D) int32 slots into
// [0, n_ext); signs, nz (K, nc, D) uint32; out (P, K, W, nc) uint32 with
// P = ceil(log2(D+1)), 1 <= D <= 31.  Returns cudaGetLastError().
extern "C" int bitplane_gather_count(const void* mext, const void* idx,
                                     const void* signs, const void* nz,
                                     void* out, int K, int W, int n_ext,
                                     int nc, int D, void* stream) {
  using namespace repro_torch;
  int P = 0;
  while ((1 << P) <= D) ++P;
  auto kern = D <= 8    ? bitplane_gather_count_kernel<8>
              : D <= 16 ? bitplane_gather_count_kernel<16>
                        : bitplane_gather_count_kernel<32>;
  kern<<<blocks_for(K * nc), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mext), static_cast<const int32_t*>(idx),
      static_cast<const uint32_t*>(signs), static_cast<const uint32_t*>(nz),
      static_cast<uint32_t*>(out), K, W, n_ext, nc, D, P);
  return static_cast<int>(cudaGetLastError());
}
