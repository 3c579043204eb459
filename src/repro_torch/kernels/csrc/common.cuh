// Shared helpers of the lattice kernels: the brick index map, the
// neighbor read with fixed halo planes, and the xorshift32 LFSR step.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kBlock = 256;   // threads per block; a multiple of 32

// Six pointers passed by value: (-x, +x, -y, +y, -z, +z).
template <typename T>
struct Six {
  const T* p[6];
};

template <typename T>
inline Six<T> six(const void* const* ptrs) {
  Six<T> s;
  for (int d = 0; d < 6; ++d) s.p[d] = static_cast<const T*>(ptrs[d]);
  return s;
}

// Site i = (x*Y + y)*Z + z of one (X, Y, Z) brick.  32-bit unsigned
// division: the wrappers keep X*Y*Z below 2^30, and a 64-bit division is
// a long software sequence on this card.
struct Site {
  int x, y, z;
};

__device__ __forceinline__ Site site_of(int i, int Y, int Z) {
  const unsigned u = static_cast<unsigned>(i);
  const unsigned xy = u / static_cast<unsigned>(Z);
  Site s;
  s.z = static_cast<int>(u - xy * static_cast<unsigned>(Z));
  s.x = static_cast<int>(xy / static_cast<unsigned>(Y));
  s.y = static_cast<int>(xy - static_cast<unsigned>(s.x) * static_cast<unsigned>(Y));
  return s;
}

// The six neighbor values of site i of the brick `m` (replica / word
// plane `r`): inside the brick from `m`, across a face from that face's
// halo plane, laid out (R, Y, Z) for x faces, (R, X, Z) for y faces and
// (R, X, Y) for z faces.  Halos are held fixed between exchanges.
template <typename T>
__device__ __forceinline__ void neighbors(const T* m, const Six<T>& halo,
                                          int i, Site c, int r,
                                          int X, int Y, int Z, T nb[6]) {
  const int yz = Y * Z;
  nb[0] = c.x > 0 ? m[i - yz] : halo.p[0][(static_cast<long long>(r) * Y + c.y) * Z + c.z];
  nb[1] = c.x < X - 1 ? m[i + yz] : halo.p[1][(static_cast<long long>(r) * Y + c.y) * Z + c.z];
  nb[2] = c.y > 0 ? m[i - Z] : halo.p[2][(static_cast<long long>(r) * X + c.x) * Z + c.z];
  nb[3] = c.y < Y - 1 ? m[i + Z] : halo.p[3][(static_cast<long long>(r) * X + c.x) * Z + c.z];
  nb[4] = c.z > 0 ? m[i - 1] : halo.p[4][(static_cast<long long>(r) * X + c.x) * Y + c.y];
  nb[5] = c.z < Z - 1 ? m[i + 1] : halo.p[5][(static_cast<long long>(r) * X + c.x) * Y + c.y];
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

inline unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

// Sum of `v` over the block, valid in thread 0; every thread must call it.
__device__ __forceinline__ unsigned block_sum(unsigned v) {
  __shared__ unsigned warp_part[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x == 0)
    for (int k = 0; k < kBlock / 32; ++k) v += warp_part[k];
  return v;
}

}  // namespace repro_torch
