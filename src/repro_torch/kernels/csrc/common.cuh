// Shared helpers of the lattice kernels: the brick index map, the
// neighbor read with fixed halo planes (per site, and per row of kW
// z-sites for the word kernels) and the xorshift32 LFSR step.
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

// Loads of the spin arrays: plain, or through L2 only (ld.global.cg) for
// buffers that other blocks of the same launch write: L1 is not coherent
// across SMs, and a const __restrict__ pointer may become ld.global.nc.
struct PlainLoad {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p) const { return *p; }
};
struct L2Load {
  template <typename T>
  __device__ __forceinline__ T operator()(const T* p) const {
    return __ldcg(p);
  }
};

// The six neighbor values of site i of the brick `m` (replica / word
// plane `r`): inside the brick from `m` (read with `ld`), across a face
// from that face's halo plane, laid out (R, Y, Z) for x faces, (R, X, Z)
// for y faces and (R, X, Y) for z faces.  Halos are held fixed between
// exchanges.
template <typename T, typename Load = PlainLoad>
__device__ __forceinline__ void neighbors(const T* m, const Six<T>& halo,
                                          int i, Site c, int r,
                                          int X, int Y, int Z, T nb[6],
                                          Load ld = Load()) {
  const int yz = Y * Z;
  nb[0] = c.x > 0 ? ld(m + i - yz) : halo.p[0][(static_cast<long long>(r) * Y + c.y) * Z + c.z];
  nb[1] = c.x < X - 1 ? ld(m + i + yz) : halo.p[1][(static_cast<long long>(r) * Y + c.y) * Z + c.z];
  nb[2] = c.y > 0 ? ld(m + i - Z) : halo.p[2][(static_cast<long long>(r) * X + c.x) * Z + c.z];
  nb[3] = c.y < Y - 1 ? ld(m + i + Z) : halo.p[3][(static_cast<long long>(r) * X + c.x) * Z + c.z];
  nb[4] = c.z > 0 ? ld(m + i - 1) : halo.p[4][(static_cast<long long>(r) * X + c.x) * Y + c.y];
  nb[5] = c.z < Z - 1 ? ld(m + i + 1) : halo.p[5][(static_cast<long long>(r) * X + c.x) * Y + c.y];
}

// -- rows of kW consecutive z-sites (the word kernels) ------------------------

// kW consecutive bytes (kW = 4: one aligned 32-bit load) as a word, byte q
// of the word being site q.
template <int kW>
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p) {
  if constexpr (kW == 4) return *reinterpret_cast<const unsigned*>(p);
  else return static_cast<uint8_t>(*p);
}

template <int kW>
__device__ __forceinline__ void store_bytes(int8_t* p, uint32_t v) {
  if constexpr (kW == 4) *reinterpret_cast<uint32_t*>(p) = v;
  else *p = static_cast<int8_t>(v);
}

__device__ __forceinline__ int8_t byte_of(uint32_t v, int q) {
  return static_cast<int8_t>(static_cast<uint8_t>(v >> (8 * q)));
}

// kW consecutive uint32 (kW = 4: one aligned 16 B load).
template <int kW>
struct Words {
  uint32_t v[kW];
};

template <int kW>
__device__ __forceinline__ Words<kW> load_words(const uint32_t* p) {
  Words<kW> w;
  if constexpr (kW == 4) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w.v[0] = u.x;
    w.v[1] = u.y;
    w.v[2] = u.z;
    w.v[3] = u.w;
  } else {
    for (int q = 0; q < kW; ++q) w.v[q] = __ldg(p + q);
  }
  return w;
}

// How a row of kW sites is read: int8 spins as one word of kW bytes
// (ByteRows), spin word planes as kW words (WordRows).
template <int kW_>
struct ByteRows {
  static constexpr int kW = kW_;
  using T = int8_t;
  using Row = uint32_t;
  __device__ static Row load(const T* p) { return load_bytes<kW>(p); }
  __device__ static T at(const Row& w, int q) { return byte_of(w, q); }
};

template <int kW_>
struct WordRows {
  static constexpr int kW = kW_;
  using T = uint32_t;
  using Row = Words<kW>;
  __device__ static Row load(const T* p) { return load_words<kW>(p); }
  __device__ static T at(const Row& w, int q) { return w.v[q]; }
};

// The neighbors of a row of kW z-sites: the -x, +x, -y and +y rows, and
// the z neighbors beyond the row's two ends.
template <class Rows>
struct NbrRows {
  typename Rows::Row xm, xp, ym, yp;
  typename Rows::T zm, zp;

  // the six neighbors of site q of the row, whose own row is `own`
  __device__ __forceinline__ void of(const typename Rows::Row& own, int q,
                                     typename Rows::T nb[6]) const {
    nb[0] = Rows::at(xm, q);
    nb[1] = Rows::at(xp, q);
    nb[2] = Rows::at(ym, q);
    nb[3] = Rows::at(yp, q);
    nb[4] = q > 0 ? Rows::at(own, q - 1) : zm;
    nb[5] = q < Rows::kW - 1 ? Rows::at(own, q + 1) : zp;
  }
};

// The neighbor rows of sites i0 .. i0 + kW - 1 (site i0 at c, c.z a
// multiple of kW) of the brick `m` (replica / word plane `r`): inside the
// brick from `m`, across a face from its halo plane (laid out as for
// neighbors()); one load per row.  Every pointer is read-only for the
// launch.
template <class Rows>
__device__ __forceinline__ NbrRows<Rows> nbr_rows(
    const typename Rows::T* m, const Six<typename Rows::T>& halo, int i0,
    Site c, int r, int X, int Y, int Z) {
  const int yz = Y * Z;
  const long long hx = (static_cast<long long>(r) * Y + c.y) * Z + c.z;
  const long long hy = (static_cast<long long>(r) * X + c.x) * Z + c.z;
  const long long hz = (static_cast<long long>(r) * X + c.x) * Y + c.y;
  NbrRows<Rows> n;
  n.xm = c.x > 0 ? Rows::load(m + i0 - yz) : Rows::load(halo.p[0] + hx);
  n.xp = c.x < X - 1 ? Rows::load(m + i0 + yz) : Rows::load(halo.p[1] + hx);
  n.ym = c.y > 0 ? Rows::load(m + i0 - Z) : Rows::load(halo.p[2] + hy);
  n.yp = c.y < Y - 1 ? Rows::load(m + i0 + Z) : Rows::load(halo.p[3] + hy);
  n.zm = c.z > 0 ? m[i0 - 1] : halo.p[4][hz];
  n.zp = c.z + Rows::kW < Z ? m[i0 + Rows::kW] : halo.p[5][hz];
  return n;
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

}  // namespace repro_torch
