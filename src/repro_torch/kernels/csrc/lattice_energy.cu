// Brick Ising energy, one f32 per replica.
//
// Replaces repro/kernels/lattice_energy.py::brick_energy (Pallas body
// _kernel): E = sum_i active_i * (-1/2 m_i sum_d w_d m_d - h_i m_i) with
// the neighbor spins read through the halo planes, on the f32 (unquantized)
// h and w6.  Two spin layouts share one kernel body: int8 spins (R, X, Y, Z)
// with int8 halos, and the bit-plane engine's W uint32 word planes with
// word halos (lane b of plane w is replica w * 32 + b, bit 1 = +1), read
// without unpacking.  The Pallas x tile bx is a VMEM device: the wrapper
// only checks that it divides X, and the result does not depend on it.
//
// What bounds it: 17 FP32 operations per replica-site, and bytes: 1 B of
// spins per replica-site (int8; 1 bit in word planes) plus 29 B of f32 and
// int8 constants per site.  At L=100, R=64 the operations bound it (32 us);
// at R=4 the bytes (10 us).  The one-thread-per-replica-site design it
// replaces re-read the 29 B of constants once per replica (1.9 GB per call
// at R=64), folded block sums into out[r] with float atomics in no fixed
// order, and on the bit-plane path needed the word planes unpacked to int8
// first.  What this design does:
// - One thread per word of kW = 4 consecutive z-sites (or one site where
//   rows are not word-aligned), looping over all replicas: the word's
//   constants are loaded once (float4 per plane) and serve every replica.
// - Spins come in rows through nbr_rows (shared with the single phases):
//   int8 rows as 32-bit words, the rows of kGroup replicas loaded before
//   any is used; word planes as 16 B per row, each word of neighbors
//   loaded once for its 32 lanes; dead lanes >= R are skipped.
// - Per site the Pallas kernel's operation order, each step rounded to
//   nearest (the library builds with --fmad=false): pair = w0 m0 + ... +
//   w5 m5 left to right, then (-0.5 (m pair) - h m) * active.  A product by
//   a +-1 spin is an exact sign flip, so it is one XOR of the float's sign
//   bit with the spin's (a byte's bit 7, a lane's bit shifted to bit 31);
//   a zero (open-face) halo spin contributes w * 0, by a select, in the
//   rows that hold one.
// - A fixed-order reduction, no float atomics: per thread its kW sites in
//   order, per warp a shuffle tree, per block the warps in order into a
//   (blocks, R) buffer, and a second kernel sums each replica's block
//   partials (each thread a stride of blocks in order, then the same warp
//   and block order).  Equal spins give equal bits on every call, on any
//   couplings, and the word planes give the int8 layout's bits.
#include "common.cuh"

namespace repro_torch {

constexpr int kWarps = kBlock / 32;

// Sum over the warp by a fixed shuffle tree, valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The sum of kWarps per-warp values, in warp order.
__device__ __forceinline__ float warps_sum(const float* part) {
  float t = 0.0f;
  for (int j = 0; j < kWarps; ++j) t = __fadd_rn(t, part[j]);
  return t;
}

constexpr uint32_t kSign = 0x80000000u;

// w times a spin whose sign is bit 31 of s (set: -1, clear: +1): an exact
// sign flip, the bits of the product.
__device__ __forceinline__ float flip(float w, uint32_t s) {
  return __uint_as_float(__float_as_uint(w) ^ (s & kSign));
}

// w times a spin s in {-1, 0, +1}, rounded as the product would be.
__device__ __forceinline__ float times(float w, int8_t s) {
  return s > 0 ? w : (s < 0 ? -w : __fmul_rn(w, 0.0f));
}

// The constants of one site, loaded once for every replica.
struct SiteConsts {
  float h, act, w[6];
};

template <int kW>
__device__ __forceinline__ void load_consts(
    int i0, const int8_t* __restrict__ active, const float* __restrict__ h,
    const Six<float>& w, SiteConsts (&k)[kW]) {
  const uint32_t a = load_bytes<kW>(active + i0);
  if constexpr (kW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(h + i0));
    k[0].h = v.x;
    k[1].h = v.y;
    k[2].h = v.z;
    k[3].h = v.w;
    for (int d = 0; d < 6; ++d) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(w.p[d] + i0));
      k[0].w[d] = u.x;
      k[1].w[d] = u.y;
      k[2].w[d] = u.z;
      k[3].w[d] = u.w;
    }
  } else {
    for (int q = 0; q < kW; ++q) {
      k[q].h = __ldg(h + i0 + q);
      for (int d = 0; d < 6; ++d) k[q].w[d] = __ldg(w.p[d] + i0 + q);
    }
  }
  for (int q = 0; q < kW; ++q)
    k[q].act = static_cast<float>(byte_of(a, q));
}

// The energy of one site in the Pallas kernel's order, (-0.5 * (mc *
// pair) - h * mc) * active, pair = w0 m0 + ... + w5 m5; each product by a
// spin is `mul` (w, spin) -> the rounded product.
template <class S, class Mul>
__device__ __forceinline__ float site_energy(const SiteConsts& k, S mc,
                                             const S nb[6], Mul mul) {
  float pair = mul(k.w[0], nb[0]);
  for (int d = 1; d < 6; ++d) pair = __fadd_rn(pair, mul(k.w[d], nb[d]));
  const float e = __fsub_rn(__fmul_rn(-0.5f, mul(pair, mc)), mul(k.h, mc));
  return __fmul_rn(e, k.act);
}

// The energy of a row of kW sites: `own` and `nb` give each site's spin
// and six neighbors as S, multiplied by `mul`; summed in site order.
template <int kW, class S, class Mul>
__device__ __forceinline__ float row_energy(const SiteConsts (&k)[kW],
                                            const S (&own)[kW],
                                            const S (&nb)[kW][6], Mul mul) {
  float e = 0.0f;
#pragma unroll
  for (int q = 0; q < kW; ++q)
    e = __fadd_rn(e, site_energy(k[q], own[q], nb[q], mul));
  return e;
}

struct Flip {
  __device__ float operator()(float w, uint32_t s) const { return flip(w, s); }
};
struct Times {
  __device__ float operator()(float w, int8_t s) const { return times(w, s); }
};

// Replicas whose rows one thread loads before it computes any of them.
constexpr int kGroup = 4;

// int8 spins (R, X, Y, Z) and halos (R, plane): calls f(r, e) for r = 0 ..
// R-1 in order, e the thread's row energy of replica r (0 where it has no
// row).  Spins are +-1 and halo spins +-1 or 0 (an open face): a row with
// no zero takes each product as a sign flip (bit 7 of the byte), else the
// select of times().
struct Int8Spins {
  const int8_t* __restrict__ m;
  Six<int8_t> halo;
  int R;

  template <int kW, class F>
  __device__ __forceinline__ void each(bool live, int i0, Site c,
                                       const SiteConsts (&k)[kW], int X,
                                       int Y, int Z, F&& f) const {
    const long long n = static_cast<long long>(X) * Y * Z;
    constexpr uint32_t kOnes = kW == 4 ? 0x01010101u : 0x01u;
    for (int r0 = 0; r0 < R; r0 += kGroup) {
      uint32_t own[kGroup];
      NbrRows<ByteRows<kW>> rows[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        own[u] = kOnes;
        if (live && r0 + u < R) {
          const int8_t* mr = m + (r0 + u) * n;
          own[u] = load_bytes<kW>(mr + i0);
          rows[u] = nbr_rows<ByteRows<kW>>(mr, halo, i0, c, r0 + u, X, Y,
                                           Z);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (r0 + u >= R) break;
        float e = 0.0f;
        if (live) {
          const NbrRows<ByteRows<kW>>& nr = rows[u];
          // +-1 bytes have bit 0 set, a zero byte has not
          const bool signs = (own[u] & nr.xm & nr.xp & nr.ym & nr.yp &
                              kOnes) == kOnes && (nr.zm & nr.zp & 1);
          if (signs) {
            uint32_t sp[kW], sn[kW][6];
#pragma unroll
            for (int q = 0; q < kW; ++q) {
              sp[q] = own[u] << (24 - 8 * q);
              sn[q][0] = nr.xm << (24 - 8 * q);
              sn[q][1] = nr.xp << (24 - 8 * q);
              sn[q][2] = nr.ym << (24 - 8 * q);
              sn[q][3] = nr.yp << (24 - 8 * q);
            }
#pragma unroll
            for (int q = 0; q < kW; ++q) {
              sn[q][4] = q > 0 ? sp[q - 1]
                               : static_cast<uint32_t>(
                                     static_cast<int32_t>(nr.zm));
              sn[q][5] = q < kW - 1 ? sp[q + 1]
                                    : static_cast<uint32_t>(
                                          static_cast<int32_t>(nr.zp));
            }
            e = row_energy<kW>(k, sp, sn, Flip());
          } else {
            int8_t sp[kW], sn[kW][6];
#pragma unroll
            for (int q = 0; q < kW; ++q) {
              sp[q] = byte_of(own[u], q);
              nr.of(own[u], q, sn[q]);
            }
            e = row_energy<kW>(k, sp, sn, Times());
          }
        }
        f(r0 + u, e);
      }
    }
  }
};

// W word planes (W, X, Y, Z) and word halos (W, plane) holding R lanes:
// each plane's rows are loaded once, then f(w * 32 + b, e) for its live
// lanes b in order.  Lane b's spins are bit b of each word (1: +1), taken
// to bit 31 by one shift and inverted for flip().
struct LaneSpins {
  const uint32_t* __restrict__ mw;
  Six<uint32_t> halo;
  int W, R;

  template <int kW, class F>
  __device__ __forceinline__ void each(bool live, int i0, Site c,
                                       const SiteConsts (&k)[kW], int X,
                                       int Y, int Z, F&& f) const {
    const long long n = static_cast<long long>(X) * Y * Z;
    for (int p = 0; p < W; ++p) {
      Words<kW> own{};
      NbrRows<WordRows<kW>> rows{};
      if (live) {
        const uint32_t* mp = mw + p * n;
        own = load_words<kW>(mp + i0);
        rows = nbr_rows<WordRows<kW>>(mp, halo, i0, c, p, X, Y, Z);
      }
      const int lanes = min(32, R - 32 * p);
      for (int b = 0; b < lanes; ++b) {
        const int sh = 31 - b;
        uint32_t sp[kW], sn[kW][6];
#pragma unroll
        for (int q = 0; q < kW; ++q) {
          sp[q] = ~(own.v[q] << sh);
          sn[q][0] = ~(rows.xm.v[q] << sh);
          sn[q][1] = ~(rows.xp.v[q] << sh);
          sn[q][2] = ~(rows.ym.v[q] << sh);
          sn[q][3] = ~(rows.yp.v[q] << sh);
        }
#pragma unroll
        for (int q = 0; q < kW; ++q) {
          sn[q][4] = q > 0 ? sp[q - 1] : ~(rows.zm << sh);
          sn[q][5] = q < kW - 1 ? sp[q + 1] : ~(rows.zp << sh);
        }
        f(32 * p + b, live ? row_energy<kW>(k, sp, sn, Flip()) : 0.0f);
      }
    }
  }
};

// First pass: block b's sum of each replica's energy over its threads'
// rows into partials[b * R + r].  Dynamic shared memory: R x kWarps f32.
template <class Spins, int kW>
__global__ void __launch_bounds__(kBlock)
energy_kernel(Spins sp, const int8_t* __restrict__ active,
              const float* __restrict__ h, Six<float> w, int R, int X, int Y,
              int Z, float* __restrict__ partials) {
  extern __shared__ float warp_part[];
  const int n = X * Y * Z;
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = wi < n / kW;
  const int i0 = live ? wi * kW : 0;
  const int warp = threadIdx.x >> 5;
  const Site c = site_of(i0, Y, Z);
  SiteConsts k[kW];
  if (live) load_consts<kW>(i0, active, h, w, k);
  sp.template each<kW>(live, i0, c, k, X, Y, Z, [&](int r, float e) {
    e = warp_sum(e);
    if ((threadIdx.x & 31) == 0) warp_part[r * kWarps + warp] = e;
  });
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kBlock)
    partials[static_cast<long long>(blockIdx.x) * R + r] =
        warps_sum(warp_part + r * kWarps);
}

// Second pass, block r: out[r] = the sum of partials[b * R + r] over b.
__global__ void __launch_bounds__(kBlock)
energy_sum_kernel(const float* __restrict__ partials, int blocks, int R,
                  float* __restrict__ out) {
  __shared__ float warp_part[kWarps];
  const int r = blockIdx.x;
  float e = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += kBlock)
    e = __fadd_rn(e, partials[static_cast<long long>(b) * R + r]);
  e = warp_sum(e);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x == 0) out[r] = warps_sum(warp_part);
}

template <class Spins, int kW>
int launch_energy_w(const Spins& sp, const void* active, const void* h,
                    const void* const* w6, int R, int X, int Y, int Z,
                    int blocks, void* partials, void* out,
                    cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * static_cast<size_t>(R);
  const auto kern = &energy_kernel<Spins, kW>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)   // above the default, by opt-in (R > 1536)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, kBlock, smem, stream>>>(
      sp, static_cast<const int8_t*>(active), static_cast<const float*>(h),
      six<float>(w6), R, X, Y, Z, static_cast<float*>(partials));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  energy_sum_kernel<<<R, kBlock, 0, stream>>>(
      static_cast<const float*>(partials), blocks, R,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Both passes at `width` z-sites per thread (4: Z a multiple of 4; or 1)
// over `blocks` blocks, which must be blocks_for(X * Y * Z / width).
template <class Spins>
int launch_energy(const Spins& sp, int width, const void* active,
                  const void* h, const void* const* w6, int R, int X, int Y,
                  int Z, int blocks, void* partials, void* out,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = (width == 4 && Z % 4 == 0) || width == 1;
  if (!ok || R < 1 || static_cast<unsigned>(blocks) !=
                          blocks_for(X * Y * Z / width))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width == 4)
    return launch_energy_w<Spins, 4>(sp, active, h, w6, R, X, Y, Z, blocks,
                                     partials, out, st);
  return launch_energy_w<Spins, 1>(sp, active, h, w6, R, X, Y, Z, blocks,
                                   partials, out, st);
}

}  // namespace repro_torch

// Common arguments: active (X, Y, Z) int8; h / w6 (X, Y, Z) f32; width 4
// (Z a multiple of 4, h / w6 and the word planes and their x / y halos 16 B
// aligned, the int8 arrays 4 B aligned) or 1, the z-sites per thread;
// blocks = ceil(X * Y * Z / width / 256); partials (blocks, R) f32 scratch;
// out (R,) f32, written (no need to zero it).  Each returns the launches'
// cudaError_t (cudaErrorInvalidValue, and no launch, for a width or block
// count other than these).

// Energies of R int8 replicas: m (R, X, Y, Z) int8; halos six (R, plane)
// int8.
extern "C" int brick_energy(const void* m, const void* active, const void* h,
                            const void* const* w6, const void* const* halos,
                            int R, int X, int Y, int Z, int width, int blocks,
                            void* partials, void* out, void* stream) {
  using namespace repro_torch;
  const Int8Spins sp{static_cast<const int8_t*>(m), six<int8_t>(halos), R};
  return launch_energy(sp, width, active, h, w6, R, X, Y, Z, blocks,
                       partials, out, stream);
}

// Energies of the R lanes of W word planes: mw (W, X, Y, Z) uint32; halos
// six (W, plane) uint32; R in (32 (W - 1), 32 W].
extern "C" int brick_energy_words(const void* mw, const void* active,
                                  const void* h, const void* const* w6,
                                  const void* const* halos, int W, int R,
                                  int X, int Y, int Z, int width, int blocks,
                                  void* partials, void* out, void* stream) {
  using namespace repro_torch;
  if (R <= 32 * (W - 1) || R > 32 * W)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaneSpins sp{static_cast<const uint32_t*>(mw), six<uint32_t>(halos),
                     W, R};
  return launch_energy(sp, width, active, h, w6, R, X, Y, Z, blocks,
                       partials, out, stream);
}
