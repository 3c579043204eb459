// Lattice p-bit color phases: int8 and f32, fused sweeps and single
// phases.
//
// Replaces, in repro/kernels/pbit_lattice.py:
//   pbit_brick_sweep_int  (Pallas body _sweep_kernel_int)  by pbit_sweep_int_persistent
//   pbit_brick_sweep      (Pallas body _sweep_kernel)      by pbit_sweep_f32_persistent
//   pbit_brick_update_int (Pallas body _kernel_int)        by pbit_update_int_phase
//   pbit_brick_update     (Pallas body _kernel)            by pbit_update_f32_phase
// A site update is written once per precision: the functors Int8Update
// and F32Update (a site's constants are loaded once and serve every
// replica) for both persistent sweeps and the f32 phase, and int_site
// (Int8Update's arithmetic) for the int8 phase.
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
// The int8 single phase: one launch per color phase, all R replicas in
// one grid (sites / 256, R); per site the local field, one xorshift32 step
// of EVERY site's LFSR (masked or not), the accept and the masked write of
// every site of m_out (spins ping-pong between two buffers; the launch
// boundary orders the phases); with a flips buffer, each replica's changed
// sites are counted (one atomic per block).  Bound: memory traffic, 10 B
// per replica-site plus 8 B per site of constants.
//
// The f32 single phase (word_phase_kernel).  What bounds it: bytes, 10 B
// per replica-site (LFSR state in and out, spin in and out) and 29 B per
// site of constants and mask; at L=100, R=4 about 69 MB, 21 us at the HBM
// rate.  The one-thread-per-replica-site design it replaces re-read the 28
// B of constants per replica (more than L2 keeps beside the spins and
// states), ran the field, draw and tanhf on the masked-off half of every
// warp and loaded each neighbor as a byte.  What this design does:
// - One thread per word of kW = 4 consecutive z-sites (or one site where
//   rows are not word-aligned), looping over the R replicas: the word's
//   constants are loaded once (16 B per plane) and serve every replica.
// - States move as 16 B, spins as 32-bit words: own, +-x and +-y rows; the
//   z neighbors of the word's sites come from the own word by bytes, plus
//   the adjacent byte on each side, or the z halo at a face.
// - Every state advances; the field, draw and tanhf run only at the
//   word's masked sites, in the order and rounding of the arithmetic above.
// - With a flips buffer (the engine's per-phase dispatch), each replica's
//   changed sites are summed per warp, then per block in shared memory,
//   and added with one atomic per block per replica.
//
// The fused sweeps are one persistent cooperative launch per call of S
// sweeps (persistent_sweep_kernel<Update, kResident>, and for int8
// persistent_sweep_inflight_kernel<Int8Update, kResident>).  What
// bounds them: per phase every replica-site's LFSR advances (integer work)
// and the masked sites are decided from the site's constants (7 B int8,
// 28 B f32) and six neighbor spins per replica.  At L=100, R=4 the bytes
// of a call (tens of MB, each read once) are of the order of its INT32
// work; in practice the decided sites' dependent chain (list entry,
// constants, neighbor spins from L2, the LUT entry or tanhf) sets the
// pace, so the design removes everything else from each phase.  The
// per-launch design it replaces moved the LFSR states in and out of device
// memory per phase, re-read the constants per replica, computed
// masked-off sites and paid a launch per phase.  What this design does:
// - Every block is resident (grid = blocks per SM x SMs, from the
//   occupancy query of each instantiation) and owns a fixed tile of sites
//   for all R replicas; cooperative_groups grid.sync() separates
//   consecutive (sweep, color) phases in place of the launch boundary.
//   Halos stay fixed for the call.
// - The tile's LFSR states live in dynamic shared memory for the whole call
//   (loaded once, written back once) when they fit (kResident, chosen by
//   the wrapper by size); otherwise the same kernel keeps them in device
//   memory.  Per phase every owned state advances once.
// - Per-tile color lists, built once at kernel start by ballot compaction,
//   hold the sites of each mask (a site may be in several), so field,
//   draw and accept run only at masked sites and warps do not diverge on
//   the checkerboard.  Each site's constants are loaded once per phase for
//   all R replicas.
// - The int8 sweep: each thread takes kInt8InFlight list entries per
//   pass and issues all their loads (list entries, constants, then per
//   replica the neighbor spins, states and own spins) before the first
//   use, so the L2 latencies of several decided sites overlap; its
//   registers are capped to keep two 512-thread blocks per SM.  The f32
//   sweep takes one entry per pass.
// - Spins ping-pong between two global buffers; each phase copies the
//   tile's spins forward (16 B loads) and overwrites the masked ones, so
//   any masks keep the reference's phase semantics.  A buffer written by
//   other blocks in the previous phase is read through L2 only
//   (ld.global.cg), never through L1 or the read-only path.
// - Per-replica flips are summed in shared memory for the whole call, one
//   atomic per block per replica at the end.
#include "common.cuh"

#include <cooperative_groups.h>

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

// -- the site updates as functors ------------------------------------------

// f32: the constants of a site are loaded once and serve every replica.
struct F32Update {
  const float* __restrict__ h;
  Six<float> w;
  const float* __restrict__ betas;   // (S, R)
  Fmt fmt;
  int R;

  struct Consts {
    float h, w[6];
  };

  __device__ __forceinline__ Consts load(int i) const {
    Consts k;
    k.h = __ldg(h + i);
    for (int d = 0; d < 6; ++d) k.w[d] = __ldg(w.p[d] + i);
    return k;
  }

  // the constants of sites i0 .. i0 + kW - 1; kW = 4 takes one 16 B load
  // per plane (i0 a multiple of 4, the planes 16 B aligned)
  template <int kW>
  __device__ __forceinline__ void load_word(int i0, Consts (&k)[kW]) const {
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
      for (int q = 0; q < kW; ++q) k[q] = load(i0 + q);
    }
  }

  // the accept of replica r in sweep t from the advanced state s
  __device__ __forceinline__ bool accept(const Consts& k, const int8_t nb[6],
                                         int t, int r, uint32_t s) const {
    float f = k.h;
    for (int d = 0; d < 6; ++d)
      f = __fadd_rn(f, __fmul_rn(k.w[d], static_cast<float>(nb[d])));
    const float rnd = __fsub_rn(
        __fmul_rn(static_cast<float>(s >> 8), 2.0f / 16777216.0f), 1.0f);
    float act = __fmul_rn(__ldg(betas + static_cast<long long>(t) * R + r),
                          f);
    if (fmt.on)
      act = fminf(fmaxf(__fmul_rn(rintf(__fdiv_rn(act, fmt.step)), fmt.step),
                        fmt.lo), fmt.hi);
    return __fadd_rn(tanhf(act), rnd) >= 0.0f;
  }
};

// int8: int_site's arithmetic; 7 B of constants per site.
struct Int8Update {
  const int8_t* __restrict__ h_q;
  Six<int8_t> w;
  const int32_t* __restrict__ rows;  // (S, R) LUT rows
  const uint32_t* __restrict__ lut;  // (n_rows, lw)
  int lw, R;

  struct Consts {
    int h, w[6];
  };

  __device__ __forceinline__ Consts load(int i) const {
    Consts k;
    k.h = __ldg(h_q + i);
    for (int d = 0; d < 6; ++d) k.w[d] = __ldg(w.p[d] + i);
    return k;
  }

  __device__ __forceinline__ bool accept(const Consts& k, const int8_t nb[6],
                                         int t, int r, uint32_t s) const {
    int f = k.h;
    for (int d = 0; d < 6; ++d) f += k.w[d] * nb[d];
    int idx = f + (lw - 1) / 2;
    idx = idx < 0 ? 0 : (idx > lw - 1 ? lw - 1 : idx);
    const int row = __ldg(rows + static_cast<long long>(t) * R + r);
    return (s >> 8) >= __ldg(lut + static_cast<long long>(row) * lw + idx);
  }
};

// -- the f32 single phase ----------------------------------------------------

// kW consecutive bytes (kW = 4: one aligned 32-bit load) as a word, byte q
// of the word being site q.
template <int kW>
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p) {
  if constexpr (kW == 4) return *reinterpret_cast<const uint32_t*>(p);
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

// One color phase, one thread per kW consecutive z-sites of a row, all R
// replicas; flips (R,) or nullptr.  Dynamic shared memory: R counters.
template <class Update, int kW>
__global__ void __launch_bounds__(kBlock)
word_phase_kernel(const int8_t* __restrict__ m_in,
                  int8_t* __restrict__ m_out,
                  const uint32_t* __restrict__ s_in,
                  uint32_t* __restrict__ s_out,
                  const int8_t* __restrict__ mask, Six<int8_t> halo,
                  Update up, int R, int X, int Y, int Z,
                  uint32_t* __restrict__ flips) {
  extern __shared__ uint32_t flips_s[];
  const int n = X * Y * Z;
  const int yz = Y * Z;
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = wi < n / kW;
  const int i0 = live ? wi * kW : 0;
  if (flips) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) flips_s[r] = 0;
    __syncthreads();
  }
  const Site c = site_of(i0, Y, Z);
  const uint32_t mk = live ? load_bytes<kW>(mask + i0) : 0u;
  typename Update::Consts kc[kW];
  if (mk) up.template load_word<kW>(i0, kc);
  for (int r = 0; r < R; ++r) {
    const long long off = static_cast<long long>(r) * n;
    unsigned changed = 0;
    if (live) {
      uint32_t st[kW];
      if constexpr (kW == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(s_in + off + i0);
        st[0] = xorshift32(v.x);
        st[1] = xorshift32(v.y);
        st[2] = xorshift32(v.z);
        st[3] = xorshift32(v.w);
        *reinterpret_cast<uint4*>(s_out + off + i0) =
            make_uint4(st[0], st[1], st[2], st[3]);
      } else {
        for (int q = 0; q < kW; ++q) {
          st[q] = xorshift32(s_in[off + i0 + q]);
          s_out[off + i0 + q] = st[q];
        }
      }
      const int8_t* m = m_in + off;
      const uint32_t own = load_bytes<kW>(m + i0);
      uint32_t nv = own;
      if (mk) {
        const long long hx = (static_cast<long long>(r) * Y + c.y) * Z + c.z;
        const long long hy = (static_cast<long long>(r) * X + c.x) * Z + c.z;
        const long long hz = (static_cast<long long>(r) * X + c.x) * Y + c.y;
        const uint32_t xm = c.x > 0 ? load_bytes<kW>(m + i0 - yz)
                                    : load_bytes<kW>(halo.p[0] + hx);
        const uint32_t xp = c.x < X - 1 ? load_bytes<kW>(m + i0 + yz)
                                        : load_bytes<kW>(halo.p[1] + hx);
        const uint32_t ym = c.y > 0 ? load_bytes<kW>(m + i0 - Z)
                                    : load_bytes<kW>(halo.p[2] + hy);
        const uint32_t yp = c.y < Y - 1 ? load_bytes<kW>(m + i0 + Z)
                                        : load_bytes<kW>(halo.p[3] + hy);
        const int8_t zm = c.z > 0 ? m[i0 - 1] : halo.p[4][hz];
        const int8_t zp = c.z + kW < Z ? m[i0 + kW] : halo.p[5][hz];
#pragma unroll
        for (int q = 0; q < kW; ++q) {
          if (((mk >> (8 * q)) & 0xffu) == 0) continue;
          const int8_t nb[6] = {byte_of(xm, q), byte_of(xp, q),
                                byte_of(ym, q), byte_of(yp, q),
                                q > 0 ? byte_of(own, q - 1) : zm,
                                q < kW - 1 ? byte_of(own, q + 1) : zp};
          const uint32_t v = up.accept(kc[q], nb, 0, r, st[q]) ? 0x01u
                                                               : 0xffu;
          nv = (nv & ~(0xffu << (8 * q))) | (v << (8 * q));
        }
      }
      store_bytes<kW>(m_out + off + i0, nv);
#pragma unroll
      for (int q = 0; q < kW; ++q) changed += byte_of(own ^ nv, q) != 0;
    }
    if (flips) {
      const unsigned total = __reduce_add_sync(0xffffffffu, changed);
      if ((threadIdx.x & 31) == 0 && total) atomicAdd(&flips_s[r], total);
    }
  }
  if (flips) {
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      if (flips_s[r]) atomicAdd(&flips[r], flips_s[r]);
  }
}

template <int kW>
int launch_f32_phase(const void* m_in, void* m_out, const void* s_in,
                     void* s_out, const void* mask, const void* const* halos,
                     const F32Update& up, int R, int X, int Y, int Z,
                     void* flips, void* stream) {
  word_phase_kernel<F32Update, kW>
      <<<blocks_for(X * Y * Z / kW), kBlock, 4 * static_cast<size_t>(R),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(m_in), static_cast<int8_t*>(m_out),
          static_cast<const uint32_t*>(s_in), static_cast<uint32_t*>(s_out),
          static_cast<const int8_t*>(mask), six<int8_t>(halos), up, R, X, Y,
          Z, static_cast<uint32_t*>(flips));
  return static_cast<int>(cudaGetLastError());
}

// -- the persistent sweep ----------------------------------------------------

constexpr int kPBlock = 512;     // threads per block of the persistent sweep
constexpr int kMaxColors = 32;   // color lists per block (static shared)
// List entries each thread of the int8 sweep decides per pass, and the
// blocks per SM its register allocation must keep (the f32 sweep takes
// one entry and the compiler's registers).
constexpr int kInt8InFlight = 2;
constexpr int kInFlightBlocks = 2;

// Copy len bytes from a buffer other blocks wrote through L2 only: 16 B
// per load where both ends share their alignment, bytes at the edges.
__device__ __forceinline__ void copy_l2(int8_t* d, const int8_t* s, int len,
                                        int tid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  int head = len;
  if (((a ^ reinterpret_cast<uintptr_t>(d)) & 15) == 0)
    head = min(len, static_cast<int>((16 - (a & 15)) & 15));
  const int body = (len - head) / 16;
  for (int j = tid; j < head; j += kPBlock) d[j] = __ldcg(s + j);
  const int4* s4 = reinterpret_cast<const int4*>(s + head);
  int4* d4 = reinterpret_cast<int4*>(d + head);
  for (int j = tid; j < body; j += kPBlock) d4[j] = __ldcg(s4 + j);
  for (int j = head + 16 * body + tid; j < len; j += kPBlock)
    d[j] = __ldcg(s + j);
}

// S sweeps of n_colors phases of one brick for R replicas in one
// cooperative launch.  Block b owns sites [b * tile, (b + 1) * tile).
// Phase k = t * n_colors + c reads spins from src (m0 for k = 0, else the
// buffer phase k-1 wrote) and writes buf[k % 2].  lists: tile ints per
// color per block of scratch.  Dynamic shared memory: R flip counters,
// then (kResident) the tile's R x tile LFSR states.  The body of both
// persistent kernels below.
template <class Update, bool kResident, int kSites>
__device__ __forceinline__ void persistent_sweep(
    const int8_t* m0, int8_t* buf0, int8_t* buf1,
    const uint32_t* __restrict__ s_in, uint32_t* __restrict__ s_out,
    const int8_t* __restrict__ masks, Six<int8_t> halo, Update up, int S,
    int n_colors, int R, int X, int Y, int Z, int tile,
    int32_t* __restrict__ lists, uint32_t* __restrict__ flips) {
  extern __shared__ uint32_t dyn[];
  __shared__ int list_len[kMaxColors];
  uint32_t* flips_s = dyn;
  uint32_t* st = dyn + R;
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();

  const int n = X * Y * Z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int lo = blockIdx.x * tile;
  const int cnt = lo < n ? min(tile, n - lo) : 0;
  int32_t* my_lists = lists + static_cast<long long>(blockIdx.x) * n_colors
                      * tile;
  for (int r = tid; r < R; r += kPBlock) flips_s[r] = 0;
  if (tid < kMaxColors) list_len[tid] = 0;
  __syncthreads();

  // color lists of the tile, by ballot compaction (order within a list is
  // free: every listed site is decided independently)
  for (int c = 0; c < n_colors; ++c) {
    const int8_t* mk = masks + static_cast<long long>(c) * n + lo;
    for (int base = 0; base < cnt; base += kPBlock) {
      const int j = base + tid;
      const bool in = j < cnt && mk[j] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      int off = 0;
      if (lane == 0 && bal) off = atomicAdd(&list_len[c], __popc(bal));
      off = __shfl_sync(0xffffffffu, off, 0);
      if (in)
        my_lists[c * tile + off + __popc(bal & ((1u << lane) - 1u))] = lo + j;
    }
  }
  if (kResident)
    for (int r = 0; r < R; ++r)
      for (int j = tid; j < cnt; j += kPBlock)
        st[r * cnt + j] = s_in[static_cast<long long>(r) * n + lo + j];
  __syncthreads();

  const int8_t* src = m0;
  for (int t = 0; t < S; ++t) {
    for (int c = 0; c < n_colors; ++c) {
      const int k = t * n_colors + c;
      int8_t* dst = (k & 1) ? buf1 : buf0;
      // every owned state advances; every owned spin is carried forward
      for (int r = 0; r < R; ++r) {
        const long long off = static_cast<long long>(r) * n + lo;
        for (int j = tid; j < cnt; j += kPBlock) {
          if (kResident) {
            st[r * cnt + j] = xorshift32(st[r * cnt + j]);
          } else {
            s_out[off + j] = xorshift32(k == 0 ? s_in[off + j]
                                               : s_out[off + j]);
          }
        }
        copy_l2(dst + off, src + off, cnt, tid);
      }
      __syncthreads();
      // the sites of this color's mask: constants once, then each replica
      const int len = list_len[c];
      const int32_t* lst = my_lists + c * tile;
      if constexpr (kSites == 1) {
        for (int base = 0; base < len; base += kPBlock) {
          const int j = base + tid;
          const bool act = j < len;
          const int i = act ? lst[j] : lo;
          typename Update::Consts kc;
          Site sc{0, 0, 0};
          if (act) {
            kc = up.load(i);
            sc = site_of(i, Y, Z);
          }
          for (int r = 0; r < R; ++r) {
            bool changed = false;
            if (act) {
              const long long off = static_cast<long long>(r) * n;
              int8_t nb[6];
              neighbors<int8_t>(src + off, halo, i, sc, r, X, Y, Z, nb,
                                L2Load());
              const uint32_t s = kResident ? st[r * cnt + (i - lo)]
                                           : s_out[off + i];
              const int8_t nv = up.accept(kc, nb, t, r, s) ? 1 : -1;
              changed = nv != __ldcg(src + off + i);
              dst[off + i] = nv;
            }
            const unsigned bal = __ballot_sync(0xffffffffu, changed);
            if (lane == 0 && bal) atomicAdd(&flips_s[r], __popc(bal));
          }
        }
      } else {
        // kSites entries per thread and pass, every load of a pass issued
        // before the first use.  An entry past the list stands in as site
        // lo (a site of this tile: len > 0 implies cnt > 0), so every load
        // is issued unpredicated; only stores and counts are masked.
        for (int base = 0; base < len; base += kSites * kPBlock) {
          int ii[kSites];
          bool act[kSites];
#pragma unroll
          for (int q = 0; q < kSites; ++q) {
            const int j = base + q * kPBlock + tid;
            act[q] = j < len;
            ii[q] = act[q] ? lst[j] : lo;
          }
          typename Update::Consts kc[kSites];
          Site sc[kSites];
#pragma unroll
          for (int q = 0; q < kSites; ++q) {
            kc[q] = up.load(ii[q]);
            sc[q] = site_of(ii[q], Y, Z);
          }
          for (int r = 0; r < R; ++r) {
            const long long off = static_cast<long long>(r) * n;
            int8_t nb[kSites][6];
            uint32_t s[kSites];
            int8_t old[kSites];
#pragma unroll
            for (int q = 0; q < kSites; ++q) {
              neighbors<int8_t>(src + off, halo, ii[q], sc[q], r, X, Y, Z,
                                nb[q], L2Load());
              s[q] = kResident ? st[r * cnt + (ii[q] - lo)]
                               : s_out[off + ii[q]];
              old[q] = __ldcg(src + off + ii[q]);
            }
            unsigned flipped = 0;
#pragma unroll
            for (int q = 0; q < kSites; ++q) {
              const int8_t nv = up.accept(kc[q], nb[q], t, r, s[q]) ? 1 : -1;
              if (act[q]) dst[off + ii[q]] = nv;
              flipped += __popc(
                  __ballot_sync(0xffffffffu, act[q] && nv != old[q]));
            }
            if (lane == 0 && flipped) atomicAdd(&flips_s[r], flipped);
          }
        }
      }
      src = dst;
      if (k + 1 < S * n_colors) grid.sync();
    }
  }
  __syncthreads();
  if (kResident)
    for (int r = 0; r < R; ++r)
      for (int j = tid; j < cnt; j += kPBlock)
        s_out[static_cast<long long>(r) * n + lo + j] = st[r * cnt + j];
  for (int r = tid; r < R; r += kPBlock)
    if (flips_s[r]) atomicAdd(&flips[r], flips_s[r]);
}

// One decided replica-site in flight per thread (the f32 sweep),
// registers as the compiler chooses.
template <class Update, bool kResident>
__global__ void __launch_bounds__(kPBlock)
persistent_sweep_kernel(const int8_t* m0, int8_t* buf0, int8_t* buf1,
                        const uint32_t* __restrict__ s_in,
                        uint32_t* __restrict__ s_out,
                        const int8_t* __restrict__ masks, Six<int8_t> halo,
                        Update up, int S, int n_colors, int R, int X, int Y,
                        int Z, int tile, int32_t* __restrict__ lists,
                        uint32_t* __restrict__ flips) {
  persistent_sweep<Update, kResident, 1>(
      m0, buf0, buf1, s_in, s_out, masks, halo, up, S, n_colors, R, X, Y, Z,
      tile, lists, flips);
}

// kInt8InFlight list entries in flight per thread, registers capped so
// that kInFlightBlocks blocks fit on an SM (the spills stay in L1).
template <class Update, bool kResident>
__global__ void __launch_bounds__(kPBlock, kInFlightBlocks)
persistent_sweep_inflight_kernel(
    const int8_t* m0, int8_t* buf0, int8_t* buf1,
    const uint32_t* __restrict__ s_in, uint32_t* __restrict__ s_out,
    const int8_t* __restrict__ masks, Six<int8_t> halo, Update up, int S,
    int n_colors, int R, int X, int Y, int Z, int tile,
    int32_t* __restrict__ lists, uint32_t* __restrict__ flips) {
  persistent_sweep<Update, kResident, kInt8InFlight>(
      m0, buf0, buf1, s_in, s_out, masks, halo, up, S, n_colors, R, X, Y, Z,
      tile, lists, flips);
}

// The persistent kernel of a sweep: kind 0 f32, kind 1 int8; nullptr for
// any other.
const void* persistent_kernel(int kind, int resident) {
  if (kind == 0)
    return resident ? reinterpret_cast<const void*>(
                          &persistent_sweep_kernel<F32Update, true>)
                    : reinterpret_cast<const void*>(
                          &persistent_sweep_kernel<F32Update, false>);
  if (kind == 1)
    return resident
               ? reinterpret_cast<const void*>(
                     &persistent_sweep_inflight_kernel<Int8Update, true>)
               : reinterpret_cast<const void*>(
                     &persistent_sweep_inflight_kernel<Int8Update, false>);
  return nullptr;
}

// One cooperative launch of a persistent kernel (see the entry points for
// the arguments).  Returns the launch's cudaError_t.
template <class Update>
int launch_persistent(const void* kern, const void* m0, void* buf0,
                      void* buf1, const void* s_in, void* s_out,
                      const void* masks, const void* const* halos, Update up,
                      int S, int n_colors, int R, int X, int Y, int Z,
                      int grid, int tile, int smem, void* lists, void* flips,
                      void* stream) {
  if (kern == nullptr || n_colors > kMaxColors || S < 1 || n_colors < 1 ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int8_t* a_m0 = static_cast<const int8_t*>(m0);
  int8_t* a_b0 = static_cast<int8_t*>(buf0);
  int8_t* a_b1 = static_cast<int8_t*>(buf1);
  const uint32_t* a_si = static_cast<const uint32_t*>(s_in);
  uint32_t* a_so = static_cast<uint32_t*>(s_out);
  const int8_t* a_mk = static_cast<const int8_t*>(masks);
  Six<int8_t> a_halo = six<int8_t>(halos);
  int32_t* a_lists = static_cast<int32_t*>(lists);
  uint32_t* a_flips = static_cast<uint32_t*>(flips);
  void* args[] = {&a_m0, &a_b0, &a_b1, &a_si, &a_so, &a_mk, &a_halo, &up,
                  &S, &n_colors, &R, &X, &Y, &Z, &tile, &a_lists, &a_flips};
  e = cudaLaunchCooperativeKernel(kern, dim3(static_cast<unsigned>(grid)),
                                  dim3(kPBlock), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves its error to clear
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// The card's SM count and the shared memory one block may opt in to:
// out[0], out[1].  Returns a cudaError_t.
extern "C" int pbit_device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

// How many blocks of the persistent kernel (kind 0 f32, 1 int8; resident)
// one SM keeps resident with smem bytes of dynamic shared memory each:
// out[0] (0 where smem exceeds what one block may opt in to).  Returns a
// cudaError_t (cudaErrorInvalidValue for an unknown kind).
extern "C" int pbit_persistent_occupancy(int kind, int resident, int smem,
                                         int* out) {
  using namespace repro_torch;
  const void* kern = persistent_kernel(kind, resident);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int lim[2];
  cudaError_t e = static_cast<cudaError_t>(pbit_device_limits(lim));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 0;
  if (smem > lim[1]) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kern, kPBlock, static_cast<size_t>(smem)));
}

// Common arguments of the two persistent sweeps: m0 (R, X, Y, Z) int8
// input spins (not written); buf0 / buf1 (R, X, Y, Z) int8, distinct, the
// result in buf[(S * n_colors - 1) % 2]; s_in / s_out (R, X, Y, Z) uint32,
// distinct; masks (n_colors, X, Y, Z) int8; halos six (R, plane) int8;
// resident, grid, tile, smem the launch shape the wrapper chose with
// pbit_persistent_occupancy (grid may be any count: a grid the card cannot
// co-schedule fails to launch); lists grid * n_colors * tile int32
// scratch; flips (R,) uint32 accumulates.  Each returns the launch's
// cudaError_t.

// S f32 sweeps in one cooperative launch: betas (S, R) f32; h / w6 f32
// (X, Y, Z); fmt_on, step, lo, hi the activation's format.
extern "C" int pbit_sweep_f32_persistent(
    const void* m0, void* buf0, void* buf1, const void* s_in, void* s_out,
    const void* betas, const void* masks, const void* h,
    const void* const* w6, const void* const* halos, int fmt_on, float step,
    float lo, float hi, int S, int n_colors, int R, int X, int Y, int Z,
    int resident, int grid, int tile, int smem, void* lists, void* flips,
    void* stream) {
  using namespace repro_torch;
  F32Update up{static_cast<const float*>(h), six<float>(w6),
               static_cast<const float*>(betas), Fmt{fmt_on, step, lo, hi},
               R};
  return launch_persistent(persistent_kernel(0, resident), m0, buf0, buf1,
                           s_in, s_out, masks, halos, up, S, n_colors, R, X,
                           Y, Z, grid, tile, smem, lists, flips, stream);
}

// S int8 sweeps in one cooperative launch: rows (S, R) int32 LUT rows;
// h_q / w6 int8 (X, Y, Z); lut (n_rows, lw) uint32.
extern "C" int pbit_sweep_int_persistent(
    const void* m0, void* buf0, void* buf1, const void* s_in, void* s_out,
    const void* rows, const void* masks, const void* h_q,
    const void* const* w6, const void* const* halos, const void* lut, int lw,
    int S, int n_colors, int R, int X, int Y, int Z, int resident, int grid,
    int tile, int smem, void* lists, void* flips, void* stream) {
  using namespace repro_torch;
  Int8Update up{static_cast<const int8_t*>(h_q), six<int8_t>(w6),
                static_cast<const int32_t*>(rows),
                static_cast<const uint32_t*>(lut), lw, R};
  return launch_persistent(persistent_kernel(1, resident), m0, buf0, buf1,
                           s_in, s_out, masks, halos, up, S, n_colors, R, X,
                           Y, Z, grid, tile, smem, lists, flips, stream);
}

// Common arguments of the single phases: m_in / m_out (R, X, Y, Z) int8,
// distinct; s_in / s_out (R, X, Y, Z) uint32, distinct; mask (X, Y, Z)
// int8 (this color); w6 six and h one (X, Y, Z) constant arrays; halos six
// (R, plane) int8; flips (R,) uint32 to which each replica's changed sites
// are added, or null.  Each returns cudaGetLastError() right after the
// launch.

// int8 single phase: rows_t (R,) int32 LUT rows of this phase; h_q / w6
// int8; lut (n_rows, lw) uint32.
extern "C" int pbit_update_int_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* rows_t, const void* mask, const void* h_q,
    const void* const* w6, const void* const* halos, const void* lut,
    int lw, int R, int X, int Y, int Z, void* flips, void* stream) {
  using namespace repro_torch;
  return flips ? launch_int<true>(m_in, m_out, s_in, s_out, rows_t, mask,
                                  h_q, w6, halos, lut, lw, R, X, Y, Z, flips,
                                  stream)
               : launch_int<false>(m_in, m_out, s_in, s_out, rows_t, mask,
                                   h_q, w6, halos, lut, lw, R, X, Y, Z,
                                   nullptr, stream);
}

// f32 single phase: betas_t (R,) f32 betas of this phase; h / w6 f32;
// fmt_on, step, lo, hi the activation's fixed-point format (fmt_on = 0:
// none); width 4 (Z a multiple of 4, s_in / s_out / h / w6 16 B and the
// int8 arrays 4 B aligned) or 1, the z-sites per thread.
extern "C" int pbit_update_f32_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* betas_t, const void* mask, const void* h,
    const void* const* w6, const void* const* halos, int fmt_on, float step,
    float lo, float hi, int R, int X, int Y, int Z, int width, void* flips,
    void* stream) {
  using namespace repro_torch;
  const F32Update up{static_cast<const float*>(h), six<float>(w6),
                     static_cast<const float*>(betas_t),
                     Fmt{fmt_on, step, lo, hi}, R};
  if (width == 4 && Z % 4 == 0)
    return launch_f32_phase<4>(m_in, m_out, s_in, s_out, mask, halos, up, R,
                               X, Y, Z, flips, stream);
  if (width == 1)
    return launch_f32_phase<1>(m_in, m_out, s_in, s_out, mask, halos, up, R,
                               X, Y, Z, flips, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
