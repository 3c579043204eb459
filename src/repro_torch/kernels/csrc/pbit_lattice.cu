// Lattice p-bit color phases: int8 and f32, fused (with the flip count)
// and per phase.
//
// Replaces, in repro/kernels/pbit_lattice.py:
//   pbit_brick_sweep_int  (Pallas body _sweep_kernel_int)  by pbit_sweep_int_phase
//   pbit_brick_sweep      (Pallas body _sweep_kernel)      by pbit_sweep_f32_persistent
//   pbit_brick_update_int (Pallas body _kernel_int)        by pbit_update_int_phase
//   pbit_brick_update     (Pallas body _kernel)            by pbit_update_f32_phase
// A site update is written once per precision (int_site, f32_site; the
// persistent sweep's F32Update is f32_site's arithmetic as a functor).
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
// The per-phase kernels (int8 sweep, both single phases): one launch per
// (sweep, color) phase, all R replicas in one grid (sites / 256, R); per
// site the local field, one xorshift32 step of EVERY site's LFSR (masked or
// not), the accept and the masked write of every site of m_out (spins
// ping-pong between two buffers; the launch boundary orders the phases).
// Bound: memory traffic, 10 B per replica-site and phase plus the shared
// constants (8 B per site int8, 29 B f32).
//
// The f32 sweep is one persistent cooperative launch per call of S sweeps.
// What bounds it: per phase every replica-site's LFSR advances (integer
// work) and the masked sites are decided from 29 B per site of f32
// constants and six neighbor spins per replica.  At L=100, R=4 the bytes
// of a call (about 70 MB, each read once) are of the order of its INT32
// work; in practice the decided sites' dependent chain (list entry,
// constants, neighbor spins from L2, tanhf) sets the pace, so the design
// removes everything else from each phase.  The per-launch design it
// replaces moved 16 MB of LFSR state in and out of device memory per
// phase, re-read the constants per replica, computed masked-off sites and
// paid a launch per phase.  What this design does:
// - Every block is resident (grid = blocks per SM x SMs, from the
//   occupancy query) and owns a fixed tile of sites for all R replicas;
//   cooperative_groups grid.sync() separates consecutive (sweep, color)
//   phases in place of the launch boundary.  Halos stay fixed for the call.
// - The tile's LFSR states live in dynamic shared memory for the whole call
//   (loaded once, written back once) when they fit (kResident, chosen by
//   the wrapper by size); otherwise the same kernel keeps them in device
//   memory.  Per phase every owned state advances once.
// - Per-tile color lists, built once at kernel start by ballot compaction,
//   hold the sites of each mask (a site may be in several), so field,
//   draw, activation and tanhf run only at masked sites and warps do not
//   diverge on the checkerboard.  Each site's h and six weights are loaded
//   once per phase for all R replicas.
// - Spins ping-pong between two global buffers; each phase copies the
//   tile's spins forward (16 B loads) and overwrites the masked ones, so
//   any masks keep the reference's phase semantics.  A buffer written by
//   other blocks in the previous phase is read through L2 only
//   (ld.global.cg), never through L1 or the read-only path.
// - Per-replica flips are summed in shared memory for the whole call, one
//   atomic per block per replica at the end.
// The kernel is a template over the site update
// (persistent_sweep_kernel<Update, kResident>), so the int8 sweep can take
// the same design.
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

// -- the persistent sweep ----------------------------------------------------

constexpr int kPBlock = 512;     // threads per block of the persistent sweep
constexpr int kMaxColors = 32;   // color lists per block (static shared)

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

// The f32 site update of f32_site as a functor: the constants of a site
// are loaded once and serve every replica.
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

// S sweeps of n_colors phases of one brick for R replicas in one
// cooperative launch.  Block b owns sites [b * tile, (b + 1) * tile).
// Phase k = t * n_colors + c reads spins from src (m0 for k = 0, else the
// buffer phase k-1 wrote) and writes buf[k % 2].  lists: tile ints per
// color per block of scratch.  Dynamic shared memory: R flip counters,
// then (kResident) the tile's R x tile LFSR states.
template <class Update, bool kResident>
__global__ void __launch_bounds__(kPBlock)
persistent_sweep_kernel(const int8_t* m0, int8_t* buf0, int8_t* buf1,
                        const uint32_t* __restrict__ s_in,
                        uint32_t* __restrict__ s_out,
                        const int8_t* __restrict__ masks, Six<int8_t> halo,
                        Update up, int S, int n_colors, int R, int X, int Y,
                        int Z, int tile, int32_t* __restrict__ lists,
                        uint32_t* __restrict__ flips) {
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

template <bool kResident>
const void* f32_persistent() {
  return reinterpret_cast<const void*>(
      &persistent_sweep_kernel<F32Update, kResident>);
}

inline size_t persistent_smem(int resident, int R, int tile) {
  return 4 * (static_cast<size_t>(R)
              + (resident ? static_cast<size_t>(tile) * R : 0));
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

// The persistent f32 sweep's launch shape for R replicas of an n-site
// brick: the most blocks per SM (up to 4) that the occupancy query keeps
// resident with their tiles' shared memory.  out = {grid, tile, smem
// bytes, blocks per SM}.  Returns a cudaError_t
// (cudaErrorInvalidConfiguration where not even one block per SM fits).
extern "C" int pbit_persistent_config(int resident, int R, int n, int* out) {
  using namespace repro_torch;
  int lim[2];
  cudaError_t e = static_cast<cudaError_t>(pbit_device_limits(lim));
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kern =
      resident ? f32_persistent<true>() : f32_persistent<false>();
  for (int b = 4; b >= 1; --b) {
    const int blocks = b * lim[0];
    const int tile = (n + blocks - 1) / blocks;
    const size_t smem = persistent_smem(resident, R, tile);
    if (smem > static_cast<size_t>(lim[1])) continue;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kPBlock,
                                                      smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ >= b) {
      out[0] = blocks;
      out[1] = tile;
      out[2] = static_cast<int>(smem);
      out[3] = b;
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

// S f32 sweeps in one cooperative launch.  m0 (R, X, Y, Z) int8 input
// spins (not written); buf0 / buf1 (R, X, Y, Z) int8, distinct, the
// result in buf[(S * n_colors - 1) % 2]; s_in / s_out (R, X, Y, Z) uint32,
// distinct; betas (S, R) f32; masks (n_colors, X, Y, Z) int8; h / w6 f32
// (X, Y, Z); halos six (R, plane) int8; fmt_on, step, lo, hi the
// activation's format; resident, grid, tile, smem from
// pbit_persistent_config (grid may be any count: a grid the card cannot
// co-schedule fails to launch); lists grid * n_colors * tile int32
// scratch; flips (R,) uint32 accumulates.  Returns the launch's
// cudaError_t.
extern "C" int pbit_sweep_f32_persistent(
    const void* m0, void* buf0, void* buf1, const void* s_in, void* s_out,
    const void* betas, const void* masks, const void* h,
    const void* const* w6, const void* const* halos, int fmt_on, float step,
    float lo, float hi, int S, int n_colors, int R, int X, int Y, int Z,
    int resident, int grid, int tile, int smem, void* lists, void* flips,
    void* stream) {
  using namespace repro_torch;
  if (n_colors > kMaxColors || S < 1 || n_colors < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kern =
      resident ? f32_persistent<true>() : f32_persistent<false>();
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
  F32Update up{static_cast<const float*>(h), six<float>(w6),
               static_cast<const float*>(betas), Fmt{fmt_on, step, lo, hi},
               R};
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

// f32 single phase: betas_t (R,) f32 betas of this phase; h / w6 f32;
// fmt_on, step, lo, hi the activation's fixed-point format (fmt_on = 0:
// none).
extern "C" int pbit_update_f32_phase(
    const void* m_in, void* m_out, const void* s_in, void* s_out,
    const void* betas_t, const void* mask, const void* h,
    const void* const* w6, const void* const* halos, int fmt_on, float step,
    float lo, float hi, int R, int X, int Y, int Z, void* stream) {
  return repro_torch::launch_f32<false>(m_in, m_out, s_in, s_out, betas_t,
                                        mask, h, w6, halos, fmt_on, step, lo,
                                        hi, R, X, Y, Z, nullptr, stream);
}
