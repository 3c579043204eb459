// One colour phase of the bit-plane general-graph path, fused: the ELL word
// gather-count, the per-lane LFSR step, the LUT accept, the word write and
// the per-lane flip count (dsim_dist) or energy change (packed APT+ICM).
//
// The redesign of B7, which replaces
// repro/kernels/ops.py::bitplane_gather_count_op (the plain jnp
// repro/kernels/ref.py::bitplane_gather_count_ref; no Pallas original),
// together with the per-lane tail that followed it in PyTorch:
// DistDSIMEngine._phase_w of repro/core/dsim_dist.py (its
// _phase_block_w) and the colour loop of APTICM._gibbs_sweep_packed of
// repro/core/apt_icm.py.  B7 alone was 0.4% of a dsim_dist colour phase;
// the tail, about 40 int64 PyTorch operations on (K, R, nc) tensors, was
// the rest.
//
// For partition k, colour entry i (slot slots[k, i]), word w and lane
// r = 32 w + b < R: gather the D neighbour words from the local words mw or
// the ghost words (index < n_max picks mw), take (word ^ sign) & nz per
// neighbour and ripple-add the planes into bit slices (as B7); step the
// lane's xorshift32 state s[k, r, slot]; read the lane's count c from the
// slices; accept with u = s >> 8 >= thr[clip(base + 2 c, 0, lw - 1)] (the
// field is base - f_max + 2 c); assemble the new word (lanes >= R zero);
// count the flips per lane; write the word back in place.  A proper
// colouring makes the phase read no word it writes (neighbours are of
// other colours, ghosts are never written), so the update is in place.
//
// Padded colour entries (dsim_dist): a partition with fewer sites of a
// colour than the widest pads its row with entries of slot 0, mask unset.
// The plain version steps slot 0's LFSR once from its state before the
// phase (every duplicate writes the same value), keeps slot 0's word where
// the real slot-0 entry is "lost" (its flip still counted) and counts no
// flip at padding.  Threads that shared a slot would race on its state, so
// the host marks the first entry of each slot in its partition as its
// owner (flag bit 2): only the owner steps and writes the states.  Real
// entries are always owners (padding follows them); the wrapper checks
// it.  Words are written where mask and not lost, flips counted where mask.
//
// Integer reductions only: a warp sums each lane's flips (ballot and
// popcount) or energy change (redux), shared memory sums the warps, and one
// atomic per block and lane adds the block's sums (their order does not
// matter).  APT's energy: each lane's sum of (new - old) * field is an
// integer with |sum| <= 2 f_max nc < 2^24 (the wrapper checks), so the
// plain version's f32 sum of these integers is exact in any order and
// equals float(sum); the last block to finish computes E - float(sum) *
// scale with round-to-nearest f32 multiply and subtract, as the plain
// version's two operations do, so E is bitwise the plain version's.
//
// What bounds it on this card: device memory, chiefly the LFSR states (8 B
// int64 carriers read and written once per lane-site: 512 MB of the
// ~570 MB a dsim_dist colour phase at K=8, R=64, nc=62,500 moves).  The
// design: the states of a word are loaded 16 at a time (16 loads in flight
// per thread, at two blocks per SM) and stepped in registers; the per-site
// constants (slot, flags, base, D indices, signs and nonzero masks) are
// read once per thread; the LUT row(s) sit in shared memory.  A warp holds
// 32 consecutive colour entries, so for a fixed lane it reads states of
// neighbouring slots.  Where the sites are too few to fill the card
// (APT: 10,000 per colour), each thread takes one word of its site
// instead of all of them (the wrapper picks words per thread).
//
// Grid: (nc / 256, K * word groups); a block holds one partition and one
// group of words.
#include "common.cuh"

namespace repro_torch {

constexpr int kPhaseSlices = 5;      // D <= 31
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kMaskBit = 1u;    // a real site: decides, counts flips
constexpr unsigned kLostBit = 2u;    // its word write is undone (padding)
constexpr unsigned kOwnerBit = 4u;   // the first entry of its slot
// LFSR states loaded together per thread
constexpr int kChunk = 16;

// The D neighbour words of one site in one word plane, ripple-added into
// bit slices as repro/kernels/ref.py::bitplane_count_planes_ref does (a
// slice is appended only when the count can reach the next power of two).
template <int kMaxD>
__device__ __forceinline__ void count_slices(
    const uint32_t* plane, const uint32_t* ghost, int n_max,
    const int (&nb)[kMaxD], const uint32_t (&sg)[kMaxD],
    const uint32_t (&nzm)[kMaxD], int D, uint32_t (&sl)[kPhaseSlices]) {
#pragma unroll
  for (int j = 0; j < kPhaseSlices; ++j) sl[j] = 0u;
  int len = 0;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d < D) {
      const int q = nb[d];
      const uint32_t word = q < n_max ? plane[q] : ghost[q - n_max];
      uint32_t carry = (word ^ sg[d]) & nzm[d];
#pragma unroll
      for (int j = 0; j < kPhaseSlices; ++j) {
        if (j < len) {
          const uint32_t s = sl[j];
          sl[j] = s ^ carry;
          carry = s & carry;
        }
      }
      if ((1 << len) <= d + 1) {
#pragma unroll
        for (int j = 0; j < kPhaseSlices; ++j)
          if (j == len) sl[j] = carry;
        ++len;
      }
    }
  }
}

__device__ __forceinline__ int lane_count(const uint32_t (&sl)[kPhaseSlices],
                                          int b) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < kPhaseSlices; ++j) c |= ((sl[j] >> b) & 1u) << j;
  return c;
}

// kApt: K = 1, every entry a real site and its slot's owner (no flags),
// one LUT row per lane (rows of the block's 32 lanes in shared memory),
// the energy change instead of flips, one word per thread.  Otherwise one
// LUT row for every lane and the flips added to flips[r].
// Two blocks per SM at D <= 8 (128 registers, no spills; uncapped the
// kernel took 181 and one block per SM, which left APT's 160 blocks two
// waves: 22.8 us a launch against 17.0 capped); one above (no spills).
template <int kMaxD, bool kApt>
__global__ void __launch_bounds__(kBlock, kMaxD <= 8 ? 2 : 1)
bitplane_phase_kernel(uint32_t* mw, const uint32_t* __restrict__ ghosts,
                      long long* __restrict__ s,
                      const int32_t* __restrict__ slots,
                      const uint8_t* __restrict__ flags,
                      const int32_t* __restrict__ base,
                      const int32_t* __restrict__ idx,
                      const uint32_t* __restrict__ signs,
                      const uint32_t* __restrict__ nz,
                      const long long* __restrict__ thr, int lw, int f_max,
                      int W, int R, int n_max, int g_max, int nc, int D,
                      int wpt, int groups,
                      unsigned long long* __restrict__ flips,
                      int* __restrict__ e_acc, unsigned* __restrict__ ticket,
                      float* __restrict__ E, float scale) {
  extern __shared__ int smem[];
  const int rows = kApt ? 32 : 1;
  int* thr_s = smem;                        // rows x lw thresholds
  int* lane_s = smem + rows * lw;           // 32 per word of the group
  const int k = blockIdx.y / groups;
  const int w0 = (blockIdx.y - k * groups) * wpt;
  const int nw = min(wpt, W - w0);
  for (int j = threadIdx.x; j < rows * lw; j += blockDim.x) {
    long long at = j;
    if (kApt) {
      const int r = 32 * w0 + j / lw;
      at = r < R ? static_cast<long long>(r) * lw + j % lw : -1;
    }
    thr_s[j] = at >= 0 ? static_cast<int>(thr[at]) : 0;
  }
  for (int j = threadIdx.x; j < 32 * nw; j += blockDim.x) lane_s[j] = 0;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < nc;
  const long long site = static_cast<long long>(k) * nc + i;
  const unsigned fl = !in ? 0u : kApt ? (kMaskBit | kOwnerBit)
                                      : static_cast<unsigned>(flags[site]);
  const bool act = fl & kMaskBit;
  const bool own = fl & kOwnerBit;
  const bool keep = act && !(fl & kLostBit);
  const int slot = in ? slots[site] : 0;
  const int col0 = act ? base[site] : 0;
  int nb[kMaxD];
  uint32_t sg[kMaxD], nzm[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    nb[d] = 0;
    sg[d] = nzm[d] = 0u;
    if (act && d < D) {
      nb[d] = idx[site * D + d];
      sg[d] = signs[site * D + d];
      nzm[d] = nz[site * D + d];
    }
  }
  const int lane = threadIdx.x & 31;
  for (int wi = 0; wi < nw; ++wi) {
    const int w = w0 + wi;
    const long long kw = static_cast<long long>(k) * W + w;
    uint32_t* plane = mw + kw * n_max;
    const uint32_t old = act ? plane[slot] : 0u;
    const int live = min(32, R - 32 * w);   // lanes of this word, >= 1
    long long* sp = s + (static_cast<long long>(k) * R + 32 * w) * n_max +
                    slot;
    uint32_t sl[kPhaseSlices];
    if (act) {
      count_slices<kMaxD>(plane, ghosts + kw * g_max, n_max, nb, sg, nzm, D,
                          sl);
    } else {
#pragma unroll
      for (int j = 0; j < kPhaseSlices; ++j) sl[j] = 0u;
    }
    uint32_t word = 0u;
#pragma unroll
    for (int h = 0; h < 32; h += kChunk) {
      // kChunk states in flight, stepped in registers, written back
      uint32_t st[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        st[j] = own && h + j < live
                    ? static_cast<uint32_t>(sp[(h + j) * n_max])
                    : 0u;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int b = h + j;
        if (own && b < live) {
          st[j] = xorshift32(st[j]);
          sp[b * n_max] = static_cast<long long>(st[j]);
        }
        const int c = min(max(col0 + 2 * lane_count(sl, b), 0), lw - 1);
        const int t = thr_s[kApt ? b * lw + c : c];
        if (act && b < live && static_cast<int>(st[j] >> 8) >= t)
          word |= 1u << b;
      }
    }
    if (keep) plane[slot] = word;
    const uint32_t valid = live == 32 ? kFull : (1u << live) - 1u;
    const uint32_t x = act ? (old ^ word) & valid : 0u;
    int mine = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      int v;
      if (kApt) {
        // (new - old) * field, new and old in {-1, +1}
        const int field = col0 - f_max + 2 * lane_count(sl, b);
        const int de = ((x >> b) & 1u) == 0u ? 0
                       : ((word >> b) & 1u) ? 2 * field : -2 * field;
        v = __reduce_add_sync(kFull, de);
      } else {
        v = __popc(__ballot_sync(kFull, (x >> b) & 1u));
      }
      mine = lane == b ? v : mine;
    }
    if (mine != 0) atomicAdd(&lane_s[wi * 32 + lane], mine);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 32 * nw; j += blockDim.x) {
    const int r = 32 * w0 + j;
    const int v = lane_s[j];
    if (r < R && v != 0) {
      if (kApt)
        atomicAdd(&e_acc[r], v);
      else
        atomicAdd(&flips[r], static_cast<unsigned long long>(v));
    }
  }
  if (kApt) {
    // the last block to finish applies the energy changes and clears the
    // sums and the ticket for the next launch
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (last) {
      for (int r = threadIdx.x; r < R; r += blockDim.x) {
        const int sum = atomicExch(&e_acc[r], 0);
        E[r] = __fsub_rn(E[r], __fmul_rn(static_cast<float>(sum), scale));
      }
      if (threadIdx.x == 0) atomicExch(ticket, 0u);
    }
  }
}

template <bool kApt>
int launch_phase(uint32_t* mw, const uint32_t* ghosts, long long* s,
                 const int32_t* slots, const uint8_t* flags,
                 const int32_t* base, const int32_t* idx,
                 const uint32_t* signs, const uint32_t* nz,
                 const long long* thr, int lw, int f_max, int K, int W,
                 int R, int n_max, int g_max, int nc, int D, int wpt,
                 unsigned long long* flips, int* e_acc, unsigned* ticket,
                 float* E, float scale, cudaStream_t stream) {
  auto kern = D <= 8    ? bitplane_phase_kernel<8, kApt>
              : D <= 16 ? bitplane_phase_kernel<16, kApt>
                        : bitplane_phase_kernel<32, kApt>;
  const int groups = (W + wpt - 1) / wpt;
  const size_t smem = sizeof(int) * ((kApt ? 32 : 1) * lw + 32 * wpt);
  const dim3 grid(blocks_for(nc), static_cast<unsigned>(K * groups));
  kern<<<grid, kBlock, smem, stream>>>(mw, ghosts, s, slots, flags, base,
                                       idx, signs, nz, thr, lw, f_max, W, R,
                                       n_max, g_max, nc, D, wpt, groups,
                                       flips, e_acc, ticket, E, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// dsim_dist: mw (K, W, n_max) and ghosts (K, W, g_max) uint32 words (mw
// updated in place); s (K, R, n_max) int64-carried LFSR states (updated in
// place); slots, base (K, nc) int32, flags (K, nc) uint8 (1 mask, 2 lost,
// 4 owner); idx (K, nc, D) int32 into [0, n_max + g_max); signs, nz
// (K, nc, D) uint32; thr one LUT row of lw int64 thresholds; f_max the
// field bound; wpt words per thread; flips (R,) int64 to which each lane's
// flips are added.  1 <= D <= 31, W = ceil(R / 32), nc >= 1.  Returns
// cudaGetLastError().
extern "C" int bitplane_phase_dist(void* mw, const void* ghosts, void* s,
                                   const void* slots, const void* flags,
                                   const void* base, const void* idx,
                                   const void* signs, const void* nz,
                                   const void* thr, int lw, int f_max, int K,
                                   int W, int R, int n_max, int g_max, int nc,
                                   int D, int wpt, void* flips,
                                   void* stream) {
  using namespace repro_torch;
  return launch_phase<false>(
      static_cast<uint32_t*>(mw), static_cast<const uint32_t*>(ghosts),
      static_cast<long long*>(s), static_cast<const int32_t*>(slots),
      static_cast<const uint8_t*>(flags), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(idx), static_cast<const uint32_t*>(signs),
      static_cast<const uint32_t*>(nz), static_cast<const long long*>(thr),
      lw, f_max, K, W, R, n_max, g_max, nc, D, wpt,
      static_cast<unsigned long long*>(flips), nullptr, nullptr, nullptr,
      0.0f, static_cast<cudaStream_t>(stream));
}

// Packed APT+ICM, one colour: mw (W, n) uint32 words and s (R, n) int64
// LFSR states of the R = P*T lanes (both updated in place); slots (nc,)
// int32 nodes, base (nc,) int32; idx (nc, D) int32 into [0, n); signs, nz
// (nc, D) uint32; thr (R, lw) int64, lane r's LUT row; scratch (R + 1,)
// int32 zeros (left zero); E (R,) f32 energies, E[r] -= sum * scale.
extern "C" int bitplane_phase_apt(void* mw, void* s, const void* slots,
                                  const void* base, const void* idx,
                                  const void* signs, const void* nz,
                                  const void* thr, int lw, int f_max, int W,
                                  int R, int n, int nc, int D, void* scratch,
                                  void* E, float scale, void* stream) {
  using namespace repro_torch;
  int* acc = static_cast<int*>(scratch);
  return launch_phase<true>(
      static_cast<uint32_t*>(mw), static_cast<const uint32_t*>(mw),
      static_cast<long long*>(s), static_cast<const int32_t*>(slots),
      nullptr, static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(idx), static_cast<const uint32_t*>(signs),
      static_cast<const uint32_t*>(nz), static_cast<const long long*>(thr),
      lw, f_max, 1, W, R, n, 0, nc, D, 1, nullptr, acc,
      reinterpret_cast<unsigned*>(acc + R), static_cast<float*>(E), scale,
      static_cast<cudaStream_t>(stream));
}
