// Exact grouped int64 sums and counts over a small group domain.
//
// Replaces the TPU kernel datafusion_tpu/ops/pallas_kernels.py
// smalldomain_sum_count (pl.pallas_call at :167, body _make_kernel :48-129).
// That kernel splits every int64 into 8-bit limbs accumulated in int32
// (Mosaic is 32-bit) and double-buffers its own HBM->VMEM DMA (no grid).
// Here unsigned addition mod 2^64 is two's-complement int64 wrap-around,
// so every sum is exact and independent of the order of the adds.
//
// What bounds it: bytes.  Every row reads its group id (4 B); only a live
// row reads a value (8 B) or a mask (1 B).  The wrapper hands the kernel
// distinct work only (ops/smalldomain.py plan_items): each distinct
// (value, mask) pair is one sum column, each distinct mask one count
// column (a null mask counts the live rows), and an item map writes the
// [domain, k] outputs back.  The design:
//   - loads: a warp takes 128 consecutive rows a step, each lane 4 of them:
//     one 16-byte group-id load, two 16-byte loads per value column, one
//     4-byte load per mask, through the read-only path.  All loads of a
//     step are issued before any of them is used, and the next step's
//     group ids are loaded a step ahead.  A step whose rows are all dead
//     loads no value or mask, nor does a lane whose 4 rows are all dead.
//     Unaligned inputs and the ragged last step load row by row.
//   - cells: each (slot, column) has `copies` 32-bit cells in shared
//     memory, [slot][column][copy], and lane l adds into copy l % copies
//     with native 32-bit shared atomics.  `copies` is the largest power of
//     two up to 32 at which the cells fit in 48 KB: at 32 (TPC-H Q1) no two
//     lanes of a warp meet at a cell or a bank; with many slots there are
//     fewer copies, but rows also spread over more cells.  A 64-bit sum is
//     two 32-bit adds, the carry out of the low word passed up.  (A 64-bit
//     shared atomicAdd compiles to a compare-and-swap loop on sm_90a.)
//   - the block folds each output's copies into one 64-bit value and adds
//     it, when non-zero, into the global outputs with one atomic; the grid
//     is as many blocks as the card holds at once, two an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;
constexpr int kMaxDomain = 256;
constexpr int kRowsPerLane = 4;
constexpr int kStep = 32 * kRowsPerLane;  // rows a warp takes a step
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
constexpr int kCellBytesMax = 48 * 1024;  // the static shared-memory limit
constexpr int kMaxCopiesLog2 = 5;         // 32 copies: one a lane

struct Params {
  const int* gid;
  const long long* sum_vals[kMaxCols];       // sum column s adds sum_vals[s] where
  signed char sum_cnt[kMaxCols];             // count column sum_cnt[s]'s mask holds
  const unsigned char* cnt_masks[kMaxCols];  // count column c counts cnt_masks[c]
                                             // (null: the live rows)
  signed char item_sum[kMaxCols];  // output column j: sum column (-1: none)
  signed char item_cnt[kMaxCols];  // output column j: count column
  int ns, nc, k, domain;
  int shift;  // log2 of the cell copies of a (slot, column)
  long long n;
  unsigned long long* sums;    // [domain, k], zeroed by the caller
  unsigned long long* counts;  // [domain, k], zeroed by the caller
};

// A lane's 4 group ids of the step at `base` (-1 past the end): rows
// base + 4*lane + i when `vec`, else base + 32*i + lane.
__device__ __forceinline__ void load_gid(const Params& p, long long base, int lane, bool vec,
                                         int (&g)[kRowsPerLane]) {
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p.gid + base) + lane);
    g[0] = q.x; g[1] = q.y; g[2] = q.z; g[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const long long r = base + 32 * i + lane;
      g[i] = r < p.n ? __ldg(p.gid + r) : -1;
    }
  }
}

// Two blocks an SM: a thread may take 128 registers, which hold a step's
// loads (8 value columns * 4 rows * 8 B) without spilling.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
smalldomain_sum_count_kernel(const __grid_constant__ Params p) {
  // three planes of cells: the low and the high words of the sums, then
  // the counts
  extern __shared__ unsigned cells[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int copies = 1 << p.shift;
  const int sum_cells = (p.domain * p.ns) << p.shift;
  const int ncells = 2 * sum_cells + ((p.domain * p.nc) << p.shift);
  for (int i = threadIdx.x; i < ncells; i += blockDim.x) cells[i] = 0u;
  __syncthreads();
  const int mine = lane & (copies - 1);
  unsigned* lo32 = cells + mine;
  unsigned* hi32 = cells + sum_cells + mine;
  unsigned* cnt32 = cells + 2 * sum_cells + mine;

  const long long steps = (p.n + kStep - 1) / kStep;
  const long long stride = (long long)gridDim.x * warps;
  long long st = (long long)blockIdx.x * warps + warp;
  int gn[kRowsPerLane];  // the next step's group ids
  if (st < steps) load_gid(p, st * kStep, lane, kVec && st * kStep + kStep <= p.n, gn);
  for (; st < steps; st += stride) {
    const long long base = st * kStep;
    const bool vec = kVec && base + kStep <= p.n;
    int g[kRowsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) g[i] = gn[i];
    const long long nb = base + stride * kStep;
    if (nb < p.n) load_gid(p, nb, lane, kVec && nb + kStep <= p.n, gn);

    unsigned live = 0;  // bit i: the lane's row i is live
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i)
      live |= (unsigned)g[i] < (unsigned)p.domain ? 1u << i : 0u;
    if (!__any_sync(~0u, live)) continue;

    // every load of the step, then the work
    unsigned mw[kMaxCols];  // vec: the 4 mask bytes; else: 4 mask bits
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      mw[c] = 0;
      const unsigned char* m = p.cnt_masks[c];
      if (c >= p.nc || m == nullptr || !live) continue;
      if (vec) {
        mw[c] = __ldg(reinterpret_cast<const unsigned*>(m + base) + lane);
      } else {
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i)
          if ((live >> i) & 1u) mw[c] |= __ldg(m + base + 32 * i + lane) ? 1u << i : 0u;
      }
    }
    unsigned long long v[kMaxCols][kRowsPerLane];
#pragma unroll
    for (int s = 0; s < kMaxCols; ++s) {
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) v[s][i] = 0ULL;
      if (s >= p.ns || !live) continue;
      const long long* vp = p.sum_vals[s];
      if (vec) {
        const longlong2* q = reinterpret_cast<const longlong2*>(vp + base) + 2 * lane;
        const longlong2 a = __ldg(q), b = __ldg(q + 1);
        v[s][0] = a.x; v[s][1] = a.y; v[s][2] = b.x; v[s][3] = b.y;
      } else {
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i)
          if ((live >> i) & 1u) v[s][i] = __ldg(vp + base + 32 * i + lane);
      }
    }
    unsigned mb[kMaxCols];  // bit i: row i is live and valid under count column c
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (p.cnt_masks[c] == nullptr) {
        mb[c] = live;
      } else if (vec) {
        unsigned b = 0;
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) b |= ((mw[c] >> (8 * i)) & 0xFFu) ? 1u << i : 0u;
        mb[c] = b & live;
      } else {
        mb[c] = mw[c] & live;
      }
    }

#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c >= p.nc) break;
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i)
        if ((mb[c] >> i) & 1u) atomicAdd(&cnt32[(g[i] * p.nc + c) << p.shift], 1u);
    }

#pragma unroll
    for (int s = 0; s < kMaxCols; ++s) {
      if (s >= p.ns) break;
      unsigned ok = 0;  // the bits of count column sum_cnt[s]
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c == p.sum_cnt[s]) ok = mb[c];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        if ((ok >> i) & 1u) {
          const int cell = (g[i] * p.ns + s) << p.shift;
          const unsigned lo = (unsigned)v[s][i];
          const unsigned old = atomicAdd(&lo32[cell], lo);
          const unsigned hi = (unsigned)(v[s][i] >> 32) + ((unsigned)(old + lo) < lo ? 1u : 0u);
          if (hi) atomicAdd(&hi32[cell], hi);
        }
      }
    }
  }
  __syncthreads();

  // each output folds its copies, starting at a copy of its own so that
  // neighbouring threads read other banks
  for (int o = threadIdx.x; o < p.domain * p.k; o += blockDim.x) {
    const int gg = o / p.k, j = o - gg * p.k;
    const int s = p.item_sum[j];
    if (s >= 0) {
      const unsigned* lo = cells + ((gg * p.ns + s) << p.shift);
      unsigned long long x = 0ULL;
      for (int l = 0; l < copies; ++l) {
        const int r = (l + o) & (copies - 1);
        x += ((unsigned long long)lo[sum_cells + r] << 32) | lo[r];
      }
      if (x) atomicAdd(&p.sums[o], x);
    }
    const unsigned* cn = cells + 2 * sum_cells + ((gg * p.nc + p.item_cnt[j]) << p.shift);
    unsigned long long x = 0ULL;
    for (int l = 0; l < copies; ++l) x += cn[(l + o) & (copies - 1)];
    if (x) atomicAdd(&p.counts[o], x);
  }
}

}  // namespace

// Launch on `stream`.  sum_vals: ns value pointers, sum_cnt: the count
// column whose mask each sum column takes; cnt_masks: nc mask pointers
// (null: count the live rows); item_sum/item_cnt: k column indices
// (item_sum -1: a count-only item).  sums/counts: [domain, k] int64,
// zeroed by the caller.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int smalldomain_sum_count_launch(
    const void* gid, long long n, int domain, int ns, const void* const* sum_vals,
    const signed char* sum_cnt, int nc, const void* const* cnt_masks, int k,
    const signed char* item_sum, const signed char* item_cnt, void* sums, void* counts,
    void* stream) {
  if (k < 1 || k > kMaxCols || ns < 0 || ns > kMaxCols || nc < 1 || nc > kMaxCols ||
      domain < 1 || domain > kMaxDomain || n < 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.gid = (const int*)gid;
  for (int s = 0; s < ns; ++s) {
    if (sum_vals[s] == nullptr || sum_cnt[s] < 0 || sum_cnt[s] >= nc)
      return (int)cudaErrorInvalidValue;
    p.sum_vals[s] = (const long long*)sum_vals[s];
    p.sum_cnt[s] = sum_cnt[s];
  }
  for (int c = 0; c < nc; ++c) p.cnt_masks[c] = (const unsigned char*)cnt_masks[c];
  for (int j = 0; j < k; ++j) {
    if (item_sum[j] < -1 || item_sum[j] >= ns || item_cnt[j] < 0 || item_cnt[j] >= nc)
      return (int)cudaErrorInvalidValue;
    p.item_sum[j] = item_sum[j];
    p.item_cnt[j] = item_cnt[j];
  }
  p.ns = ns; p.nc = nc; p.k = k; p.domain = domain; p.n = n;
  p.sums = (unsigned long long*)sums;
  p.counts = (unsigned long long*)counts;
  if (n == 0) return 0;

  // the most copies whose cells fit: one copy of every cell is at most
  // 256 slots * 24 words * 4 B = 24 KB, so at least two fit
  const size_t copy_bytes = (size_t)domain * (2 * ns + nc) * sizeof(unsigned);
  p.shift = kMaxCopiesLog2;
  while ((copy_bytes << p.shift) > kCellBytesMax) --p.shift;
  const size_t smem = copy_bytes << p.shift;

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (sms < 1) return (int)cudaErrorInvalidConfiguration;
  const long long warps = kThreads / 32;
  const long long steps = (n + kStep - 1) / kStep;
  const long long want = (steps + warps - 1) / warps;
  const long long most = (long long)sms * kBlocksPerSM;
  const long long blocks = want < most ? want : most;
  // a count cell takes at most the rows of its block: 32 bits must hold them
  if ((steps + blocks * warps - 1) / (blocks * warps) * kStep * warps >= (1LL << 32))
    return (int)cudaErrorInvalidValue;

  // 16-byte loads need 16-byte aligned group ids and values, 4-byte masks
  bool vec = ((uintptr_t)gid & 15) == 0;
  for (int s = 0; s < ns; ++s) vec = vec && ((uintptr_t)p.sum_vals[s] & 15) == 0;
  for (int c = 0; c < nc; ++c) vec = vec && ((uintptr_t)p.cnt_masks[c] & 3) == 0;

  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    smalldomain_sum_count_kernel<true><<<(int)blocks, kThreads, smem, st>>>(p);
  else
    smalldomain_sum_count_kernel<false><<<(int)blocks, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}
