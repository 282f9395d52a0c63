// K2: move the rows of many columns and their validity masks by one index.
//
// Replaces no TPU kernel.  The reference moves a table's rows with jnp
// gathers that XLA fuses; the port did it with PyTorch's index kernel,
// one for each column's data and one for its mask, plus an AND of the
// mask with the caller's row mask: for k columns 3k launches that read
// the int64 index 2k times and write every mask twice.  The card's
// profile of TPC-H at SF10 names that index kernel its largest cost.
// This kernel reads the index once and writes each output once, in one
// launch for up to kMaxItems buffers.
//
// What bounds it: bytes.  Per output row: the index (8 B; the outer index
// too, when composed), each buffer's row at the source (its width, or a
// whole 32-byte sector where the rows are scattered), each output row,
// and the row mask (1 B) when given.  The design:
//   - items: a data buffer or a validity mask, described by value in the
//     launch's parameters (source, stride, output, row width), so a CUDA
//     graph records the launch as it is.  The kernel never looks at a
//     dtype: a row is `width` bytes moved in the widest unit (1, 2, 4 or
//     8 B) that the width, the source's stride and both pointers allow, so
//     list columns [capacity, k] and unsigned storage take the same path.
//   - rows: a thread takes kPairs pairs of neighbouring output rows, the
//     pairs of a block interleaved so that a warp's loads and stores are
//     contiguous.  It loads the index of its rows (16-byte loads of two
//     int64 indices) first, then per item all its source rows, then
//     stores them, two rows as one store where a pair fits 16 bytes.  At
//     64 registers four blocks fit an SM, so an SM keeps 4096 independent
//     row loads in flight to cover the latency of scattered reads.
//   - order: rows are the outer loop, items the inner, so the index is
//     read once.  Item after item over all rows would re-read it per item
//     but keep a source that fits L2 resident while its rows are scattered
//     (a mask's 32 rows a sector); on an H100 at TPC-H SF10 that order took
//     the nine queries' takes 102 ms a pass against this order's 64 ms
//     (the per-column PyTorch form: 125 ms), since most takes read their
//     rows nearly in order: a join's probe side, a compaction.
//   - the null rule: a negative index (or outer index) reads row 0 and
//     gives a NULL row: the output mask is cleared.  A mask item's output
//     is src_valid[j] & mask[i] & (j >= 0); a data item's is src[max(j, 0)].
//   - an optional outer index composes in the kernel: row i takes
//     idx[sel[i]], so the caller never materializes idx[sel].

#include <cstdint>
#include <cuda_runtime.h>

// what the caller passes per item (ops/take.py builds the same layout);
// outside the unnamed namespace, so that take_launch keeps external linkage
struct TakeItem {
  const void* src;
  void* dst;
  long long stride;  // source bytes from one row to the next (0: one row for all)
  int width;         // bytes a row
  int masked;        // a validity mask: AND the row mask and the null rule
};

namespace {

constexpr int kMaxItems = 32;
constexpr int kPairs = 2;  // pairs of rows a thread moves
constexpr int kRows = 2 * kPairs;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;  // at most 64 registers a thread

struct Item {
  const unsigned char* src;
  unsigned char* dst;
  long long stride;
  int width;
  int log2_unit;  // the unit moved: 1 << log2_unit bytes
  int masked;
  int pair_store;  // two rows as one store (one unit a row, <= 8 B, aligned)
};

struct Params {
  Item items[kMaxItems];
  const void* idx;             // [m] int32 or int64
  const long long* sel;        // [n] outer index into idx, or null
  const unsigned char* mask;   // [n] row mask, or null
  long long mask_stride;       // bytes between mask rows (0: one value)
  long long n;                 // output rows
  int nitems;
  int any_masked;
  int vec;  // 16-byte index (and outer index) loads are aligned
};

template <int U> struct Unit;
template <> struct Unit<1> { using T = unsigned char; using P = unsigned short; };
template <> struct Unit<2> { using T = unsigned short; using P = unsigned int; };
template <> struct Unit<4> { using T = unsigned int; using P = uint2; };
template <> struct Unit<8> { using T = unsigned long long; using P = uint4; };

template <int U>
__device__ __forceinline__ typename Unit<U>::P pack(typename Unit<U>::T a, typename Unit<U>::T b) {
  using P = typename Unit<U>::P;
  if constexpr (U == 1) {
    return (P)(a | ((unsigned)b << 8));
  } else if constexpr (U == 2) {
    return (P)(a | ((unsigned)b << 16));
  } else if constexpr (U == 4) {
    return make_uint2(a, b);
  } else {
    return make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b, (unsigned)(b >> 32));
  }
}

// The first output row of the thread's pair k: pairs interleave over the
// block's threads.
__device__ __forceinline__ long long pair_row(long long base, int k) {
  return 2 * (base + (long long)k * kThreads);
}

// Row r of the thread (0 .. kRows-1) is output row pair_row(base, r / 2) + r % 2.
template <int U>
__device__ __forceinline__ void move(const Item& it, long long base, const long long (&j)[kRows],
                                     unsigned live, const unsigned char (&m)[kRows]) {
  using T = typename Unit<U>::T;
  const int units = it.width >> it.log2_unit;  // units a row
  for (int u = 0; u < units; ++u) {
    T v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if ((live >> r) & 1u) {
        const long long jj = j[r] < 0 ? 0 : j[r];
        v[r] = __ldg(reinterpret_cast<const T*>(it.src + jj * it.stride) + u);
      } else {
        v[r] = T();
      }
    }
    if constexpr (U == 1) {
      if (it.masked) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] &= m[r];
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int a = 2 * p, b = 2 * p + 1;
      const unsigned both = (live >> a) & (live >> b) & 1u;
      if (both && it.pair_store) {
        *reinterpret_cast<typename Unit<U>::P*>(it.dst + pair_row(base, p) * U) =
            pack<U>(v[a], v[b]);
        continue;
      }
      T* out = reinterpret_cast<T*>(it.dst + pair_row(base, p) * it.width) + u;
      if ((live >> a) & 1u) out[0] = v[a];
      if ((live >> b) & 1u) out[units] = v[b];
    }
  }
}

template <typename I, bool kSel>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) take_kernel(const __grid_constant__ Params p) {
  // pair q = block base + k * blockDim + thread
  const long long npairs = (p.n + 1) >> 1;
  const long long base = (long long)blockIdx.x * kThreads * kPairs + threadIdx.x;
  const I* idx = static_cast<const I*>(p.idx);
  long long j[kRows];
  unsigned live = 0;  // bit r: row r of the thread exists
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const long long q = base + (long long)k * kThreads;
    const long long r0 = 2 * q;
    j[2 * k] = j[2 * k + 1] = 0;
    if (q >= npairs) continue;
    const bool full = r0 + 1 < p.n;
    live |= (full ? 3u : 1u) << (2 * k);
    if constexpr (kSel) {
      long long s0, s1 = 0;
      if (full && p.vec) {
        const longlong2 s = __ldg(reinterpret_cast<const longlong2*>(p.sel) + q);
        s0 = s.x; s1 = s.y;
      } else {
        s0 = __ldg(p.sel + r0);
        if (full) s1 = __ldg(p.sel + r0 + 1);
      }
      j[2 * k] = s0 < 0 ? -1 : (long long)__ldg(idx + s0);
      if (full) j[2 * k + 1] = s1 < 0 ? -1 : (long long)__ldg(idx + s1);
    } else if (full && p.vec) {
      if constexpr (sizeof(I) == 8) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(idx) + q);
        j[2 * k] = v.x; j[2 * k + 1] = v.y;
      } else {
        const int2 v = __ldg(reinterpret_cast<const int2*>(idx) + q);
        j[2 * k] = v.x; j[2 * k + 1] = v.y;
      }
    } else {
      j[2 * k] = (long long)__ldg(idx + r0);
      if (full) j[2 * k + 1] = (long long)__ldg(idx + r0 + 1);
    }
  }
  if (!live) return;

  unsigned char m[kRows];  // the output mask's factor: row mask and the null rule
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = 0;
  if (p.any_masked) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!((live >> r) & 1u)) continue;
      const long long i = pair_row(base, r >> 1) + (r & 1);
      unsigned char x = j[r] >= 0 ? 1 : 0;
      if (p.mask != nullptr) x &= __ldg(p.mask + i * p.mask_stride);
      m[r] = x;
    }
  }

  for (int t = 0; t < p.nitems; ++t) {
    const Item& it = p.items[t];
    switch (it.log2_unit) {
      case 0: move<1>(it, base, j, live, m); break;
      case 1: move<2>(it, base, j, live, m); break;
      case 2: move<4>(it, base, j, live, m); break;
      default: move<8>(it, base, j, live, m); break;
    }
  }
}

bool aligned(const void* ptr, long long bytes) { return ((uintptr_t)ptr % bytes) == 0; }

}  // namespace

// Launch on `stream`: for each of the nitems items, output row i of its dst
// takes source row idx[i] (idx[sel[i]] when sel is given) under the null
// rule; a masked item (a 1-byte validity mask) also ANDs mask[i * mask_stride]
// when mask is given.  idx_bytes: 4 (int32) or 8 (int64); sel is int64.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int take_launch(const TakeItem* items, int nitems, const void* idx, int idx_bytes,
                           const void* sel, const void* mask, long long mask_stride, long long n,
                           void* stream) {
  if (nitems < 0 || nitems > kMaxItems || n < 0 || (idx_bytes != 4 && idx_bytes != 8) ||
      idx == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  for (int t = 0; t < nitems; ++t) {
    const TakeItem& in = items[t];
    if (in.src == nullptr || in.dst == nullptr || in.width < 1 || in.stride < 0 ||
        (in.masked && in.width != 1))
      return (int)cudaErrorInvalidValue;
    int lg = 3;
    while (lg > 0) {
      const long long u = 1LL << lg;
      if (in.width % u == 0 && in.stride % u == 0 && aligned(in.src, u) && aligned(in.dst, u)) break;
      --lg;
    }
    Item& it = p.items[t];
    it.src = (const unsigned char*)in.src;
    it.dst = (unsigned char*)in.dst;
    it.stride = in.stride;
    it.width = in.width;
    it.log2_unit = lg;
    it.masked = in.masked ? 1 : 0;
    it.pair_store = in.width == (1 << lg) && lg <= 3 && aligned(in.dst, 2LL << lg);
    p.any_masked |= it.masked;
  }
  p.idx = idx;
  p.sel = (const long long*)sel;
  p.mask = (const unsigned char*)mask;
  p.mask_stride = mask_stride;
  p.n = n;
  p.nitems = nitems;
  p.vec = sel != nullptr ? aligned(sel, 16) : aligned(idx, 2LL * idx_bytes);
  if (n == 0 || nitems == 0) return 0;

  const long long rows_per_block = 2LL * kThreads * kPairs;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (sel != nullptr) {
    if (idx_bytes == 8)
      take_kernel<long long, true><<<(unsigned)blocks, kThreads, 0, st>>>(p);
    else
      take_kernel<int, true><<<(unsigned)blocks, kThreads, 0, st>>>(p);
  } else {
    if (idx_bytes == 8)
      take_kernel<long long, false><<<(unsigned)blocks, kThreads, 0, st>>>(p);
    else
      take_kernel<int, false><<<(unsigned)blocks, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
