// Masked top-k in lax.top_k's tie order for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package masks with a scatter or a
// comparison and selects with jax.lax.top_k, which XLA lowers on the TPU.
// The port reproduced that order with a full stable sort of every row
// (ops/topk.py: a [B, N+1] copy, a scatter_ of the mask, torch.sort of the
// whole row, the first k kept).  This kernel gives the same values and
// indices, bit for bit, in one read of the score block.
//
// Contract, per row b of scores [B, N] float32 (read, never written):
//   * every id of filter [b, :] (int64, [B, F]) inside [0, N) is masked: its
//     value becomes mask_value (ops/topk.py::MASK_VALUE); other ids (the pad
//     N) are skipped;
//   * the k items first in the total order (value descending, index
//     ascending) are written to values [b, :k] (float32) and indices
//     [b, :k] (int64), in that order.  -0.0 and +0.0 are one value; NaN ranks
//     above +inf, as torch.sort ranks it; a masked item competes with the
//     value mask_value like any other item, so a row with fewer than k
//     unmasked items comes out as the sort gives it.
//
// Bound: memory traffic.  A row is N * 4 bytes and its output 12 * k
// (80 KB against 240 bytes at the evaluation's [1024, 20000], k = 20):
// reading the scores once is the whole of the least time.  So the row is
// read once, and everything after that works on a few hundred items:
//   1. the row's filter ids set bits of a seen bitmap in shared memory
//      (N / 8 bytes);
//   2. the row is streamed from device memory (float4 loads, U in flight a
//      thread), each value turned into an order-preserving 32-bit key
//      (mask applied), and each group of S consecutive items keeps only its
//      largest key, in shared memory (a shuffle reduction over S / V lanes);
//   3. a radix select finds the k groups first in the order (group max key
//      descending, group index ascending).  Every item of the row's top k
//      lies in one of them: an item of any other group has k group maxima
//      before it in the total order;
//   4. the items of those k groups (k * S at most, from L2) are the
//      candidates; a radix select over their 64-bit composites (key, then
//      the index reversed, so the composites are distinct and their order is
//      the total order) finds the k-th, and the candidates at or above it
//      are the top k;
//   5. each winner's rank is the number of winners before it; the winner
//      writes its index and its value (re-read from the row, so a -0.0 keeps
//      its sign) at that rank.
// The radix select takes 8 bits a pass from the top of the composite and
// stops at the first pass whose chosen bin holds exactly the items still
// wanted.  The host (ops/topk.py::kernel_plan) picks S, the loads' width V
// and the block size from (N, k): S near sqrt(N / k), so the groups and the
// candidates are both few, within the shared memory a block may hold.
// One block a row; nothing is carried between blocks.
//
// A second kernel, topk_hit_histogram_kernel (at the end of this file),
// reduces an evaluation batch's top-k indices to the histogram of the
// held-out items' positions; it shares this library, so it adds no build.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;  // loads in flight a thread in step 2
constexpr unsigned kFull = 0xffffffffu;

struct Select {
  unsigned long long prefix;  // the chosen bits of the k-th composite
  unsigned long long mask;    // which bits have been chosen
  uint32_t remaining;         // items still wanted among those matching prefix
  int done;
  uint32_t count;             // append cursor
};

// Order-preserving key: a > b as floats (NaN above +inf, -0.0 == +0.0) iff
// key(a) > key(b) as unsigned integers.  Every key is >= key(-inf) > 0.
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int bit_width(uint32_t x) { return x ? 32 - __clz(x) : 0; }

// Position of this lane's flagged item in a list that the block fills
// through `cursor`; every lane of the warp calls it.
__device__ __forceinline__ uint32_t warp_append(bool flag, uint32_t* cursor) {
  const unsigned ballot = __ballot_sync(kFull, flag);
  const int lane = threadIdx.x & 31;
  uint32_t base = 0;
  if (lane == 0 && ballot) base = atomicAdd(cursor, (uint32_t)__popc(ballot));
  base = __shfl_sync(kFull, base, 0);
  return base + __popc(ballot & ((1u << lane) - 1u));
}

// Warp 0: the bin of `hist` (256 counts, highest bin first in the order)
// that holds the sel.remaining-th item, narrowed into `sel`.
__device__ __forceinline__ void pick_bin(const uint32_t* hist, int shift, Select& sel) {
  const int lane = threadIdx.x;
  uint32_t h[8];
  uint32_t own = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = hist[8 * lane + j];
    own += h[j];
  }
  const uint32_t wanted = sel.remaining;
  __syncwarp();
  uint32_t upto = own;  // counts of this lane's bins and of every higher lane's
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_down_sync(kFull, upto, off);
    if (lane + off < 32) upto += y;
  }
  uint32_t above = upto - own;
  if (above < wanted && wanted <= upto) {
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (above + h[j] >= wanted) {
        const uint32_t rem = wanted - above;
        sel.prefix |= (unsigned long long)(8 * lane + j) << shift;
        sel.mask |= 0xffull << shift;
        sel.remaining = rem;
        sel.done = h[j] == rem;
        break;
      }
      above += h[j];
    }
  }
}

// Block-wide: narrows `sel` to the k-th largest of the m distinct composites
// comp(i), i < m, each below 2^bits (k <= m).  Afterwards the k largest are
// exactly those with (comp(i) & sel.mask) >= sel.prefix, and sel.count is 0.
template <class Comp>
__device__ void radix_select(int m, int bits, uint32_t k, Comp comp, uint32_t* hist,
                             Select& sel) {
  if (threadIdx.x == 0) {
    sel.prefix = 0;
    sel.mask = 0;
    sel.remaining = k;
    sel.done = 0;
    sel.count = 0;
  }
  for (int shift = bits - (((bits - 1) & 7) + 1);; shift -= 8) {
    for (int j = threadIdx.x; j < 256; j += blockDim.x) hist[j] = 0;
    __syncthreads();
    const unsigned long long prefix = sel.prefix, mask = sel.mask;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const unsigned long long c = comp(i);
      if ((c & mask) == prefix) atomicAdd(&hist[(c >> shift) & 0xff], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) pick_bin(hist, shift, sel);
    __syncthreads();
    // distinct composites: the last pass (shift 0) always ends with one item
    if (sel.done || shift == 0) break;
  }
}

// V: floats a load (4: float4, the row 16-byte aligned; 1 otherwise).
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
masked_topk_kernel(const float* __restrict__ scores, const int64_t* __restrict__ filter, int f,
                   int n, int k, int s, float mask_value, float* __restrict__ out_val,
                   int64_t* __restrict__ out_idx) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t hist[256];
  __shared__ Select sel;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row = blockIdx.x;
  const int groups = (n + s - 1) / s;
  const int top = groups < k ? groups : k;  // groups that hold the top k
  const int words = (n + 31) / 32;
  uint32_t* seen = smem;                   // [words] bitmap
  uint32_t* gmax = seen + words;           // [groups] largest key of each group
  uint32_t* glist = gmax + groups;         // [top] the groups that hold the top k
  uint32_t* ckey = glist + top;            // [top * s] candidate keys
  uint32_t* cidx = ckey + (size_t)top * s; // [top * s] candidate indices
  uint32_t* wkey = cidx + (size_t)top * s; // [k] winners
  uint32_t* widx = wkey + k;
  const float* x = scores + (size_t)row * n;
  const uint32_t mask_key = order_key(mask_value);

  // 1. the seen set
  for (int w = tid; w < words; w += nthreads) seen[w] = 0u;
  __syncthreads();
  const int64_t* fr = filter + (size_t)row * f;
  for (int j = tid; j < f; j += nthreads) {
    const int64_t id = fr[j];
    if (id >= 0 && id < n) atomicOr(&seen[id >> 5], 1u << (id & 31));
  }
  __syncthreads();

  // 2. one read of the row: the largest key of each group of s items
  const int lanes = s / V;  // lanes a group, a power of two <= 32
  const int nvec = n / V;
  for (int v0 = 0; v0 < nvec; v0 += nthreads * kUnroll) {
    float vals[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * nthreads + tid;
      if (v < nvec) {
        if constexpr (V == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(x) + v);
          vals[u][0] = q.x;
          vals[u][1] = q.y;
          vals[u][2] = q.z;
          vals[u][3] = q.w;
        } else {
          vals[u][0] = __ldg(x + v);
        }
      }
    }
    uint32_t best[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * nthreads + tid;
      best[u] = 0u;  // below every key: lanes past the row's end
      if (v < nvec) {
        const int e = v * V;
        const uint32_t bits = seen[e >> 5] >> (e & 31);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const uint32_t key = ((bits >> t) & 1u) ? mask_key : order_key(vals[u][t]);
          best[u] = key > best[u] ? key : best[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int off = 1; off < lanes; off <<= 1) {
        const uint32_t y = __shfl_xor_sync(kFull, best[u], off);
        best[u] = y > best[u] ? y : best[u];
      }
      const int v = v0 + u * nthreads + tid;
      if (v < nvec && (tid & (lanes - 1)) == 0) gmax[v * V / s] = best[u];
    }
  }
  __syncthreads();

  // 3. the k groups first in (group max descending, group index ascending)
  if (groups > k) {
    const int gbits = bit_width((uint32_t)(groups - 1));
    const uint32_t glo = (uint32_t)((1ull << gbits) - 1);
    auto gcomp = [&](int g) {
      return ((unsigned long long)gmax[g] << gbits) | (unsigned long long)(glo - (uint32_t)g);
    };
    radix_select(groups, 32 + gbits, (uint32_t)k, gcomp, hist, sel);
    const unsigned long long prefix = sel.prefix, mask = sel.mask;
    for (int g0 = 0; g0 < groups; g0 += nthreads) {
      const int g = g0 + tid;
      const bool take = g < groups && (gcomp(g) & mask) >= prefix;
      const uint32_t pos = warp_append(take, &sel.count);
      if (take) glist[pos] = (uint32_t)g;
    }
  } else {
    for (int g = tid; g < groups; g += nthreads) glist[g] = (uint32_t)g;
  }
  __syncthreads();

  // 4. the candidates: every item of those groups
  if (tid == 0) sel.count = 0;
  __syncthreads();
  const int slots = top * s;
  for (int j0 = 0; j0 < slots; j0 += nthreads) {
    const int j = j0 + tid;
    uint32_t e = 0, key = 0;
    bool real = false;
    if (j < slots) {
      e = glist[j / s] * (uint32_t)s + (uint32_t)(j % s);
      real = e < (uint32_t)n;
      if (real) key = ((seen[e >> 5] >> (e & 31)) & 1u) ? mask_key : order_key(__ldg(x + e));
    }
    const uint32_t pos = warp_append(real, &sel.count);
    if (real) {
      ckey[pos] = key;
      cidx[pos] = e;
    }
  }
  __syncthreads();
  const int m = (int)sel.count;  // >= k: each of the top groups holds an item
  __syncthreads();

  // the k-th candidate in the total order
  const int ibits = bit_width((uint32_t)(n - 1));
  const uint32_t ilo = (uint32_t)((1ull << ibits) - 1);
  auto ccomp = [&](int i) {
    return ((unsigned long long)ckey[i] << ibits) | (unsigned long long)(ilo - cidx[i]);
  };
  if (m > k) {
    radix_select(m, 32 + ibits, (uint32_t)k, ccomp, hist, sel);
  } else if (tid == 0) {
    sel.prefix = 0;
    sel.mask = 0;
    sel.count = 0;
  }
  __syncthreads();
  {
    const unsigned long long prefix = sel.prefix, mask = sel.mask;
    for (int i0 = 0; i0 < m; i0 += nthreads) {
      const int i = i0 + tid;
      const bool take = i < m && (ccomp(i) & mask) >= prefix;
      const uint32_t pos = warp_append(take, &sel.count);
      if (take && pos < (uint32_t)k) {
        wkey[pos] = ckey[i];
        widx[pos] = cidx[i];
      }
    }
  }
  __syncthreads();

  // 5. each winner to its rank
  float* ov = out_val + (size_t)row * k;
  int64_t* oi = out_idx + (size_t)row * k;
  for (int w = tid; w < k; w += nthreads) {
    const uint32_t key = wkey[w], e = widx[w];
    const unsigned long long cw = ((unsigned long long)key << 32) | (kFull - e);
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const unsigned long long cj = ((unsigned long long)wkey[j] << 32) | (kFull - widx[j]);
      rank += cj > cw;
    }
    oi[rank] = (int64_t)e;
    // a masked winner takes mask_value; an item whose own value is
    // mask_value has the same bits
    ov[rank] = key == mask_key ? mask_value : __ldg(x + e);
  }
}

template <int V>
int launch(const float* scores, const int64_t* filter, long long rows, int n, int f, int k, int s,
           int threads, float mask_value, float* out_val, int64_t* out_idx, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_topk_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  masked_topk_kernel<V><<<(unsigned)rows, threads, smem, stream>>>(
      scores, filter, f, n, k, s, mask_value, out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes a block needs (ops/topk.py::kernel_plan computes the
// same to choose s).
extern "C" long long masked_topk_smem_bytes(int n, int k, int s) {
  const long long groups = (n + s - 1) / s;
  const long long top = groups < k ? groups : k;
  return 4 * ((n + 31) / 32 + groups + top + 2 * top * s + 2LL * k);
}

// Launch on `stream`; returns a CUDA error code (0 on success), or -1 for
// arguments the kernel does not take.  scores [rows, n] float32 and filter
// [rows, f] int64 (null when f is 0), contiguous, on one device; out_val
// [rows, k] float32 and out_idx [rows, k] int64; 1 <= k <= n; vec 4 needs
// n % 4 == 0 and a 16-byte-aligned base; s a power of two, a multiple of
// vec, at most 32 * vec; threads a multiple of 32, at most 256.
extern "C" int masked_topk_launch(const void* scores, const void* filter, long long rows, int n,
                                  int f, int k, int s, int vec, int threads, float mask_value,
                                  void* out_val, void* out_idx, void* stream_ptr) {
  if (rows <= 0 || n <= 0 || k < 1 || k > n || f < 0) return -1;
  if ((vec != 1 && vec != 4) || s < vec || s > 32 * vec || (s & (s - 1)) != 0) return -1;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return -1;
  if (vec == 4 && (n % 4 != 0 || ((uintptr_t)scores & 15) != 0)) return -1;
  const size_t smem = (size_t)masked_topk_smem_bytes(n, k, s);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (vec == 4)
    return launch<4>((const float*)scores, (const int64_t*)filter, rows, n, f, k, s, threads,
                     mask_value, (float*)out_val, (int64_t*)out_idx, smem, stream);
  return launch<1>((const float*)scores, (const int64_t*)filter, rows, n, f, k, s, threads,
                   mask_value, (float*)out_val, (int64_t*)out_idx, smem, stream);
}

// ---------------------------------------------------------------------------
// Hit histogram of an evaluation batch (ops/topk.py::hit_histogram).
//
// Replaces no Pallas kernel: the JAX package forms each batch's hit and NDCG
// sums with XLA's element-wise ops and reductions, which the port ran as ~18
// eager launches a batch (ops/topk.py::topk_hit_metrics, now the plain
// reference).  Contract, for topk_idx [rows, width] int64, true_items [rows]
// int64 and valid [rows] bool, width <= k:
//   * hist[p], p < k: the valid rows whose held-out item first equals
//     topk_idx [row, p] (a held-out item that was masked counts where it
//     stands, as the plain version counts it);
//   * hist[k]: the valid rows.  Rows with valid false count nowhere.
// The counts are exact integers, the same whatever order the threads run in;
// the host forms Recall@k and NDCG@k from a pass's summed histogram.
//
// Bound: latency.  An evaluation batch's input is 1024 x 20 x 8 bytes and
// 9 KB more (~0.05 us of the card's bandwidth); one block waits on its round
// trips to memory and on its SM's issue rate.  So: a row a thread
// (grid-striding), a pad row left before any load of its indices, kHistChunk
// of a row's indices loaded before they are compared, no division; the
// counts in shared memory, all k + 1 written at the end, so the output needs
// no zeroing launch.  On an H100 this form took 4.7 us at [1024, 20] (a
// launch that does nothing ~1.5), against 6.4 for the same with 16 indices a
// chunk and pad rows loaded, and 10.8 for a coalesced walk of the flat
// [rows * width] block (a division a element, a shared first-column array).

namespace {

constexpr int kHistThreads = 1024;
constexpr int kHistChunk = 8;
constexpr int kHistMaxK = 1024;  // ops/topk.py::MAX_K

__global__ void __launch_bounds__(kHistThreads)
topk_hit_histogram_kernel(const int64_t* __restrict__ topk_idx,
                          const int64_t* __restrict__ true_items,
                          const uint8_t* __restrict__ valid, long long rows, int width, int k,
                          int32_t* __restrict__ hist_out) {
  __shared__ uint32_t hist[kHistMaxK + 1];
  for (int j = threadIdx.x; j <= k; j += blockDim.x) hist[j] = 0u;
  __syncthreads();
  uint32_t valid_rows = 0;
  for (long long r = threadIdx.x; r < rows; r += blockDim.x) {
    if (!valid[r]) continue;
    ++valid_rows;
    const int64_t t = true_items[r];
    const int64_t* row = topk_idx + r * width;
    int pos = width;
    for (int p0 = 0; p0 < width && pos == width; p0 += kHistChunk) {
      int64_t v[kHistChunk];
#pragma unroll
      for (int u = 0; u < kHistChunk; ++u) v[u] = p0 + u < width ? row[p0 + u] : 0;
      // downwards, so the first equal index in the chunk is the one kept
#pragma unroll
      for (int u = kHistChunk - 1; u >= 0; --u)
        if (p0 + u < width && v[u] == t) pos = p0 + u;
    }
    if (pos < width) atomicAdd(&hist[pos], 1u);
  }
  // every lane of every warp reaches this (blockDim is a multiple of 32)
  valid_rows = __reduce_add_sync(kFull, valid_rows);
  if ((threadIdx.x & 31) == 0 && valid_rows) atomicAdd(&hist[k], valid_rows);
  __syncthreads();
  for (int j = threadIdx.x; j <= k; j += blockDim.x) hist_out[j] = (int32_t)hist[j];
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or -1 for
// arguments the kernel does not take.  topk_idx [rows, width] int64,
// true_items [rows] int64, valid [rows] bool (one byte each), contiguous, on
// one device; hist [k + 1] int32, every entry written; 0 <= width <= k <=
// 1024.  Rows may be 0 (the histogram is then all zeros).
extern "C" int topk_hit_histogram_launch(const void* topk_idx, const void* true_items,
                                         const void* valid, long long rows, int width, int k,
                                         void* hist, void* stream_ptr) {
  if (rows < 0 || width < 0 || width > k || k > kHistMaxK) return -1;
  topk_hit_histogram_kernel<<<1, kHistThreads, 0, (cudaStream_t)stream_ptr>>>(
      (const int64_t*)topk_idx, (const int64_t*)true_items, (const uint8_t*)valid, rows, width,
      k, (int32_t*)hist);
  return (int)cudaGetLastError();
}
