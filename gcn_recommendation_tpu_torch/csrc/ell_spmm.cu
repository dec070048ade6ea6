// ELL bucket reduce for Hopper (sm_90a): every degree bucket of one parts
// table in one launch,
//   out[row0 + r] = sum_j  w[r, j] * x[idx[r, j]]          (f32 sum, column order)
// for each bucket of a descriptor table (ops/spmm.py::BucketTable), with
// rows of zeros where an entry has width 0 (the parts table's zeros row).
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA's
// gather and reduce (gcn_recommendation_tpu/ops/spmm.py::_bucket_reduce).
// The port's plain version, the same function in ops/spmm.py, gathers
// emb[idx] into a [rows, width, d] tensor, multiplies it into a second one
// and reduces, so every gathered row goes through device memory about four
// times, and a parts table takes some fifty launches.
//
// Bound.  The kernel is bound by the bytes it gathers: one source row per
// slot (width x rows of them, padding included), against one read of ids,
// weights and source table and one write of the output.  At the books
// graph (d = 64, 2,332,206 slots a parts table) the 18.4 MB source table
// stays in the 50 MB L2, so the 597 MB gathered come from L2; at the
// north-star graph (d = 256, 35.3M slots a product, a 368 MB source chunk)
// they come from HBM, 36 GB a product.
//
// Design.  The gathered rows never leave registers.  A group of 8, 16 or
// 32 lanes owns one output row (d = 64: 16 lanes with one float4 each, one
// 256-byte request a source row; d = 256: a warp with two float4s a lane);
// the group size and the float4s a lane follow from d, and a d above 512
// runs slabs of 512 columns as the grid's second dimension.  The row's ids
// and weights are contiguous ([rows, width] row-major): each lane loads one
// slot of a round (a coalesced read of `lanes` slots), the next round's
// slots are fetched before this round's rows are gathered, and the gathers
// go out 8 (4 at d > 256) source rows at a time, each slot handed to the
// lanes by a shuffle.  The sum stays in f32 registers in column order and
// the row is written once.  Eight groups make a block: eight rows of one
// bucket, or, for a row at least SPLIT_MIN_WIDTH wide (the north star's
// buckets reach 16,384), one row split into eight contiguous slices whose
// partial sums are added in shared memory in slice order, so the result
// does not depend on the schedule (no atomics).  The descriptor lists the
// widest buckets first, so their long rows start first and the narrow
// rows fill in behind them.
//
// Numbers.  Each term is __fmul_rn then __fadd_rn (the repository builds
// with -fmad=false besides): for widths up to 4 in float32 the result is
// bit-equal to the plain version's sum of width-1 gathers; wider buckets
// differ from torch.sum(dim=1) only by its summation order.  bfloat16
// storage: both operands are widened exactly, and when both are bfloat16
// their product is rounded to bfloat16 as the plain version's bfloat16
// multiply rounds it, widened, and added in float32.  The output is float32
// or bfloat16 (rounded to nearest even once, from the float32 sum).  A
// source id outside [0, n) reads as a row of zeros.  Widths that are not a
// multiple of 4 are padded with zero columns by the wrapper, so every row is
// whole groups of 4 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroups = 8;  // lane groups a block: its rows, or the slices of one wide row
constexpr int kMaxLanes = 32;
constexpr int kMaxCpl = 4;  // groups of 4 columns a lane, at most (512 columns a slab)

// One entry of the descriptor table: eight int64, as ops/spmm.py writes them.
struct Entry {
  long long block0;  // the entry's first block
  long long row0;    // its first output row
  long long rows;    // its output rows
  long long width;   // slots a row; 0: rows of zeros
  long long idx;     // address of its [rows, width] int64 source ids
  long long w;       // address of its [rows, width] weights
  long long wide;    // 1: one row a block, split over the groups; 0: kGroups rows a block
  long long unused;
};

// 4 consecutive elements of a row, widened to float32 (exactly)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load_w(const float* w, long long e) { return __ldg(w + e); }

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, long long e) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(w) + e)) << 16);
}

template <bool kRound>
__device__ __forceinline__ float term(float w, float v) {
  float p = __fmul_rn(v, w);
  if constexpr (kRound) p = __bfloat162float(__float2bfloat16_rn(p));
  return p;
}

template <bool kRound>
__device__ __forceinline__ void accumulate(float4& acc, float w, const float4& v) {
  acc.x = __fadd_rn(acc.x, term<kRound>(w, v.x));
  acc.y = __fadd_rn(acc.y, term<kRound>(w, v.y));
  acc.z = __fadd_rn(acc.z, term<kRound>(w, v.z));
  acc.w = __fadd_rn(acc.w, term<kRound>(w, v.w));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ void store4(float* out, const float4& v) {
  *reinterpret_cast<float4*>(out) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(out) = u;
}

// one slot's source row (-1 outside [0, n)) and weight
template <typename TW>
__device__ __forceinline__ void fetch(const long long* ids, const TW* ws, long long e, long long n,
                                      int& src, float& w) {
  const long long id = __ldg(ids + e);
  src = static_cast<unsigned long long>(id) < static_cast<unsigned long long>(n)
            ? static_cast<int>(id) : -1;
  w = load_w(ws, e);
}

template <typename TX, typename TW, int kCpl>
__global__ void __launch_bounds__(kGroups * kMaxLanes)
ell_spmm_kernel(const Entry* __restrict__ table, int n_entries, const TX* __restrict__ x,
                long long n, int d, void* __restrict__ out, int out_bf16, int lanes_log2) {
  constexpr bool kRound =
      std::is_same<TX, __nv_bfloat16>::value && std::is_same<TW, __nv_bfloat16>::value;
  constexpr int kBatch = kCpl >= 4 ? 4 : 8;  // source rows in flight a lane
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x >> lanes_log2;
  const unsigned group_mask =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));

  // this block's entry: the last whose first block is not past it
  const long long blk = blockIdx.x;
  int lo = 0, hi = n_entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&table[mid].block0) <= blk) lo = mid; else hi = mid - 1;
  }
  const Entry* en = table + lo;
  const long long b = blk - __ldg(&en->block0);
  const long long rows = __ldg(&en->rows);
  const int width = static_cast<int>(__ldg(&en->width));
  const bool wide = __ldg(&en->wide) != 0;

  // the slots this group sums: a whole row, or one slice of a wide row
  long long r;
  int begin = 0, end = 0;
  if (wide) {
    r = b;
    const int slice = (width + kGroups - 1) / kGroups;
    begin = min(width, group * slice);
    end = min(width, begin + slice);
  } else {
    r = b * kGroups + group;
    if (r < rows) end = width;
  }
  const long long* ids = reinterpret_cast<const long long*>(__ldg(&en->idx)) + r * width;
  const TW* ws = reinterpret_cast<const TW*>(__ldg(&en->w)) + r * width;

  // this block's slab: groups of 4 columns c0 .. c0 + lanes * kCpl of the row's d / 4
  const int chunks = d >> 2;
  const int c0 = blockIdx.y * (lanes * kCpl);

  // -0 + t == t for every t: the first term enters the sum exactly
  float4 acc[kCpl];
#pragma unroll
  for (int k = 0; k < kCpl; ++k) acc[k] = make_float4(-0.0f, -0.0f, -0.0f, -0.0f);

  int my_src = -1;
  float my_w = 0.0f;
  if (begin + lane < end) fetch(ids, ws, begin + lane, n, my_src, my_w);
  for (int e = begin; e < end; e += lanes) {
    const int cur_src = my_src;
    const float cur_w = my_w;
    if (e + lanes + lane < end) fetch(ids, ws, e + lanes + lane, n, my_src, my_w);
    const int count = min(lanes, end - e);
    for (int i0 = 0; i0 < count; i0 += kBatch) {
      float4 v[kBatch][kCpl];
      float wv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int src = __shfl_sync(group_mask, cur_src, (i0 + i) & (lanes - 1), lanes);
        wv[i] = __shfl_sync(group_mask, cur_w, (i0 + i) & (lanes - 1), lanes);
        const TX* row = x + static_cast<long long>(src) * d;
#pragma unroll
        for (int k = 0; k < kCpl; ++k) {
          const int c = c0 + lane + k * lanes;
          v[i][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (i0 + i < count && src >= 0 && c < chunks) v[i][k] = load4(row + 4 * c);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i0 + i < count) {
#pragma unroll
          for (int k = 0; k < kCpl; ++k) accumulate<kRound>(acc[k], wv[i], v[i][k]);
        }
      }
    }
  }

  if (wide) {  // the slices' partial sums, added in slice order
    __shared__ float4 part[kGroups][kMaxLanes * kMaxCpl];
#pragma unroll
    for (int k = 0; k < kCpl; ++k) part[group][lane + k * lanes] = acc[k];
    __syncthreads();
    if (group != 0) return;
#pragma unroll
    for (int k = 0; k < kCpl; ++k) {
      float4 s = part[0][lane + k * lanes];
      for (int g = 1; g < kGroups; ++g) s = add4(s, part[g][lane + k * lanes]);
      acc[k] = s;
    }
  }
  if (r >= rows) return;
  if (width == 0) {
#pragma unroll
    for (int k = 0; k < kCpl; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const long long at = (__ldg(&en->row0) + r) * d;
#pragma unroll
  for (int k = 0; k < kCpl; ++k) {
    const int c = c0 + lane + k * lanes;
    if (c >= chunks) continue;
    if (out_bf16)
      store4(static_cast<__nv_bfloat16*>(out) + at + 4 * c, acc[k]);
    else
      store4(static_cast<float*>(out) + at + 4 * c, acc[k]);
  }
}

template <typename TX, typename TW>
int launch(const Entry* table, int n_entries, long long n_blocks, const void* x, long long n,
           int d, void* out, int out_bf16, cudaStream_t stream) {
  const int chunks = d / 4;
  // lanes a row: the power of two that holds its groups of 4 columns, 8 to 32;
  // then one, two or four of them a lane, and slabs of 128 beyond
  const int lanes_log2 = chunks <= 8 ? 3 : chunks <= 16 ? 4 : 5;
  const int cpl = chunks <= 32 ? 1 : chunks <= 64 ? 2 : 4;
  const int per_slab = (1 << lanes_log2) * cpl;
  const dim3 grid(static_cast<unsigned>(n_blocks), (chunks + per_slab - 1) / per_slab);
  const int threads = kGroups << lanes_log2;
  const TX* xs = static_cast<const TX*>(x);
  if (cpl == 1)
    ell_spmm_kernel<TX, TW, 1><<<grid, threads, 0, stream>>>(table, n_entries, xs, n, d, out,
                                                             out_bf16, lanes_log2);
  else if (cpl == 2)
    ell_spmm_kernel<TX, TW, 2><<<grid, threads, 0, stream>>>(table, n_entries, xs, n, d, out,
                                                             out_bf16, lanes_log2);
  else
    ell_spmm_kernel<TX, TW, 4><<<grid, threads, 0, stream>>>(table, n_entries, xs, n, d, out,
                                                             out_bf16, lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or -1 for
// arguments the kernel does not take.  table: [n_entries, 8] int64 on the
// device (ops/spmm.py::BucketTable), entries in issue order with block0
// ascending from 0 and n_blocks blocks in all; x [n, d] float32 or bfloat16
// (x_bf16), 16-byte aligned, d a positive multiple of 4, n < 2^31; the
// entries' weights float32 or bfloat16 (w_bf16); out [rows, d] float32 or
// bfloat16 (out_bf16), every entry's rows inside it.  All contiguous.
extern "C" int ell_spmm_launch(const void* table, int n_entries, long long n_blocks,
                               const void* x, int x_bf16, int w_bf16, long long n, int d,
                               void* out, int out_bf16, void* stream) {
  if (d < 4 || d % 4 != 0 || n < 0 || n >= (1LL << 31) || n_entries <= 0 ||
      n_blocks <= 0 || n_blocks >= (1LL << 31) || (d / 4 + 127) / 128 > 65535)
    return -1;
  const Entry* t = static_cast<const Entry*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (w_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(t, n_entries, n_blocks, x, n, d, out, out_bf16, s);
    return launch<__nv_bfloat16, float>(t, n_entries, n_blocks, x, n, d, out, out_bf16, s);
  }
  if (w_bf16) return launch<float, __nv_bfloat16>(t, n_entries, n_blocks, x, n, d, out, out_bf16, s);
  return launch<float, float>(t, n_entries, n_blocks, x, n, d, out, out_bf16, s);
}
