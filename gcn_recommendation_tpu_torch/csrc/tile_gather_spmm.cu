// Tile product over compressed tiles for Hopper (sm_90a): the tile edges of
// a graph partition (graph/tiles.py) as a CSR over the R*128 compact output
// rows,
//   out[row] = sum over edges e of row of  w_e * emb[src_e]        (f32 sum)
// with src_e = 128*col_t + c the global source node of the tile entry
// (t, row % 128, c).  It computes, on the nonzeros alone, what the dense
// formulation sums over whole 128x128 tiles.
//
// Replaces the Pallas TPU kernel gcn_recommendation_tpu/ops/block_spmm.py::
// _make_tile_call (inner `kernel`, :79) for tiles that are almost empty.
// The TPU kernel feeds dense tiles to the matrix unit because a row gather
// is slow there; on this card a 256-byte row gather is one coalesced
// request and the embedding table (18 MB at 72,000 x 64) stays in the 50 MB
// L2, so the work follows the nonzeros instead.
//
// Bound.  At the books-shaped partition (188,994 edges in 28,288 compact
// rows, d = 64) each input and the output once are 27.3 MB: 8 bytes an
// edge, the row pointers, the 18.4 MB embedding and the 7.2 MB output,
// 0.0081 ms at the H100's 3.35 TB/s.  The 24 MFLOP are nothing: the kernel
// is bound by bytes and, at this size, by the latency of one short wave of
// dependent loads (row pointer -> edge -> source row).  The dense tiles of
// the same partition are 219 MB.
//
// Design.  A group of 8, 16 or 32 lanes owns one output row of one slab of
// 128 columns (16 lanes at d = 64: one float4 a lane, one 256-byte request
// a source row); a wider embedding runs ceil(d / 128) slabs as the grid's
// second dimension, each over the same edges (d = 256: two).  What a
// short launch like this waits for is the chain of dependent loads of its
// longest row (row pointer -> edge -> source row), so the group shortens
// it: each lane loads one edge of the row (a coalesced read of up to
// `lanes` edges), the edges of the next round are fetched before this
// round's rows are gathered, and the gathers go out eight at a time, the
// edge handed to all lanes by a shuffle.  The sum stays in registers, in
// edge order, with __fmaf_rn; the row is written once, zeros when it has no
// edge.  One thread owns each output element, so there are no atomics and
// the result does not depend on the schedule.  The partition sorts rows by
// degree, so the groups of a warp and the warps of a block carry similar
// work.
//
// Numbers: float32 sum in edge order (by tile, then column).  bfloat16
// weights: the weight is widened, the embedding element is rounded to
// bfloat16 and widened (the TPU kernel's e_refs[j][:].astype(compute_dtype)),
// their product is exact in float32 and only the sum rounds.  A source node
// past N reads as zeros, as a ragged last window does.  Widths that are not
// a multiple of 4 are padded with zero columns by the wrapper
// (ops/block_spmm.py), so every row is whole float4s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 128;  // columns of one slab: 32 lanes x one float4
constexpr int kBatch = 8;  // gathers in flight per lane; divides every group size

template <typename TW>
__device__ __forceinline__ float weight_of(const TW* w, int e) {
  if constexpr (std::is_same<TW, __nv_bfloat16>::value)
    return __bfloat162float(w[e]);
  else
    return __ldg(w + e);
}

// one source row's float4 for this lane (emb already at the slab's first
// column, rows `ld` floats apart); zeros past N
template <bool kRound>
__device__ __forceinline__ float4 gather(const float* __restrict__ emb, int src,
                                         long long n, int ld, int lane) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (src < n) v = __ldg(reinterpret_cast<const float4*>(emb + (long long)src * ld) + lane);
  if constexpr (kRound) {  // two values a conversion, widened again by shifts
    const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
    const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(v.z, v.w));
    v = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return v;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = __fmaf_rn(w, v.x, acc.x);
  acc.y = __fmaf_rn(w, v.y, acc.y);
  acc.z = __fmaf_rn(w, v.z, acc.z);
  acc.w = __fmaf_rn(w, v.w, acc.w);
}

template <typename TW>
__global__ void __launch_bounds__(kThreads)
tile_gather_spmm_kernel(const int32_t* __restrict__ row_ptr,
                        const int32_t* __restrict__ edge_src,
                        const TW* __restrict__ edge_w,
                        const float* __restrict__ emb, float* __restrict__ out,
                        int n_rows, long long n, int d, int lanes_log2) {
  constexpr bool kBf16 = std::is_same<TW, __nv_bfloat16>::value;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int row = blockIdx.x * (kThreads >> lanes_log2) + (threadIdx.x >> lanes_log2);
  // this block's slab: columns col0 .. col0 + width of rows d floats apart
  const int col0 = blockIdx.y * kSlab;
  const int width = min(kSlab, d - col0);
  emb += col0;
  out += col0;
  const bool active = lane < (width >> 2);  // idle lanes still fetch and hand on edges
  // this group's lanes of the warp
  const unsigned group_mask =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));

  int e = 0, end = 0;
  if (row < n_rows) {
    e = __ldg(row_ptr + row);
    end = __ldg(row_ptr + row + 1);
  }
  int my_src = 0;
  float my_w = 0.0f;
  if (e + lane < end) {
    my_src = __ldg(edge_src + e + lane);
    my_w = weight_of(edge_w, e + lane);
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (; e < end; e += lanes) {
    const int cur_src = my_src;
    const float cur_w = my_w;
    if (e + lanes + lane < end) {  // the next round's edges, ahead of this round's gathers
      my_src = __ldg(edge_src + e + lanes + lane);
      my_w = weight_of(edge_w, e + lanes + lane);
    }
    const int count = min(lanes, end - e);
    for (int i0 = 0; i0 < count; i0 += kBatch) {
      float4 v[kBatch];
      float w[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int src = __shfl_sync(group_mask, cur_src, i0 + i, lanes);
        w[i] = __shfl_sync(group_mask, cur_w, i0 + i, lanes);
        v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (active && i0 + i < count) v[i] = gather<kBf16>(emb, src, n, d, lane);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (i0 + i < count) fma4(acc, w[i], v[i]);
    }
  }
  if (active && row < n_rows) reinterpret_cast<float4*>(out + (long long)row * d)[lane] = acc;
}

template <typename TW>
int launch(const void* row_ptr, const void* edge_src, const void* edge_w,
           const void* emb, void* out, int n_rows, long long n, int d,
           cudaStream_t stream) {
  // lanes per row: the power of two that holds a slab's float4s, at least 8
  const int lanes_log2 = d <= 32 ? 3 : d <= 64 ? 4 : 5;
  const int rows_per_block = kThreads >> lanes_log2;
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, (d + kSlab - 1) / kSlab);
  tile_gather_spmm_kernel<TW><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)row_ptr, (const int32_t*)edge_src, (const TW*)edge_w,
      (const float*)emb, (float*)out, n_rows, n, d, lanes_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or -1 for
// a width the kernel does not take (d must be a positive multiple of 4).
// row_ptr [n_rows + 1] int32, edge_src [E] int32, edge_w [E] (float32, or
// bfloat16 when w_is_bf16), emb [n, d] float32, out [n_rows, d] float32;
// all contiguous, emb and out 16-byte aligned.
extern "C" int tile_gather_spmm_launch(const void* row_ptr, const void* edge_src,
                                       const void* edge_w, int w_is_bf16,
                                       const void* emb, void* out, int n_rows,
                                       long long n, int d, void* stream) {
  if (d < 4 || d % 4 != 0 || (d + kSlab - 1) / kSlab > 65535) return -1;
  if (n_rows <= 0) return 0;
  if (w_is_bf16)
    return launch<__nv_bfloat16>(row_ptr, edge_src, edge_w, emb, out, n_rows, n, d,
                                 (cudaStream_t)stream);
  return launch<float>(row_ptr, edge_src, edge_w, emb, out, n_rows, n, d,
                       (cudaStream_t)stream);
}
