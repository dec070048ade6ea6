// Block-sparse tile product for Hopper (sm_90a): for each compact row
// block r of the tile partition (graph/tiles.py),
//   out[128r : 128r+128] = sum over tiles t of r of  A_t @ emb[128*col_t : 128*col_t+128]
// with A_t a dense 128x128 tile (float32 or bfloat16) and the f32 sum.
//
// Replaces the Pallas TPU kernel gcn_recommendation_tpu/ops/block_spmm.py::
// _make_tile_call (inner `kernel`, :79).  There the grid runs in order on
// one core and carries the [128, d] accumulator from step to step,
// zeroing it when step_row changes.  Here one thread block owns one row
// block: it loops over that block's steps row_step_ptr[r] .. row_step_ptr[r+1]
// (TB tiles each), keeps the accumulator in registers and writes row
// block r exactly once.  No atomics, and the result does not depend on
// the schedule.
//
// Bound.  At the books-shaped bundle (T = 3,344 tiles, d = 64) the dense
// tile products are 2*T*128*128*d = 7.0 GFLOP, 0.105 ms of float32 FMA at
// the H100's 67 TFLOP/s, against 336 MB of tile values, windows and output
// (0.100 ms at 3.35 TB/s): the dense formulation is bound by operations.
// The tiles hold ~0.35% nonzeros, so nearly all of that work multiplies
// zeros; the data itself needs only the bytes.  This first version keeps
// the dense products (it computes what the TPU kernel computes) and does
// the simple things about the bound: coalesced 16-byte loads of each tile
// and window into shared memory, an 8x4 register micro-tile per thread
// (12 shared-memory loads per 128 FMAs), conflict-free shared reads (the
// staged tile's rows are padded to 132 floats).  It does not overlap loads
// with compute, does not use tensor cores, and does not split heavy row
// blocks (rows are sorted by degree, so the first blocks own the most
// tiles).  Those are a later redesign's work.
//
// Numbers: the sum runs in float32 with explicit __fmaf_rn (the build's
// -fmad=false stops only implicit contraction).  FMA rounds once per term
// where a multiply and an add round twice, and the order of the sum
// differs from the plain PyTorch version anyway; the two agree within
// 1e-5.  bfloat16 tiles: the window is rounded to bfloat16 as it is
// staged (the TPU kernel's e_refs[j][:].astype(compute_dtype)), and a
// product of two bfloat16 values is exact in float32, so only the f32
// sum rounds.  TF32 is not used.
//
// Ragged edge: when N is not a multiple of 128, window rows >= N read as
// zeros; the embedding is not padded.  Padding tiles (zero values,
// column block 0) add zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 128;
constexpr int kALd = kTile + 4;       // staged tile row stride, in floats
constexpr int kRowGroups = 16;        // thread rows of the micro-tile grid
constexpr int kRowsPerThread = kTile / kRowGroups;  // 8, rows tr + 16*m
constexpr int kMaxD = 128;            // 16 * (kMaxD / 4) = 512 threads

__device__ __forceinline__ float to_bf16_and_back(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename TA>
__global__ void __launch_bounds__(kRowGroups * kMaxD / 4)
tile_spmm_kernel(const TA* __restrict__ tile_a,
                 const int32_t* __restrict__ tile_col,
                 const int32_t* __restrict__ row_step_ptr,
                 const float* __restrict__ emb, float* __restrict__ out,
                 int tb, long long n, int d) {
  constexpr bool kBf16 = std::is_same<TA, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [128][kALd]
  float* e_s = a_s + kTile * kALd;               // [128][d]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cg = d >> 2;  // column groups of 4 columns
  const int tc = tid % cg;
  const int tr = tid / cg;  // 0 .. kRowGroups-1
  const int r = blockIdx.x;

  float acc[kRowsPerThread][4];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.0f;

  const long long t_begin = (long long)row_step_ptr[r] * tb;
  const long long t_end = (long long)row_step_ptr[r + 1] * tb;
  for (long long t = t_begin; t < t_end; ++t) {
    // stage tile t as float32, 16-byte loads
    if constexpr (kBf16) {
      const uint4* src = reinterpret_cast<const uint4*>(tile_a + t * kTile * kTile);
      for (int i = tid; i < kTile * kTile / 8; i += nthreads) {
        const int row = i >> 4, c8 = i & 15;
        const uint4 v = src[i];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float2 f0 = __bfloat1622float2(h[0]);
        const float2 f1 = __bfloat1622float2(h[1]);
        const float2 f2 = __bfloat1622float2(h[2]);
        const float2 f3 = __bfloat1622float2(h[3]);
        float4* dst = reinterpret_cast<float4*>(a_s + row * kALd + c8 * 8);
        dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
        dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    } else {
      const float4* src = reinterpret_cast<const float4*>(tile_a + t * kTile * kTile);
      for (int i = tid; i < kTile * kTile / 4; i += nthreads) {
        const int row = i >> 5, c4 = i & 31;
        *reinterpret_cast<float4*>(a_s + row * kALd + c4 * 4) = src[i];
      }
    }
    // stage the embedding window; rows past N read as zeros
    const long long base = (long long)tile_col[t] * kTile;
    for (int i = tid; i < kTile * cg; i += nthreads) {
      const int row = i / cg, c4 = i % cg;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (base + row < n)
        v = reinterpret_cast<const float4*>(emb + (base + row) * d)[c4];
      if constexpr (kBf16) {
        v.x = to_bf16_and_back(v.x);
        v.y = to_bf16_and_back(v.y);
        v.z = to_bf16_and_back(v.z);
        v.w = to_bf16_and_back(v.w);
      }
      *reinterpret_cast<float4*>(e_s + row * d + c4 * 4) = v;
    }
    __syncthreads();

    for (int k = 0; k < kTile; k += 4) {
      float4 a[kRowsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m)
        a[m] = *reinterpret_cast<const float4*>(a_s + (tr + kRowGroups * m) * kALd + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 e = *reinterpret_cast<const float4*>(e_s + (k + kk) * d + tc * 4);
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const float av = kk == 0 ? a[m].x : kk == 1 ? a[m].y : kk == 2 ? a[m].z : a[m].w;
          acc[m][0] = __fmaf_rn(av, e.x, acc[m][0]);
          acc[m][1] = __fmaf_rn(av, e.y, acc[m][1]);
          acc[m][2] = __fmaf_rn(av, e.z, acc[m][2]);
          acc[m][3] = __fmaf_rn(av, e.w, acc[m][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const long long row = (long long)r * kTile + tr + kRowGroups * m;
    *reinterpret_cast<float4*>(out + row * d + tc * 4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
}

template <typename TA>
int launch(const void* tile_a, const void* tile_col, const void* row_step_ptr,
           const void* emb, void* out, int n_row_blocks, int tb, long long n,
           int d, cudaStream_t stream) {
  const int threads = kRowGroups * (d / 4);
  const size_t smem = sizeof(float) * (size_t)kTile * (kALd + d);
  cudaError_t err = cudaFuncSetAttribute(
      tile_spmm_kernel<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_spmm_kernel<TA><<<n_row_blocks, threads, smem, stream>>>(
      (const TA*)tile_a, (const int32_t*)tile_col, (const int32_t*)row_step_ptr,
      (const float*)emb, (float*)out, tb, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or -1 for
// a width the kernel does not take (d must be a multiple of 4 in [4, 128]).
// tile_a [T, 128, 128] (float32, or bfloat16 when tile_is_bf16), tile_col
// [T] int32, row_step_ptr [R + 1] int32 (steps of TB tiles per row block),
// emb [n, d] float32, out [R * 128, d] float32; all contiguous and 16-byte
// aligned.
extern "C" int tile_spmm_launch(const void* tile_a, int tile_is_bf16,
                                const void* tile_col, const void* row_step_ptr,
                                const void* emb, void* out, int n_row_blocks,
                                int tb, long long n, int d, void* stream) {
  if (d < 4 || d > kMaxD || d % 4 != 0) return -1;
  if (n_row_blocks <= 0) return 0;
  if (tile_is_bf16)
    return launch<__nv_bfloat16>(tile_a, tile_col, row_step_ptr, emb, out,
                                 n_row_blocks, tb, n, d, (cudaStream_t)stream);
  return launch<float>(tile_a, tile_col, row_step_ptr, emb, out, n_row_blocks,
                       tb, n, d, (cudaStream_t)stream);
}
