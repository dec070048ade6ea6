// Row-wise int8 quantization for Hopper (sm_90a), two rounding modes.
//
// Replaces the Pallas TPU kernel gcn_recommendation_tpu/ops/quant.py::
// _quant_kernel (launched by quantize_rows_int8_pallas).  Per row:
//   scale = max(absmax, 1e-12) * f32(1/127)
//   stochastic: q = clip(floor(x / scale + u), -127, 127)  as int8
//   nearest:    q = clip(rint(x / scale), -127, 127)       as int8
// with u = (bits >> 8) * 2^-24 and bits = triple32((row*d + col) ^ triple32(seed))
// over uint32, where row is the global row: the local row plus row_offset (a
// shard of a catalog passes its first row, so its codes equal the whole
// catalog's rows) (the counter-based generator of ops/quant.py, whose plain
// PyTorch version reproduces these bits and this arithmetic exactly).
// The stochastic mode quantizes the item catalog at every load; the
// nearest mode is the user-side quantizer of quantized_topk_scores, one
// launch per int8 request.
//
// Bound: memory traffic.  The kernel reads 4*N*d bytes and writes
// N*d + 4*N.  A hash and an IEEE division per element (some 40
// instructions) are not free beside that: at [2000000, 64] they add about
// a seventh to the time of the loads and stores alone
// (tools/exp_quant_call.py times the kernel without them).  So:
//   * a group of min(32, next_pow2(d/4)) lanes owns a row (16 lanes at
//     d = 64, two rows a warp); each lane loads float4s (16 bytes) that stay
//     in registers, so the row is read once;
//   * the absmax is reduced with __shfl_xor_sync inside the group;
//   * each lane rounds its four values (four independent hash chains) and
//     stores the four codes as one 32-bit word: a warp writes 128
//     contiguous bytes at d = 64;
//   * a group loads kRowsInFlight rows before it uses the first, so the
//     next row's loads are out while this row divides and hashes (two
//     measured best: one is 9% slower at [2000000, 64], four and eight cost
//     registers and are 15-50% slower at the catalog's 20,000 rows);
//   * the grid is at most the SM count times the blocks that are resident
//     at once, each group striding over the rows.
// A width that is no multiple of 4, a base that is not 16-byte aligned, or
// a row wider than 512 takes the warp-per-row kernel below, the first
// version of this port (4-byte loads, 1-byte stores, the row read twice).
// That kernel is also kept as the entry point quantize_rows_int8_launch_v1,
// for comparison; nothing on a path calls it.
//
// The output rows may be strided (q_stride >= d bytes): the serving code
// writes user codes straight into a buffer padded for the int8 product.
//
// Build without --use_fast_math: the IEEE division x / scale is what makes
// the result bit-equal to the plain version.  -fmad=false, and the explicit
// __fmul_rn / __fadd_rn below, keep any multiply-add from being contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStochastic = 0;
constexpr int kNearest = 1;
constexpr int kBlockThreads = 256;
constexpr int kRowsInFlight = 2;
constexpr int kWarpsPerBlock = 8;        // warp-per-row kernel
constexpr int kMaxVectorWidth = 512;     // 32 lanes x 4 float4 x 4 floats
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kU24Scale = 1.0f / 16777216.0f;

// triple32 (Chris Wellons, hash-prospector): a bijective uint32 hash.
__host__ __device__ __forceinline__ uint32_t triple32(uint32_t x) {
  x ^= x >> 17;
  x *= 0xed5ad4bbu;
  x ^= x >> 11;
  x *= 0xac4c1b51u;
  x ^= x >> 15;
  x *= 0x31848babu;
  x ^= x >> 14;
  return x;
}

// One element's code in [-127, 127]; `counter` is row * d + col.
template <int MODE>
__device__ __forceinline__ int quantize_one(float x, float scale,
                                            uint32_t counter,
                                            uint32_t seed_key) {
  const float t = __fdiv_rn(x, scale);
  float r;
  if (MODE == kStochastic) {
    const uint32_t bits = triple32(counter ^ seed_key);
    r = floorf(__fadd_rn(t, __fmul_rn((float)(bits >> 8), kU24Scale)));
  } else {
    r = rintf(t);  // half to even, as torch.round
  }
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// GROUP lanes a row, VPL float4s a lane, ROWS rows loaded before the first
// is used.  x is [n, d4] float4, q is [n, q_stride_words] 32-bit words.
template <int MODE, int GROUP, int VPL, int ROWS>
__global__ void __launch_bounds__(kBlockThreads)
quantize_rows_vec_kernel(const float4* __restrict__ x,
                         uint32_t* __restrict__ q, float* __restrict__ scales,
                         long long n, int d4, long long q_stride_words,
                         long long row_offset, uint32_t seed_key) {
  const int lane = threadIdx.x & (GROUP - 1);
  const long long group =
      ((long long)blockIdx.x * kBlockThreads + threadIdx.x) / GROUP;
  const long long groups = (long long)gridDim.x * (kBlockThreads / GROUP);
  const uint32_t d = 4u * (uint32_t)d4;

  // the trip count is the same for every thread of the grid, so every
  // lane of a warp reaches the shuffles
  for (long long base = 0; base < n; base += groups * ROWS) {
    float4 v[ROWS][VPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = base + (long long)r * groups + group;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int j = lane + k * GROUP;
        v[r][k] = (row < n && j < d4) ? x[row * d4 + j]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = base + (long long)r * groups + group;
      float absmax = 0.0f;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        absmax = fmaxf(absmax, fmaxf(fmaxf(fabsf(v[r][k].x), fabsf(v[r][k].y)),
                                     fmaxf(fabsf(v[r][k].z), fabsf(v[r][k].w))));
      }
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1)
        absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
      if (row >= n) continue;
      const float scale = fmaxf(absmax, 1e-12f) * kInv127;
      const uint32_t row_counter = (uint32_t)(row + row_offset) * d;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int j = lane + k * GROUP;
        if (j >= d4) continue;
        const uint32_t c = row_counter + 4u * (uint32_t)j;
        const int q0 = quantize_one<MODE>(v[r][k].x, scale, c, seed_key);
        const int q1 = quantize_one<MODE>(v[r][k].y, scale, c + 1u, seed_key);
        const int q2 = quantize_one<MODE>(v[r][k].z, scale, c + 2u, seed_key);
        const int q3 = quantize_one<MODE>(v[r][k].w, scale, c + 3u, seed_key);
        // little endian: byte 0 of the word is column 4j
        const uint32_t word =
            ((uint32_t)q0 & 0xffu) | (((uint32_t)q1 & 0xffu) << 8) |
            (((uint32_t)q2 & 0xffu) << 16) | (((uint32_t)q3 & 0xffu) << 24);
        q[row * q_stride_words + j] = word;
      }
      if (lane == 0) scales[row] = scale;
    }
  }
}

// One warp a row, lanes striding over the columns: any width, any
// alignment.  The row is read twice (the second time from L1).
template <int MODE>
__global__ void quantize_rows_warp_kernel(const float* __restrict__ x,
                                          int8_t* __restrict__ q,
                                          float* __restrict__ scales,
                                          long long n, int d,
                                          long long q_stride,
                                          long long row_offset,
                                          uint32_t seed_key) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together
  const float* xr = x + row * d;

  float absmax = 0.0f;
  for (int c = lane; c < d; c += 32) absmax = fmaxf(absmax, fabsf(xr[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));

  const float scale = fmaxf(absmax, 1e-12f) * kInv127;
  const uint32_t base = (uint32_t)(row + row_offset) * (uint32_t)d;
  int8_t* qr = q + row * q_stride;
  for (int c = lane; c < d; c += 32)
    qr[c] = (int8_t)quantize_one<MODE>(xr[c], scale, base + (uint32_t)c, seed_key);
  if (lane == 0) scales[row] = scale;
}

__global__ void empty_kernel() {}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 1;
  }
  return cached[dev];
}

struct Args {
  const void* x;
  void* q;
  float* scales;
  long long n;
  int d;
  long long q_stride;
  long long row_offset;
  uint32_t seed_key;
  cudaStream_t stream;
};

template <int MODE>
void launch_warp(const Args& a) {
  const long long blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_rows_warp_kernel<MODE>
      <<<(unsigned int)blocks, kWarpsPerBlock * 32, 0, a.stream>>>(
          (const float*)a.x, (int8_t*)a.q, a.scales, a.n, a.d, a.q_stride,
          a.row_offset, a.seed_key);
}

template <int MODE, int GROUP, int VPL, int ROWS>
void launch_vec(const Args& a) {
  // the grid: every block resident at once (what the kernel's registers
  // allow on an SM, asked once), each group striding over the rows
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, quantize_rows_vec_kernel<MODE, GROUP, VPL, ROWS>, kBlockThreads, 0);
    blocks_per_sm = b > 0 ? b : 1;
  }
  const long long rows_per_block = (long long)(kBlockThreads / GROUP) * ROWS;
  long long blocks = (a.n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)sm_count() * blocks_per_sm;
  if (blocks > cap) blocks = cap;
  quantize_rows_vec_kernel<MODE, GROUP, VPL, ROWS>
      <<<(unsigned int)blocks, kBlockThreads, 0, a.stream>>>(
          (const float4*)a.x, (uint32_t*)a.q, a.scales, a.n, a.d / 4,
          a.q_stride / 4, a.row_offset, a.seed_key);
}

// One float4 a lane.  Several rows in flight only when every SM still
// gets a block: a short request spreads over the SMs instead.
template <int MODE, int GROUP>
void launch_group(const Args& a) {
  const long long fill =
      (long long)kRowsInFlight * (kBlockThreads / GROUP) * sm_count();
  if (a.n >= fill)
    launch_vec<MODE, GROUP, 1, kRowsInFlight>(a);
  else
    launch_vec<MODE, GROUP, 1, 1>(a);
}

template <int MODE>
void launch_mode(const Args& a) {
  const bool vector_ok =
      a.d % 4 == 0 && a.d <= kMaxVectorWidth && a.q_stride % 4 == 0 &&
      ((uintptr_t)a.x & 15u) == 0 && ((uintptr_t)a.q & 3u) == 0;
  if (!vector_ok) return launch_warp<MODE>(a);
  const int d4 = a.d / 4;
  if (d4 <= 1) return launch_group<MODE, 1>(a);
  if (d4 <= 2) return launch_group<MODE, 2>(a);
  if (d4 <= 4) return launch_group<MODE, 4>(a);
  if (d4 <= 8) return launch_group<MODE, 8>(a);
  if (d4 <= 16) return launch_group<MODE, 16>(a);
  if (d4 <= 32) return launch_group<MODE, 32>(a);
  if (d4 <= 64) return launch_vec<MODE, 32, 2, 2>(a);
  return launch_vec<MODE, 32, 4, 1>(a);
}

}  // namespace

// Quantize x [n, d] float32 (contiguous) into q (int8, rows q_stride bytes
// apart) and scales [n] on `stream`.  mode: 0 stochastic (seed used), 1
// round to nearest.  row_offset (>= 0) is added to every row in the random
// counter, so a shard that starts at global row row_offset draws the bits
// that the whole table draws there.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a mode or stride it does not know.
extern "C" int quantize_rows_int8_launch(const void* x, void* q, void* scales,
                                         long long n, int d,
                                         long long q_stride, int mode,
                                         uint32_t seed, long long row_offset,
                                         void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (q_stride < d || row_offset < 0 || (mode != kStochastic && mode != kNearest))
    return (int)cudaErrorInvalidValue;
  const Args a{x, q, (float*)scales, n, d, q_stride, row_offset, triple32(seed),
               (cudaStream_t)stream};
  if (mode == kStochastic)
    launch_mode<kStochastic>(a);
  else
    launch_mode<kNearest>(a);
  return (int)cudaGetLastError();
}

// The first version of this port's kernel (stochastic, one warp a row,
// dense output rows), kept for comparison.
extern "C" int quantize_rows_int8_launch_v1(const void* x, void* q,
                                            void* scales, long long n, int d,
                                            uint32_t seed, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  launch_warp<kStochastic>(Args{x, q, (float*)scales, n, d, (long long)d, 0,
                                triple32(seed), (cudaStream_t)stream});
  return (int)cudaGetLastError();
}

// A kernel that does nothing, to measure the launch floor of a grid.
extern "C" int quant_int8_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
