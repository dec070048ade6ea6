// Row-wise int8 quantization with stochastic rounding, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gcn_recommendation_tpu/ops/quant.py::
// _quant_kernel (launched by quantize_rows_int8_pallas).  Per row:
//   scale = max(absmax, 1e-12) * f32(1/127)
//   q     = clip(floor(x / scale + u), -127, 127)  as int8
// with u = (bits >> 8) * 2^-24 and bits = triple32((row*d + col) ^ triple32(seed))
// over uint32 (the counter-based generator of ops/quant.py, whose plain
// PyTorch version reproduces these bits and this arithmetic exactly).
//
// Bound: memory traffic.  The kernel reads 4*N*d bytes and writes
// N*d + 4*N; its arithmetic (a hash and a division per element) is far
// below what the SMs can issue in that time.  So the design is plain: one
// warp per row, lanes striding over the columns (coalesced 128-byte reads
// per warp), the row absmax reduced in registers with __shfl_xor_sync,
// and a second pass over the row (an L1 hit) that rounds and stores.
// Ragged row counts are masked; no padding to the TPU's 256-row blocks.
//
// Build without --use_fast_math: the IEEE division x / scale is what makes
// the result bit-equal to the plain version.  -fmad=false keeps the
// compiler from contracting any multiply-add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
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

__global__ void quantize_rows_int8_kernel(const float* __restrict__ x,
                                          int8_t* __restrict__ q,
                                          float* __restrict__ scales,
                                          long long n, int d,
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
  const uint32_t base = (uint32_t)row * (uint32_t)d;
  int8_t* qr = q + row * d;
  for (int c = lane; c < d; c += 32) {
    const uint32_t bits = triple32((base + (uint32_t)c) ^ seed_key);
    const float u = (float)(bits >> 8) * kU24Scale;
    float r = floorf(__fdiv_rn(xr[c], scale) + u);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    qr[c] = (int8_t)r;
  }
  if (lane == 0) scales[row] = scale;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int quantize_rows_int8_launch(const void* x, void* q, void* scales,
                                         long long n, int d, uint32_t seed,
                                         void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_rows_int8_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scales, n, d, triple32(seed));
  return (int)cudaGetLastError();
}
