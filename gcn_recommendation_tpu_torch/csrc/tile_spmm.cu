// Block-sparse tile product over dense tiles for Hopper (sm_90a): for each
// compact row block r of a tile layout (graph/tiles.py, tools/exp_block_tiles.py),
//   out[128r : 128r+128] = sum over tiles t of r of  A_t @ emb[128*col_t : 128*col_t+128]
// with A_t a dense 128x128 tile (float32 or bfloat16) and the f32 sum.
//
// Replaces the Pallas TPU kernels gcn_recommendation_tpu/ops/block_spmm.py::
// _make_tile_call (inner `kernel`, :79) and tools/exp_block_pallas.py:47 and
// :155 (one and eight tiles per grid step) for tiles that are mostly
// nonzero.  There the grid runs in order on one core, carries the [128, d]
// accumulator from step to step and lets the pipeline fetch the next
// step's tiles; nothing of that carries over to 132 SMs that run blocks in
// no order.  Almost empty tiles go to csrc/tile_gather_spmm.cu instead.
//
// Bound.  On the experiment's layout (T = 6,144 tiles, every value nonzero,
// d = 64): 2*T*128*128*d = 12.9 GFLOP.  float32 tiles: 0.192 ms of FMA at
// the H100's 67 TFLOP/s against 434 MB (0.130 ms at 3.35 TB/s), bound by
// operations, but the two are close, so neither may wait for the other.
// bfloat16 tiles: 232 MB, 0.069 ms, bound by bytes; the products are exact
// in float32 and take 0.013 ms at the tensor cores' 989 TFLOP/s.
//
// Design.
// * Overlap.  Each thread block runs a ring of two stages in dynamic shared
//   memory, filled with cp.async while the other stage is multiplied: one
//   __syncthreads per stage, a stage's loads always in flight.  A stage
//   holds 64 columns of a float32 tile and the matching 64 rows of its
//   embedding window (50 KB at d = 64), or a whole bfloat16 tile and its
//   window (52 KB); two blocks fit an SM either way.  Tile values are
//   loaded with an evict-first hint for the L2, the windows without, so the
//   embedding stays cached while the tiles stream through.  More or
//   smaller stages, or one block per SM, measured slower on the card.
// * Balance.  The blocks are persistent: the host cuts the list of tiles
//   that hold a value (ops/block_spmm.py::plan_tile_ranges) into equal
//   contiguous ranges, one per block, two blocks per SM, so no block waits
//   for a heavy row block, no wave is partly filled and all-zero padding
//   tiles are never read.  A range is split into segments where the row
//   block changes.  A segment that holds a whole row block is written
//   straight to the output; the others go to a scratch buffer of partial
//   [128, d] sums, and a second small kernel writes each remaining row
//   block as the sum of its partials in order (zeros when it has none).
//   No atomics; the cut is made in tiles, so the number of tiles per step
//   of the layout changes no bit of the result.
// * bfloat16 tiles on the tensor cores.  The embedding is rounded to
//   bfloat16 once, by a small kernel, into a table padded to whole windows
//   (the TPU kernel's e_refs[j][:].astype(compute_dtype); rows past N are
//   zeros), so tile and window go to shared memory as they are and meet in
//   mma.sync.m16n8k16 through ldmatrix.  Each warp owns 16 output rows.
//   The tensor cores do not round a long chain of sums as IEEE adds do, so
//   each tile (eight k-steps) is accumulated from zero and then added to
//   the running float32 sum with ordinary adds.
// * float32 tiles stay on the FMA units (TF32 would keep 10 mantissa
//   bits): an 8x4 register micro-tile per thread, 12 shared-memory loads
//   per 128 explicit __fmaf_rn (the build's -fmad=false stops only implicit
//   contraction), conflict-free shared reads (tile rows padded by 4 floats).
//
// * Width.  A thread block covers at most 128 columns (a slab); a wider
//   embedding runs the kernel once per slab of 128 columns, each launch
//   reading the slab's columns of rows `ld` floats apart and writing the
//   same columns of the output and the partial sums, so every tile is read
//   once per slab (d = 256: twice).  The second pass sums whole rows.
//
// Ragged edge: when N is not a multiple of 128, window rows >= N read as
// zeros (cp.async with a source size of 0); the embedding is not padded.
// Widths that are not a multiple of 4 are padded with zero columns by the
// wrapper (ops/block_spmm.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kSlab = 128;  // the most columns one launch covers

// float32 path: a stage holds kKCF32 columns of a tile
constexpr int kKCF32 = 64;
constexpr int kStagesF32 = 2;
constexpr int kRowGroups = 16;                 // thread rows of the micro-tile grid
constexpr int kRowsPerThread = kTile / kRowGroups;  // 8, rows tr + 16*m

// bfloat16 path: a stage holds kKCBf16 columns of a tile
constexpr int kKCBf16 = 128;
constexpr int kMmaThreads = 256;               // 8 warps x 16 rows

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// tile values are read once: ask the L2 to drop them first, so that the
// embedding windows, which every block reads again, stay
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async16_stream(void* smem, const void* gmem,
                                                  unsigned long long policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "l"(policy) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// the tiles of one thread block: its segments and its range of the tile list
struct BlockRange {
  int seg, seg_end, list_begin, n_chunks;
};

__device__ __forceinline__ BlockRange block_range(const int4* __restrict__ segments,
                                                  const int32_t* __restrict__ block_seg_ptr,
                                                  int chunks_per_tile) {
  BlockRange r;
  r.seg = block_seg_ptr[blockIdx.x];
  r.seg_end = block_seg_ptr[blockIdx.x + 1];
  r.list_begin = r.n_chunks = 0;
  if (r.seg < r.seg_end) {
    r.list_begin = segments[r.seg].x;
    r.n_chunks = (segments[r.seg_end - 1].y - r.list_begin) * chunks_per_tile;
  }
  return r;
}

// where a finished segment goes: its row block of the output (slot < 0) or
// its slot of the partial sums; rows `ld` floats apart
__device__ __forceinline__ float* segment_dest(const int4& sg, float* partials, float* out,
                                               int ld) {
  return sg.w < 0 ? out + (long long)sg.z * kTile * ld : partials + (long long)sg.w * kTile * ld;
}

// ------------------------------------------------------------------ float32

// one slab: emb, partials and out start at the slab's first column, d is
// the slab's width (<= kSlab), ld the row stride of all three
template <int kKC, int kStages>
__global__ void __launch_bounds__(kRowGroups * kSlab / 4)
tile_spmm_f32_kernel(const float* __restrict__ tile_a,
                     const int32_t* __restrict__ list_tile,
                     const int32_t* __restrict__ list_col,
                     const int4* __restrict__ segments,
                     const int32_t* __restrict__ block_seg_ptr,
                     const float* __restrict__ emb, float* __restrict__ partials,
                     float* __restrict__ out, long long n, int d, int ld) {
  static_assert(kKC == 32 || kKC == 64, "a tile row of a stage is 8 or 16 float4s");
  constexpr int kChunksPerTile = kTile / kKC;
  constexpr int kALd = kKC + 4;  // staged tile row stride, floats: conflict-free reads
  constexpr int kAFloats = kTile * kALd;
  constexpr int kAQuads = kKC / 4;  // float4s of a staged tile row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage_floats = kAFloats + kKC * d;

  const int tid = threadIdx.x;
  const int cg = d >> 2;    // column groups of 4 columns; the block has 16 * cg threads
  const int tc = tid % cg;
  const int tr = tid / cg;  // 0 .. kRowGroups-1

  const BlockRange br = block_range(segments, block_seg_ptr, kChunksPerTile);
  if (br.n_chunks == 0) return;
  const unsigned long long policy = evict_first_policy();

  // this thread's share of a stage: tile rows a_row, a_row + a_step, ... at
  // float4 a_quad, and window rows tr, tr + 16, ... at float4 tc
  const int a_row = tid / kAQuads, a_quad = tid % kAQuads;
  const int a_step = blockDim.x / kAQuads;

  // fill stage q % kStages with chunk q: kKC columns of a tile, kKC window rows
  auto fetch = [&](int q) {
    const int idx = br.list_begin + q / kChunksPerTile;
    const int k0 = (q % kChunksPerTile) * kKC;
    float* a_s = smem + (q % kStages) * stage_floats;
    float* e_s = a_s + kAFloats + tc * 4;
    const float* a_g = tile_a + (long long)list_tile[idx] * kTile * kTile + k0 + a_quad * 4;
    a_s += a_quad * 4;
    for (int row = a_row; row < kTile; row += a_step)
      cp_async16_stream(a_s + row * kALd, a_g + row * kTile, policy);
    const long long base = (long long)list_col[idx] * kTile + k0;
    const float* e_g = emb + base * ld + tc * 4;
#pragma unroll
    for (int row = tr; row < kKC; row += kRowGroups) {
      const bool inside = base + row < n;  // rows past N: zero fill, nothing read
      cp_async16(e_s + row * d, inside ? e_g + (long long)row * ld : emb, inside ? 16 : 0);
    }
  };

  float acc[kRowsPerThread][4];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < br.n_chunks) fetch(s);
    cp_async_commit();
  }
  int seg = br.seg;
  int4 sg = segments[seg];
  for (int q = 0; q < br.n_chunks; ++q) {
    cp_async_wait<kStages - 2>();  // chunk q has landed (this thread's part)
    __syncthreads();               // everyone's part; stage (q-1) % kStages is free
    if (q + kStages - 1 < br.n_chunks) fetch(q + kStages - 1);
    cp_async_commit();

    const float* a_s = smem + (q % kStages) * stage_floats;
    const float* e_s = a_s + kAFloats;
#pragma unroll 4
    for (int k = 0; k < kKC; k += 4) {
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

    // the segment's last chunk: write its sum and start the next segment
    if (q % kChunksPerTile == kChunksPerTile - 1 &&
        br.list_begin + q / kChunksPerTile + 1 == sg.y) {
      float* dest = segment_dest(sg, partials, out, ld);
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        *reinterpret_cast<float4*>(dest + (tr + kRowGroups * m) * ld + tc * 4) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.0f;
      }
      if (++seg < br.seg_end) sg = segments[seg];
    }
  }
}

// ----------------------------------------------------------------- bfloat16

// emb [n, d] float32 -> win [rows_pad, dpad] bfloat16, zeros outside [n, d]
__global__ void round_window_kernel(const float* __restrict__ emb,
                                    __nv_bfloat16* __restrict__ win, long long n,
                                    long long rows_pad, int d, int dpad) {
  const int q4 = dpad >> 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows_pad * q4) return;
  const long long row = i / q4;
  const int c = (int)(i % q4) * 4;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < n && c < d) v = *reinterpret_cast<const float4*>(emb + row * d + c);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(win + row * dpad + c) = packed;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c += a (16x16, row major) x b (16x8, column major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kNT16: 16-column groups of the output held in registers (dpad <= 16 * kNT16).
// One slab: win, partials and out start at the slab's first column; d / dpad
// are the slab's width and padded width (<= kSlab), ld / win_ld the row
// strides of the output and partials / of the window
template <int kKC, int kNT16, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks)
tile_spmm_bf16_kernel(const __nv_bfloat16* __restrict__ tile_a,
                      const int32_t* __restrict__ list_tile,
                      const int32_t* __restrict__ list_col,
                      const int4* __restrict__ segments,
                      const int32_t* __restrict__ block_seg_ptr,
                      const __nv_bfloat16* __restrict__ win, float* __restrict__ partials,
                      float* __restrict__ out, int d, int dpad, int ld, int win_ld) {
  static_assert(kKC == 32 || kKC == 64 || kKC == 128, "kKC / 8 pieces of 16 bytes a tile row");
  constexpr int kChunksPerTile = kTile / kKC;
  constexpr int kBLd = kKC + 8;  // staged tile row stride, bf16: an odd multiple of 16 bytes
  constexpr int kAElems = kTile * kBLd;
  constexpr int kAPieces = kKC / 8;  // 16-byte pieces of a staged tile row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int lde = dpad + 8;  // staged window row stride: an odd multiple of 16 bytes
  const int stage_elems = kAElems + kKC * lde;
  const int nt16 = dpad >> 4;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const BlockRange br = block_range(segments, block_seg_ptr, kChunksPerTile);
  if (br.n_chunks == 0) return;
  const unsigned long long policy = evict_first_policy();

  // this thread's share of a stage: tile rows a_row, a_row + 256 / kAPieces,
  // ... at piece a_piece, and window rows e_row, e_row + 16, ... at piece
  // e_piece when the window row has that many
  const int a_row = tid / kAPieces, a_piece = tid % kAPieces;
  const int e_row = tid >> 4, e_piece = tid & 15;
  const bool e_lane = e_piece < (dpad >> 3);

  auto fetch = [&](int q) {
    const int idx = br.list_begin + q / kChunksPerTile;
    const int k0 = (q % kChunksPerTile) * kKC;
    __nv_bfloat16* a_s = smem + (q % kStages) * stage_elems;
    __nv_bfloat16* e_s = a_s + kAElems + e_piece * 8;
    const __nv_bfloat16* a_g =
        tile_a + (long long)list_tile[idx] * kTile * kTile + k0 + a_piece * 8;
    a_s += a_piece * 8;
#pragma unroll
    for (int row = a_row; row < kTile; row += kMmaThreads / kAPieces)
      cp_async16_stream(a_s + row * kBLd, a_g + row * kTile, policy);
    const __nv_bfloat16* e_g =
        win + ((long long)list_col[idx] * kTile + k0) * win_ld + e_piece * 8;
    if (e_lane) {
#pragma unroll
      for (int row = e_row; row < kKC; row += kMmaThreads / 16)
        cp_async16(e_s + row * lde, e_g + (long long)row * win_ld, 16);
    }
  };

  float run[2 * kNT16][4];  // the segment's running sum: 16 rows x 8 columns a warp each
#pragma unroll
  for (int j = 0; j < 2 * kNT16; ++j) run[j][0] = run[j][1] = run[j][2] = run[j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < br.n_chunks) fetch(s);
    cp_async_commit();
  }
  int seg = br.seg;
  int4 sg = segments[seg];
  for (int q = 0; q < br.n_chunks; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (q + kStages - 1 < br.n_chunks) fetch(q + kStages - 1);
    cp_async_commit();

    const __nv_bfloat16* a_s = smem + (q % kStages) * stage_elems;
    const __nv_bfloat16* e_s = a_s + kAElems;
    float c[2 * kNT16][4];  // this chunk alone, from zero
#pragma unroll
    for (int j = 0; j < 2 * kNT16; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, a_s + (warp * 16 + (lane & 15)) * kBLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNT16; ++j) {
        if (j < nt16) {
          unsigned b[4];
          ldmatrix_x4_trans(b, e_s + (kk * 16 + (lane & 15)) * lde + j * 16 + (lane >> 4) * 8);
          mma_bf16(c[2 * j], a, b[0], b[1]);
          mma_bf16(c[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * kNT16; ++j) {
      run[j][0] = __fadd_rn(run[j][0], c[j][0]);
      run[j][1] = __fadd_rn(run[j][1], c[j][1]);
      run[j][2] = __fadd_rn(run[j][2], c[j][2]);
      run[j][3] = __fadd_rn(run[j][3], c[j][3]);
    }

    if (q % kChunksPerTile == kChunksPerTile - 1 &&
        br.list_begin + q / kChunksPerTile + 1 == sg.y) {
      float* dest = segment_dest(sg, partials, out, ld);
      const int row = warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 2 * kNT16; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (col < d) {
          *reinterpret_cast<float2*>(dest + row * ld + col) = make_float2(run[j][0], run[j][1]);
          *reinterpret_cast<float2*>(dest + (row + 8) * ld + col) =
              make_float2(run[j][2], run[j][3]);
        }
        run[j][0] = run[j][1] = run[j][2] = run[j][3] = 0.0f;
      }
      if (++seg < br.seg_end) sg = segments[seg];
    }
  }
}

// -------------------------------------------------------------- second pass

// out[row block] = sum of its partial slots, in order (none: zeros)
__global__ void tile_reduce_kernel(const int32_t* __restrict__ reduce_rows,
                                   const int32_t* __restrict__ reduce_ptr,
                                   const float* __restrict__ partials,
                                   float* __restrict__ out, int d) {
  const int per_block = kTile * d / 4;
  const long long r = reduce_rows[blockIdx.x];
  const int p0 = reduce_ptr[blockIdx.x], p1 = reduce_ptr[blockIdx.x + 1];
  const float4* src = reinterpret_cast<const float4*>(partials);
  float4* dst = reinterpret_cast<float4*>(out) + r * per_block;
  for (int i = threadIdx.x; i < per_block; i += blockDim.x) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int p = p0; p < p1; ++p) {
      const float4 v = src[(long long)p * per_block + i];
      s.x = __fadd_rn(s.x, v.x);
      s.y = __fadd_rn(s.y, v.y);
      s.z = __fadd_rn(s.z, v.z);
      s.w = __fadd_rn(s.w, v.w);
    }
    dst[i] = s;
  }
}

// ------------------------------------------------------------------ launch

struct Plan {
  const int32_t* list_tile;
  const int32_t* list_col;
  const int4* segments;
  const int32_t* block_seg_ptr;
  int n_blocks;
};

// one launch per slab of kSlab columns
int launch_f32(const void* tile_a, const Plan& p, const float* emb, float* partials,
               float* out, long long n, int d, cudaStream_t stream) {
  for (int c0 = 0; c0 < d; c0 += kSlab) {
    const int w = d - c0 < kSlab ? d - c0 : kSlab;
    const int threads = kRowGroups * (w / 4);
    const size_t smem =
        sizeof(float) * kStagesF32 * ((size_t)kTile * (kKCF32 + 4) + (size_t)kKCF32 * w);
    cudaError_t err = cudaFuncSetAttribute(tile_spmm_f32_kernel<kKCF32, kStagesF32>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    tile_spmm_f32_kernel<kKCF32, kStagesF32><<<p.n_blocks, threads, smem, stream>>>(
        (const float*)tile_a, p.list_tile, p.list_col, p.segments, p.block_seg_ptr, emb + c0,
        partials ? partials + c0 : nullptr, out + c0, n, w, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// one slab: d / dpad its width and padded width, ld / win_ld the row strides
template <int kKC, int kNT16, int kStages, int kMinBlocks>
int launch_bf16(const void* tile_a, const Plan& p, const __nv_bfloat16* win, float* partials,
                float* out, int d, int dpad, int ld, int win_ld, cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * kStages * ((size_t)kTile * (kKC + 8) + (size_t)kKC * (dpad + 8));
  auto kernel = tile_spmm_bf16_kernel<kKC, kNT16, kStages, kMinBlocks>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_blocks, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)tile_a, p.list_tile, p.list_col, p.segments, p.block_seg_ptr, win,
      partials, out, d, dpad, ld, win_ld);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or -1 for
// a width the kernel does not take (d must be a positive multiple of 4).
// tile_a [T, 128, 128] (float32, or bfloat16 when tile_is_bf16); the plan of
// ops/block_spmm.py::plan_tile_ranges: list_tile / list_col [Ta] int32,
// segments [S, 4] int32, block_seg_ptr [n_blocks + 1] int32, reduce_rows
// [n_reduce] and reduce_ptr [n_reduce + 1] int32; emb [n, d] float32; window
// [ceil(n / 128) * 128, ceil(d / 16) * 16] bfloat16 scratch (bfloat16 tiles
// only); partials [slots, 128, d] float32 scratch; out [R * 128, d] float32.
// All contiguous and 16-byte aligned.
extern "C" int tile_spmm_launch(const void* tile_a, int tile_is_bf16, const void* list_tile,
                                const void* list_col, const void* segments,
                                const void* block_seg_ptr, int n_blocks,
                                const void* reduce_rows, const void* reduce_ptr, int n_reduce,
                                const void* emb, void* window, void* partials, void* out,
                                long long n, int d, void* stream_ptr) {
  if (d < 4 || d % 4 != 0) return -1;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Plan p = {(const int32_t*)list_tile, (const int32_t*)list_col, (const int4*)segments,
                  (const int32_t*)block_seg_ptr, n_blocks};
  int err = 0;
  if (n_blocks > 0 && !tile_is_bf16) {
    err = launch_f32(tile_a, p, (const float*)emb, (float*)partials, (float*)out, n, d, stream);
  } else if (n_blocks > 0) {
    const int dpad = (d + 15) / 16 * 16;
    const long long rows_pad = (n + kTile - 1) / kTile * kTile;
    const long long quads = rows_pad * (dpad / 4);
    round_window_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
        (const float*)emb, (__nv_bfloat16*)window, n, rows_pad, d, dpad);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    // one launch per slab of kSlab columns of the window
    for (int c0 = 0; c0 < d && err == 0; c0 += kSlab) {
      const int w = d - c0 < kSlab ? d - c0 : kSlab;
      const int wpad = dpad - c0 < kSlab ? dpad - c0 : kSlab;
      const __nv_bfloat16* win = (const __nv_bfloat16*)window + c0;
      float* part = partials ? (float*)partials + c0 : nullptr;
      float* o = (float*)out + c0;
      if (wpad <= 64)
        err = launch_bf16<kKCBf16, 4, 2, 2>(tile_a, p, win, part, o, w, wpad, d, dpad, stream);
      else
        err = launch_bf16<kKCBf16, 8, 2, 1>(tile_a, p, win, part, o, w, wpad, d, dpad, stream);
    }
  }
  if (err != 0) return err;
  if (n_reduce > 0) {
    tile_reduce_kernel<<<n_reduce, 256, 0, stream>>>(
        (const int32_t*)reduce_rows, (const int32_t*)reduce_ptr, (const float*)partials,
        (float*)out, d);
    err = (int)cudaGetLastError();
  }
  return err;
}
