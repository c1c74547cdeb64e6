// Monte-Carlo block-sampled matmul, in two variants.
//
// Fixed (one sample list for all rows, one tier):
//   out = sum_k inv_rp[k] * x[:, s_k*B:(s_k+1)*B] @ w[s_k*B:(s_k+1)*B, :]
// Ragged (row tile t of bm = m / m_tiles rows has its own list and count):
//   out[t] = sum_{k < r_tile[t]} inv_rp[t,k] * x[t, s_tk block] @ w[s_tk block]
//
// Replaces: src/repro/kernels/mca_matmul.py::mca_matmul_fixed and
// ::mca_matmul_ragged (Pallas TPU kernels; scalar-prefetched sample ids
// drive the x/w BlockSpec index maps so only sampled blocks leave HBM, f32
// accumulator tile in VMEM; the ragged kernel skips the MXU work of samples
// k >= r_tile[t] with pl.when).
//
// What bounds it on an H100: bytes.  At the serve path's largest fixed
// shape (o_proj, m=128 rows, d=f=3072, B=128, R=4) it must read R*B*f*2 =
// 3.1 MB of sampled weight rows plus 0.9 MB of x and output for 0.4 GFLOP:
// about 100 FLOP per byte, a third of the ~295 FLOP/byte where bf16 tensor
// cores become the limit.  The floor is about 1.2 us at 3.35 TB/s.  The
// ragged kernel reads each row tile's own sampled w blocks, so its bytes
// grow with sum(r_tile) and it stays bound by bytes.
//
// What the design does about it:
//   * The grid covers output tiles (64 rows x 64 cols); each block loops
//     over its samples, reading idx[k] and inv_rp[k] from device memory
//     (no host sync), and stages only the sampled x column-block and w
//     row-block in shared memory, 32 columns of the block at a time, with
//     16-byte vector loads.  Each sampled w block is read once per m-tile.
//   * Ragged: the grid's row axis walks (row tile t, 64-row chunk within
//     it), so a CUDA block never spans two row tiles (their sample lists
//     differ); bm may be 32, 64, 128 or any size.  Each block reads
//     r_tile[t] and runs its sample loop only that far: a skipped sample
//     loads nothing and multiplies nothing (the pl.when of the TPU kernel).
//     r_tile[t] == 0 gives zero rows.
//   * bf16 multiplies on the tensor cores through WMMA (16x16x16, f32
//     accumulate); f32 inputs take a plain FMA path.  Each sample's partial
//     product is scaled by inv_rp[k] and added to an f32 register
//     accumulator, as the Pallas kernel does (acc += inv_rp[k] * x_k@w_k);
//     the output is written once, in the input dtype.
//   * Ragged row/column edges (tier capacities of 24 or 48 rows occur) are
//     masked: out-of-range rows and columns load zeros and are not stored.
// Not yet done (later work): cp.async/TMA double buffering, wgmma, and a
// larger m-tile so that small-m calls read each w block only once.
//
// Sample ids outside [0, d/B) are skipped.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output cols per block
constexpr int KC = 32;        // block columns staged per step (bf16)
constexpr int XS_LD = KC + 8; // padded smem leading dims (multiples of 8)
constexpr int WS_LD = BN + 8;
constexpr int OS_LD = BN + 4;

// One 64x64 output tile: rows [row0, row_end), cols [n0, n0 + BN), summed
// over the r samples (idx[k], inv_rp[k]).  128 threads.
__device__ __forceinline__ void mca_tile_bf16(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ idx, const float* __restrict__ inv_rp,
    __nv_bfloat16* __restrict__ out, int r, int row0, int row_end, int n0,
    int d, int f, int block, __nv_bfloat16* xs, __nv_bfloat16* ws,
    float* os) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;  // 2x2 warps, 32x32 each
  const int nblocks = d / block;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], part[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k = 0; k < r; ++k) {
    const int s = idx[k];                    // same value in every thread
    if (s < 0 || s >= nblocks) continue;
    const float sc = inv_rp[k];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.0f);

    for (int kc = 0; kc < block; kc += KC) {
      const long long col0 = (long long)s * block + kc;
      // x tile [BM, KC]: 8 bf16 per 16-byte vector
      for (int v = tid; v < BM * (KC / 8); v += blockDim.x) {
        const int row = v / (KC / 8), c8 = (v % (KC / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + row < row_end)
          val = *reinterpret_cast<const uint4*>(
              x + (long long)(row0 + row) * d + col0 + c8);
        *reinterpret_cast<uint4*>(xs + row * XS_LD + c8) = val;
      }
      // w tile [KC, BN]
      for (int v = tid; v < KC * (BN / 8); v += blockDim.x) {
        const int row = v / (BN / 8), c8 = (v % (BN / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + c8 < f)
          val = *reinterpret_cast<const uint4*>(
              w + (col0 + row) * (long long)f + n0 + c8);
        *reinterpret_cast<uint4*>(ws + row * WS_LD + c8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], xs + (wr * 32 + i * 16) * XS_LD + kk,
                                 XS_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], ws + kk * WS_LD + wc * 32 + j * 16,
                                 WS_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(part[i][j], a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < part[i][j].num_elements; ++t)
          acc[i][j].x[t] += sc * part[i][j].x[t];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(os + (wr * 32 + i * 16) * OS_LD + wc * 32 + j * 16,
                              acc[i][j], OS_LD, wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < BM * BN; v += blockDim.x) {
    const int row = v / BN, col = v % BN;
    if (row0 + row < row_end && n0 + col < f)
      out[(long long)(row0 + row) * f + n0 + col] =
          __float2bfloat16(os[row * OS_LD + col]);
  }
}

constexpr int FKC = 16;       // block columns staged per step (f32)

// f32 variant of the tile: 256 threads, each owns 4x4 outputs.
__device__ __forceinline__ void mca_tile_f32(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ idx, const float* __restrict__ inv_rp,
    float* __restrict__ out, int r, int row0, int row_end, int n0, int d,
    int f, int block, float (*xs)[BM + 1], float (*ws)[BN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nblocks = d / block;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < r; ++k) {
    const int s = idx[k];
    if (s < 0 || s >= nblocks) continue;
    const float sc = inv_rp[k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
    for (int kc = 0; kc < block; kc += FKC) {
      const long long col0 = (long long)s * block + kc;
      for (int v = tid; v < BM * FKC; v += blockDim.x) {
        const int row = v / FKC, c = v % FKC;
        xs[c][row] = (row0 + row < row_end)
                         ? x[(long long)(row0 + row) * d + col0 + c]
                         : 0.0f;
      }
      for (int v = tid; v < FKC * BN; v += blockDim.x) {
        const int row = v / BN, c = v % BN;
        ws[row][c] = (n0 + c < f) ? w[(col0 + row) * (long long)f + n0 + c]
                                  : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FKC; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += sc * part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < f) out[(long long)row * f + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(128)
mca_fixed_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const int* __restrict__ idx,
                      const float* __restrict__ inv_rp,
                      __nv_bfloat16* __restrict__ out,
                      int m, int d, int f, int r, int block) {
  __shared__ __align__(128) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ __align__(128) __nv_bfloat16 ws[KC * WS_LD];
  __shared__ __align__(128) float os[BM * OS_LD];
  const int m0 = blockIdx.y * BM;
  mca_tile_bf16(x, w, idx, inv_rp, out, r, m0, min(m0 + BM, m),
                blockIdx.x * BN, d, f, block, xs, ws, os);
}

__global__ void __launch_bounds__(256)
mca_fixed_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ idx,
                     const float* __restrict__ inv_rp, float* __restrict__ out,
                     int m, int d, int f, int r, int block) {
  __shared__ float xs[FKC][BM + 1];   // transposed x tile
  __shared__ float ws[FKC][BN];
  const int m0 = blockIdx.y * BM;
  mca_tile_f32(x, w, idx, inv_rp, out, r, m0, min(m0 + BM, m),
               blockIdx.x * BN, d, f, block, xs, ws);
}

// Ragged grid row y -> (row tile t, its rows [row0, row_end), its sample
// count r clamped to [0, r_max]).
__device__ __forceinline__ void ragged_rows(const int* __restrict__ r_tile,
                                            int bm, int r_max, int* t,
                                            int* row0, int* row_end, int* r) {
  const int chunks = (bm + BM - 1) / BM;
  *t = blockIdx.y / chunks;
  *row0 = *t * bm + (blockIdx.y % chunks) * BM;
  *row_end = min(*row0 + BM, (*t + 1) * bm);
  *r = max(0, min(r_tile[*t], r_max));
}

__global__ void __launch_bounds__(128)
mca_ragged_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ r_tile,
                       const int* __restrict__ idx,
                       const float* __restrict__ inv_rp,
                       __nv_bfloat16* __restrict__ out,
                       int d, int f, int bm, int r_max, int block) {
  __shared__ __align__(128) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ __align__(128) __nv_bfloat16 ws[KC * WS_LD];
  __shared__ __align__(128) float os[BM * OS_LD];
  int t, row0, row_end, r;
  ragged_rows(r_tile, bm, r_max, &t, &row0, &row_end, &r);
  const long long s0 = (long long)t * r_max;
  mca_tile_bf16(x, w, idx + s0, inv_rp + s0, out, r, row0, row_end,
                blockIdx.x * BN, d, f, block, xs, ws, os);
}

__global__ void __launch_bounds__(256)
mca_ragged_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const int* __restrict__ r_tile,
                      const int* __restrict__ idx,
                      const float* __restrict__ inv_rp,
                      float* __restrict__ out,
                      int d, int f, int bm, int r_max, int block) {
  __shared__ float xs[FKC][BM + 1];
  __shared__ float ws[FKC][BN];
  int t, row0, row_end, r;
  ragged_rows(r_tile, bm, r_max, &t, &row0, &row_end, &r);
  const long long s0 = (long long)t * r_max;
  mca_tile_f32(x, w, idx + s0, inv_rp + s0, out, r, row0, row_end,
               blockIdx.x * BN, d, f, block, xs, ws);
}

dim3 ragged_grid(int m_tiles, int bm, int f) {
  return dim3((f + BN - 1) / BN, m_tiles * ((bm + BM - 1) / BM));
}

}  // namespace

// x: [m, d], w: [d, f], out: [m, f], all contiguous, same dtype (bf16);
// idx: [r] int32, inv_rp: [r] f32, on the device.  Needs d % block == 0,
// block % 32 == 0, f % 8 == 0 and 16-byte aligned x/w (the wrapper checks).
extern "C" int mca_matmul_fixed_bf16(const void* x, const void* w,
                                     const void* idx, const void* inv_rp,
                                     void* out, int m, int d, int f, int r,
                                     int block, void* stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  mca_fixed_bf16_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)idx,
      (const float*)inv_rp, (__nv_bfloat16*)out, m, d, f, r, block);
  return (int)cudaGetLastError();
}

// f32 variant: needs d % block == 0 and block % 16 == 0.
extern "C" int mca_matmul_fixed_f32(const void* x, const void* w,
                                    const void* idx, const void* inv_rp,
                                    void* out, int m, int d, int f, int r,
                                    int block, void* stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  mca_fixed_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)idx, (const float*)inv_rp,
      (float*)out, m, d, f, r, block);
  return (int)cudaGetLastError();
}

// Ragged, bf16.  x: [m, d], w: [d, f], out: [m, f] with m = m_tiles * bm;
// r_tile: [m_tiles] int32; idx: [m_tiles, r_max] int32; inv_rp:
// [m_tiles, r_max] f32; all contiguous on the device.  The same alignment
// needs as the fixed bf16 kernel.
extern "C" int mca_matmul_ragged_bf16(const void* x, const void* w,
                                      const void* r_tile, const void* idx,
                                      const void* inv_rp, void* out,
                                      int m_tiles, int bm, int d, int f,
                                      int r_max, int block, void* stream) {
  mca_ragged_bf16_kernel<<<ragged_grid(m_tiles, bm, f), 128, 0,
                           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)r_tile,
      (const int*)idx, (const float*)inv_rp, (__nv_bfloat16*)out, d, f, bm,
      r_max, block);
  return (int)cudaGetLastError();
}

// Ragged, f32: needs d % block == 0 and block % 16 == 0.
extern "C" int mca_matmul_ragged_f32(const void* x, const void* w,
                                     const void* r_tile, const void* idx,
                                     const void* inv_rp, void* out,
                                     int m_tiles, int bm, int d, int f,
                                     int r_max, int block, void* stream) {
  mca_ragged_f32_kernel<<<ragged_grid(m_tiles, bm, f), 256, 0,
                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)r_tile, (const int*)idx,
      (const float*)inv_rp, (float*)out, d, f, bm, r_max, block);
  return (int)cudaGetLastError();
}
