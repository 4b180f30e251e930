// Dense int8 dequant matmul with one (scale, zero) per 256 x 256 crossbar
// tile, float32 and bf16 entries.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py, quant_matmul
// (its _kernel):
//   y = x @ ((q + z[k / 256, j / 256]) * s[k / 256, j / 256])
// with q an (M, N) int8 code matrix and one float32 (scale, zero) per
// 256 x 256 tile, M and N multiples of 256.  As in the TPU body, x is
// widened to float32, each code dequantizes as (float(q) + z) * s, the sum
// is float32, and y rounds once to x's dtype at the store.
//
// Bound on an H100: at small T (decode rows) the int8 codes are the bytes,
// one byte per weight against 2 T FLOPs, so the bound is bytes; at large T
// (T = 1024) it is fp32 FMAs (2 T M N FLOPs over 67 TFLOP/s).  The codes
// stay int8 in device memory and dequantize while they are staged in shared
// memory.  The tile is the epitome kernels' 64 x 64 x 16 fp32 SIMT tile
// (epitome_tile.cuh) without a column map: the TPU grid walks k innermost
// with bk = bn = 256, so each 16-row step here lies in one crossbar tile
// and reads one (s, z).
//
// The sum has three fp32 levels: each step's 16 rows into a fresh partial,
// 16 partials into the 256-row tile's sum, and the tiles' sums into the
// total.  rwkv6-7b's contraction runs to M = 14336, and one FMA chain over
// all of it sat about 4 times further from the float64 product than
// cuBLAS on an H100 (chip_smoke.py's float64 check).  The totals live in
// shared memory, each thread's own 16 slots, so that the registers hold
// two levels, not three.  A simple, correct first kernel: split-K and
// tensor cores are later work.
#include "epitome_tile.cuh"

namespace {

using epim::BK;
using epim::BM;
using epim::BN;
using epim::THREADS;

constexpr int TILE = 256;  // one (scale, zero) per TILE x TILE codes

template <typename XT>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const XT* x, const int8_t* q, const float* scales, const float* zeros,
                    XT* y, int T, int M, int N) {
  __shared__ __align__(16) float As[BK][BM + 4];  // x^T tile, padded rows
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float total_s[16 * THREADS];  // output (i, jj) of thread tid: (i*4 + jj)*THREADS + tid

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int s_cols = N / TILE, s_col = c0 / TILE;  // BN divides TILE
  float tile_sum[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) tile_sum[i][jj] = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) total_s[e * THREADS + tid] = 0.f;

  for (int k0 = 0; k0 < M; k0 += BK) {
    // Activation tile: 16 neighbouring threads read 16 neighbouring k of
    // one row, and store it transposed so the FMA loop reads rows.
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx % BK, r = idx / BK, t = row0 + r;
      As[kk][r] = t < T ? epim::to_f32(x[(size_t)t * M + k0 + kk]) : 0.f;
    }
    // Weight tile: 64 neighbouring threads read 64 neighbouring codes.
    const int s = (k0 / TILE) * s_cols + s_col;
    const float sv = scales[s], zv = zeros[s];
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN, c = idx % BN;
      Bs[kk][c] = ((float)q[(size_t)(k0 + kk) * N + c0 + c] + zv) * sv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) part[i][jj] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) part[i][jj] = fmaf(ar[i], br[jj], part[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) tile_sum[i][jj] += part[i][jj];
    if ((k0 + BK) % TILE == 0) {  // the end of a crossbar tile's rows
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          total_s[(i * 4 + jj) * THREADS + tid] += tile_sum[i][jj];
          tile_sum[i][jj] = 0.f;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + ty * 4 + i;
    if (t >= T) continue;
    XT* yrow = y + (size_t)t * N + c0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      yrow[tx * 4 + jj] = epim::from_f32<XT>(total_s[(i * 4 + jj) * THREADS + tid]);
  }
}

// Launches on the caller's stream and returns cudaGetLastError(), so a
// launch the card refuses is reported to the caller right away.
template <typename XT>
int launch(const void* x, const void* q, const void* scales, const void* zeros, void* y,
           int T, int M, int N, void* stream) {
  if (M % TILE || N % TILE) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || N == 0) return 0;  // M == 0 runs: y is all zeros
  const dim3 grid(N / BN, (T + BM - 1) / BM);
  quant_matmul_kernel<XT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<XT*>(y), T, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quant_matmul_launch(const void* x, const void* q, const void* scales,
                                   const void* zeros, void* y, int T, int M, int N,
                                   void* stream) {
  return launch<float>(x, q, scales, zeros, y, T, M, N, stream);
}

extern "C" int quant_matmul_bf16_launch(const void* x, const void* q, const void* scales,
                                        const void* zeros, void* y, int T, int M, int N,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, q, scales, zeros, y, T, M, N, stream);
}
