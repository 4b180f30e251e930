// The tiled float32 SIMT matmul of the epitome kernel #3
// (epitome_matmul_blocks); kernel #5 (quant_matmul.cu) takes its tile
// sizes and type helpers.  Kernels #1 and #2 have their own main loop,
// epitome_mma.cuh.
//
//   y[:, j*bn + c] = sum_k A[:, k] * W[k, cb[j]*bn + c]
//
// One thread block computes a BM x BN tile of y: row tile blockIdx.y, and
// blockIdx.x names the output column block j together with the BN-wide
// column tile inside it.  The block reads its own cb[j] (there is no scalar
// prefetch on this card) and walks the contraction dimension in steps of
// BK epitome rows, a loop that replaces the TPU kernel's sequential k grid
// axis.  Each step stages an activation tile and a weight tile in shared
// memory; every thread then accumulates a 4 x 4 piece of the tile in
// registers with fp32 FMAs (A = x_folded (T, m), W = E (m, n), float32).
//
// Ragged edges are masked: rows t >= T, epitome rows k >= m and columns
// c >= bn stage as zero and are not stored, so no caller has to pad.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace epim {

constexpr int BM = 64;        // activation rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // epitome rows per contraction step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename XT> __device__ __forceinline__ XT from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

struct TileArgs {
  const float* x;       // x_folded (T, m), row stride ldx
  const float* e;       // E (m, n)
  const int* cb;        // (gn,) epitome column block of output block j
  float* y;             // (T, gn * bn)
  int T, m, n, gn, bn, ldx;
};

// a template, so that a source that includes this header for its constants
// does not build the kernel
template <typename = void>
__global__ void __launch_bounds__(THREADS) epitome_tile_kernel(TileArgs a) {
  const float* x = a.x;
  float* y = a.y;
  __shared__ __align__(16) float As[BK][BM + 4];  // A^T tile, padded rows
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tiles_per_block = (a.bn + BN - 1) / BN;
  const int j = blockIdx.x / tiles_per_block;
  const int c0 = (blockIdx.x % tiles_per_block) * BN;  // column inside block j
  const int row0 = blockIdx.y * BM;
  const int cbj = a.cb[j];
  const size_t wcol0 = (size_t)cbj * a.bn + c0;
  const size_t ycol0 = (size_t)j * a.bn + c0;
  const size_t ldy = (size_t)a.gn * a.bn;

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (int k0 = 0; k0 < a.m; k0 += BK) {
    // Activation tile: 16 neighbouring threads read 16 neighbouring k of
    // one row, and store it transposed so the compute loop reads rows.
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx % BK, r = idx / BK;
      const int t = row0 + r, k = k0 + kk;
      As[kk][r] = (t < a.T && k < a.m) ? x[(size_t)t * a.ldx + k] : 0.f;
    }
    // Weight tile: 64 neighbouring threads read 64 neighbouring columns.
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN, c = idx % BN;
      const int k = k0 + kk;
      Bs[kk][c] = (k < a.m && c0 + c < a.bn) ? a.e[(size_t)k * a.n + wcol0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(ar[i], br[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + ty * 4 + i;
    if (t >= a.T) continue;
    float* yrow = y + (size_t)t * ldy + ycol0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx * 4 + jj;
      if (c0 + c < a.bn) yrow[c] = acc[i][jj];
    }
  }
}

// Launches on the caller's stream and returns cudaGetLastError(), so a
// launch the card refuses is reported to the caller right away.
inline int launch_tile(const TileArgs& a, void* stream) {
  if (a.T == 0 || a.gn == 0) return 0;
  const dim3 grid(a.gn * ((a.bn + BN - 1) / BN), (a.T + BM - 1) / BM);
  epitome_tile_kernel<><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace epim
