// The tiled float32 SIMT matmul shared by the three epitome kernels.
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
// registers with fp32 FMAs.  How the two tiles are staged is what tells the
// kernels apart (MODE):
//
//   kFp       A = x_folded (T, m) fp32,  W = E (m, n) fp32
//   kQuant    A = x_folded (T, m) fp32 or bf16, W = (q + z) * s dequantized from
//             int8 codes while staged; (s, z) are looked up by the *pack*
//             block, s[k / bk, cb[j]], so the tile sizes here are free of
//             the pack's bk
//   kFusedFold A = fold of the unfolded x (T, M): for each staged epitome
//             row k, the sum in ascending virtual block i of the rows
//             i*bm + (k - ro[i]) that sample it.  Only the BK x BM slice of
//             the folded activation that this step contracts is ever built.
//
// The activation and the output share one element type XT, float or bf16:
// a bf16 activation converts to float32 while the A tile is staged, the
// sum stays float32, and the result rounds once to XT (to nearest even) at
// the store.
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
constexpr int MAX_GM = 1024;  // fused fold: row-offset table held in shared memory

enum Mode { kFp = 0, kQuant = 1, kFusedFold = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename XT> __device__ __forceinline__ XT from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

struct TileArgs {
  const void* x;        // XT; kFp/kQuant: x_folded (T, m); kFusedFold: x (T, M); row stride ldx
  const float* e;       // kFp: E (m, n)
  const int8_t* q;      // kQuant/kFusedFold: codes (m, n)
  const float* scales;  // kQuant/kFusedFold: (ceil(m / bk), s_cols)
  const float* zeros;
  const int* cb;        // (gn,) epitome column block of output block j
  const int* ro;        // kFusedFold: (gm,) epitome row offset of virtual row block i
  void* y;              // XT, (T, gn * bn)
  int T, m, n, gn, bn, bk, s_cols, ldx;
  int M, bm, gm;        // kFusedFold only
};

template <int MODE, typename XT>
__global__ void __launch_bounds__(THREADS) epitome_tile_kernel(TileArgs a) {
  const XT* x = static_cast<const XT*>(a.x);
  XT* y = static_cast<XT*>(a.y);
  __shared__ __align__(16) float As[BK][BM + 4];  // A^T tile, padded rows
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int ro_s[MODE == kFusedFold ? MAX_GM : 1];

  const int tid = threadIdx.x;
  const int tiles_per_block = (a.bn + BN - 1) / BN;
  const int j = blockIdx.x / tiles_per_block;
  const int c0 = (blockIdx.x % tiles_per_block) * BN;  // column inside block j
  const int row0 = blockIdx.y * BM;
  const int cbj = a.cb[j];
  const size_t wcol0 = (size_t)cbj * a.bn + c0;
  const size_t ycol0 = (size_t)j * a.bn + c0;
  const size_t ldy = (size_t)a.gn * a.bn;

  if (MODE == kFusedFold) {
    for (int i = tid; i < a.gm; i += THREADS) ro_s[i] = a.ro[i];
    __syncthreads();
  }

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
      float v = 0.f;
      if (t < a.T && k < a.m) {
        const XT* xrow = x + (size_t)t * a.ldx;
        if (MODE == kFusedFold) {
          for (int i = 0; i < a.gm; ++i) {  // ascending virtual block order
            const int d = k - ro_s[i];
            const int u = i * a.bm + d;
            if (d >= 0 && d < a.bm && u < a.M) v += to_f32(xrow[u]);
          }
        } else {
          v = to_f32(xrow[k]);
        }
      }
      As[kk][r] = v;
    }
    // Weight tile: 64 neighbouring threads read 64 neighbouring columns.
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN, c = idx % BN;
      const int k = k0 + kk;
      float w = 0.f;
      if (k < a.m && c0 + c < a.bn) {
        const size_t off = (size_t)k * a.n + wcol0 + c;
        if (MODE == kFp) {
          w = a.e[off];
        } else {
          const int s = (k / a.bk) * a.s_cols + cbj;
          w = ((float)a.q[off] + a.zeros[s]) * a.scales[s];
        }
      }
      Bs[kk][c] = w;
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
    XT* yrow = y + (size_t)t * ldy + ycol0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx * 4 + jj;
      if (c0 + c < a.bn) yrow[c] = from_f32<XT>(acc[i][jj]);
    }
  }
}

// Launches on the caller's stream and returns cudaGetLastError(), so a
// launch the card refuses is reported to the caller right away.
template <int MODE, typename XT = float>
inline int launch_tile(const TileArgs& a, void* stream) {
  if (a.T == 0 || a.gn == 0) return 0;
  const dim3 grid(a.gn * ((a.bn + BN - 1) / BN), (a.T + BM - 1) / BM);
  epitome_tile_kernel<MODE, XT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace epim
