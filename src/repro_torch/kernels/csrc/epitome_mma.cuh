// The main loop shared by the int8-code kernels: kernel #1,
// quant_epitome_matmul_blocks (float32 and bf16 entries), kernel #2,
// quant_epitome_matmul_fused_fold, and kernel #5, quant_matmul (the dense
// case: an identity column table, bk = bn = 256).  Kernel #3's float loop
// (epitome_fp_mma.cuh) runs on this tile, ring, split-K and epilogue.
//
//   y[:, j*bn + c] = sum_k x[:, k] * (q[k, cb[j]*bn + c] + z[b, cb[j]]) * s[b, cb[j]]
//
// with q int8 codes and one float32 (s, z) per (bk x bn) pack block b.
//
// Arithmetic.  The codes are integers of at most 8 bits, so each is exact in
// bf16, and a bf16 x bf16 product summed in float32 on the tensor cores is
// exact.  So (s, z) stay outside the product: for each pack block b
//
//   y[:, j] += s_b * (x_b . q_b + z_b * sum_{k in b} x_k)
//
// x_b . q_b runs as mma.sync m16n8k16 (m16n8k8 where bk = 8) with the codes
// turned into bf16 in registers; the row sums come out of the same tensor
// cores, as the product with a tile of ones (summed in float32 beside
// x_b . q_b, their roundings go the same way, which matters as x_b . q_b
// and z sum x nearly cancel: row sums added in SIMT float32 instead moved
// the LM's logits 8x further from the CPU's); and each pack block's
// partial is scaled into the running float32 sum once, at the block
// boundary: one (s, z) per block and step, no per-element lookup.  A bf16
// activation takes one pass.  A float32 activation is split while its tile
// is staged into hi = bf16(x) and lo = fp16((x - hi) 2^8), and takes two
// passes, the second on fp16 tensor cores against the codes as fp16 / 2^8
// (exact too).  What the pair misses is below 2^-20 |x|.  With lo in bf16
// (2^-17 |x|) each kernel-vs-plain gate (2e-4) held some 40 times over,
// but the error grew through ResNet-50's 53 layers and their BatchNorms to
// 75 % of chip_smoke.py's logits gate (card against CPU, 1e-4 max(1, |y|),
// the largest of 5 seeds); fp16 lo leaves it at 21 %.  A third bf16 pass
// (lo2) did as well, at 24 %, but made the loop 17 % slower, and kernel
// #1's fp32 sum over a searched ResNet-50 plan slower than cuBLAS's.
// (tests/mma_models.py models each split on the CPU.)
//
// Prefill rows (T above the cut-over the wrapper picks, 32): a 128 x BN
// block tile (BN = 128, or 64 where bn < 128) of 8 warps, each warp a
// 64 x 32 (or 32 x 32) tile of 4 x 4 (2 x 4) mma tiles; the contraction
// in steps of 32 rows through a ring of 4 stages in dynamic shared memory,
// filled with 16-byte cp.async (the activation, and the int8 code tile, so
// codes cross HBM at one byte each), one __syncthreads per stage.  A
// thread reads the codes of four neighbouring columns as one 32-bit word,
// so the four n8 tiles of a warp interleave their columns (tile jj holds
// columns 4l + jj), and the store puts them back: each thread ends with 8
// neighbouring columns of a row.  The output block j reads its cb[j] itself, and a column tile never
// spans two output blocks.  Where the output tiles fill less than a wave of
// 132 SMs (ResNet's deep layers, fc), the wrapper splits the contraction
// over blocks as the decode loop does (below).
//
// The activation tile's producer is what tells the modes apart (AMODE):
//   kDirect  bf16 x, copied as it is and read with ldmatrix;
//   kSplit   float32 x, copied, then split into hi/lo buffers one stage
//            ahead of the product;
//   kFold    kernel #2: float32 x unfolded (T, M); each epitome row k sums
//            the virtual rows that sample it, in ascending order, from the
//            inverse table ops.fold_table (its padding, M, ends a row), an
//            fp32 sum then split hi/lo.  No scan over the gm row blocks
//            and no cap on gm.  A (row tile, step) slice is folded once for
//            the block's BN columns, so a row tile is folded ceil(bn / BN) * gn
//            times: at ResNet-50's CR-4 shapes once (N = 64, 128), twice
//            (256), 4 (512), 8 (1000, 1024) or 16 times (2048).
//
// Decode rows (T up to the cut-over): the work is bound by the codes' bytes
// (8 FLOPs per code byte at T = 4).  decode_kernel splits the contraction
// across blocks: each block takes 128 columns and 64 or 128 rows (the
// wrapper picks the larger where it still gives two waves of 132 SMs), each
// thread streams 16 codes of each of 4 or 8 neighbouring rows with 16-byte
// loads, all in flight together, and sums them with SIMT FMAs against the
// staged rows of x; rows t >= T are not computed.  A thread's run of rows
// lies in one pack block, so it scales its partial once.  The block sums its
// 16 row lanes pairwise; the splits meet in a float32 scratch, and the
// last block to finish a column tile (a ticket counter, which that block
// resets to 0) sums them, 16 at a time pairwise, the groups in split order,
// and writes y (sum_splits).  No atomics touch the output, so a launch
// repeats bit for bit, and it is one launch.  Summed one after another,
// the splits are most of the distance from the float64 product at kernel
// #5's M = 14336 (112 splits), which chip_smoke.py gates no further than
// cuBLAS's (tests/mma_models.py models both orders).
//
// Ragged edges are masked in every mode: rows t >= T, contraction rows
// k >= m and columns c >= bn are staged as zero and not stored, so no caller
// pads.  Copies fall back to plain loads where a row is not 16-byte aligned
// (an odd m, bn not a multiple of 16).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace epim_mma {
// Internal linkage: several libraries instantiate the same templates, and
// their function-local statics (the once-flags of allow_smem) would
// otherwise be one object in the process (GNU unique symbols), so a
// kernel of the second library to load never got its shared-memory size.
namespace {

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename XT> __device__ __forceinline__ XT from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills them when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b, bf16 inputs, float32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
// the same with fp16 inputs
__device__ __forceinline__ void mma_16816_h(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_1688_h(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Code j of a 32-bit word of four int8 codes, exactly, as float32.  The word
// must have been xor-ed with 0x80808080, which moves each code c to c + 128
// in [0, 255]; under the exponent of 2^23 that byte is the float
// 2^23 + c + 128, and the subtraction leaves c.
__device__ __forceinline__ float code_at(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | j)) - 8388736.f;
}
// Two small integers held exactly in float32 as a bf16 pair (lo in the low
// half): a float32 with at most 8 significant bits is its top 16 bits.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}
// Codes j0 of word u and j1 of word v (both xor-ed with 0x80808080) as an
// fp16 pair (j0's in the low half), each scaled by 2^-8, exactly: the byte
// c + 128 under the fp16 exponent of 4 is 4 + (c + 128) / 256, and
// subtracting 4.5 leaves c / 256.
__device__ __forceinline__ uint32_t f16_pair(uint32_t u, uint32_t v, int j0, int j1) {
  const uint32_t t = (__byte_perm(u, v, j0 | ((4 + j1) << 8)) & 0x00FF00FFu) | 0x44004400u;
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&t), __float2half2_rn(4.5f));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// A float32 value split into hi = bf16(x) and lo = fp16((x - hi) 2^8): x -
// hi is exact in float32 and below 2^-9 |x|, so the fp16 scaled by 2^8
// keeps 11 more bits in its normal range (clamped at 65504, |x| < 2^17 is
// exact to 2^-20 |x|).  The lo pass multiplies codes scaled by 2^-8.
constexpr float kLoScale = 256.f;
__device__ __forceinline__ float lo_scaled(float x, float hi) {
  return fminf(fmaxf((x - hi) * kLoScale, -65504.f), 65504.f);
}
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&out)[2]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __half2 l = __floats2half2_rn(lo_scaled(x0, hf.x), lo_scaled(x1, hf.y));
  out[0] = *reinterpret_cast<const uint32_t*>(&h);
  out[1] = *reinterpret_cast<const uint32_t*>(&l);
}
constexpr int NSPLIT = 2;  // passes of a float32 activation: bf16 hi, fp16 lo

constexpr uint32_t kOnes = 0x3F803F80u;    // bf16 pair (1, 1)
constexpr uint32_t kOnesLo = 0x1C001C00u;  // fp16 pair (2^-8, 2^-8)

struct Args {
  const void* x;          // XT; kDirect/kSplit and decode: (T, ldx); kFold: float32 (T, M)
  union {                 // the weight: one pointer, so that Args keeps its size (a
                          // field more, or a null test of cb, made kernel #2 spill)
    const int8_t* q;      // (m, n) int8 codes: kernels #1, #2, #5
    const void* e;        // kernel #3: E (m, n) in x's type (epitome_fp_mma.cuh)
  };
  const float* scales;    // (ceil(m / bk), s_cols)
  const float* zeros;
  const int* cb;          // (gn,) epitome column block of output block j
  const long long* fold;  // kFold: (C * m,) virtual rows of each epitome row, column by column
  void* y;                // XT (T, gn * bn)
  float* scratch;         // split-K: (splits, T, gn * bn) partial sums
  int* counters;          // split-K: one ticket counter per output tile, all 0
  int T, m, n, gn, bn, bk, s_cols, ldx, M, C, split_rows;
  int vec_a, vec_b, vec_y;  // 16-byte copies and stores allowed
};

__device__ __forceinline__ float4 operator+(float4 p, float4 q) {
  return make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w);
}
// Sum of 16 values as a balanced tree (v[u] + v[u + 8], then + 4, + 2,
// + 1): four roundings deep where a chain is sixteen.
template <typename V>
__device__ __forceinline__ V tree16(const V (&v)[16]) {
  V h[8], q[4];
#pragma unroll
  for (int u = 0; u < 8; ++u) h[u] = v[u] + v[u + 8];
#pragma unroll
  for (int u = 0; u < 4; ++u) q[u] = h[u] + h[u + 4];
  return (q[0] + q[2]) + (q[1] + q[3]);
}

// ---------------------------------------------------------------------------
// Split-K: the splits of an output tile meet in a float32 scratch
// (splits, T, gn * bn); the last block of the tile to finish (a ticket
// counter, which it sets back to 0 for the next launch) sums them in a fixed
// order and writes y.  No atomics on the output: a launch repeats bit for
// bit.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool last_of_tile(int* counter, int splits) {
  __shared__ int is_last;
  __threadfence();     // this block's partials reach L2 before its ticket
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// Rows [t0, t0 + rows) and the ncol columns from ycol0 of the output, from
// the scratch; 16 splits at a time, each group summed as a tree (+ 0 past
// the last split changes nothing), the groups in split order.
template <typename XT>
__device__ void sum_splits(const Args& a, int splits, int t0, int rows, size_t ycol0,
                           int ncol, int nthreads) {
  const size_t ldy = (size_t)a.gn * a.bn, stride = (size_t)a.T * ldy;
  XT* y = static_cast<XT*>(a.y);
  const bool vec = a.bn % 4 == 0;
  const int per_row = vec ? (ncol + 3) / 4 : ncol;
  for (int o = threadIdx.x; o < rows * per_row; o += nthreads) {
    const int t = t0 + o / per_row;
    if (t >= a.T) continue;
    const int c = (o % per_row) * (vec ? 4 : 1);
    const float* src = a.scratch + (size_t)t * ldy + ycol0 + c;
    XT* dst = y + (size_t)t * ldy + ycol0 + c;
    if (vec) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < splits; s0 += 16) {
        float4 b[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          b[u] = s0 + u < splits ? __ldcg(reinterpret_cast<const float4*>(src + (s0 + u) * stride))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        v = v + tree16(b);
      }
      const float o4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < ncol) dst[e] = from_f32<XT>(o4[e]);
    } else {
      float v = 0.f;
      for (int s0 = 0; s0 < splits; s0 += 16) {
        float b[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) b[u] = s0 + u < splits ? __ldcg(src + (s0 + u) * stride) : 0.f;
        v += tree16(b);
      }
      dst[0] = from_f32<XT>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// Prefill rows: the tensor-core main loop
// ---------------------------------------------------------------------------
enum AMode { kDirect = 0, kSplit = 1, kFold = 2 };

constexpr int KS = 32;      // contraction rows per stage
constexpr int STAGES = 4;   // ring depth
constexpr int LDH = 40;     // bf16 per row of an A operand buffer (32 + 8: conflict-free ldmatrix)
constexpr int LDF = 36;     // float32 per row of a staged float32 tile (32 + 4)

// A block is 8 warps: 8 / WN row groups of WN warps, each warp 16 MI rows
// (MI 16-row mma tiles) x 32 columns (four n8 tiles): 128 x 128 as 64 x 32
// warp tiles (WN = 4, MI = 4), and 128 x 64 as 32 x 32 (WN = 2, MI = 2)
// where bn < 128, so a narrow tile keeps 8 warps (with 4, ResNet-50's
// 64-wide first-stage layers ran slower).
template <int WN, int MI> struct Tile {
  static constexpr int BN = 32 * WN;              // output columns per block
  static constexpr int BM = 16 * MI * (8 / WN);   // activation rows per block
  static constexpr int THREADS = 256;
  static constexpr int LDB = BN + 16;       // bytes per staged code row (conflict-free words)
};

template <int AMODE, int WN, int MI>
constexpr size_t mma_smem_bytes() {
  constexpr int BM = Tile<WN, MI>::BM;
  return (size_t)STAGES * KS * Tile<WN, MI>::LDB
         + (AMODE == kDirect ? (size_t)STAGES * BM * LDH * 2 : 0)
         + (AMODE == kSplit ? (size_t)STAGES * BM * LDF * 4 : 0)
         + (AMODE == kDirect ? 0 : (size_t)2 * NSPLIT * BM * LDH * 2);
}

// The epilogue of a prefill tile: each thread holds tot[i][jj][e], 8
// neighbouring columns (n8 tile jj holds columns 4l + jj) of 2 MI rows.
// Split-K: this split's partial goes to the scratch, and the tile's last
// block sums the splits into y.
template <typename XT, int WN, int MI>
__device__ __forceinline__ void store_tile(const Args& a, const float (&tot)[MI][4][4],
                                           int row0, size_t ycol0, int ncol) {
  using Tl = Tile<WN, MI>;
  constexpr int WROWS = 16 * MI;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN, g = lane >> 2, c4 = lane & 3;
  const int nsplit = gridDim.z;
  const size_t ldy = (size_t)a.gn * a.bn;
  const int cl = wn * 32 + 8 * c4;
  if (nsplit > 1) {   // this split's partial, then the tile's last block sums them
    float* part = a.scratch + (size_t)blockIdx.z * a.T * ldy;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = row0 + wm * WROWS + 16 * i + g + 8 * half;
        if (t >= a.T) continue;
        float* dst = part + (size_t)t * ldy + ycol0 + cl;
        if (a.vec_y && cl + 8 <= ncol) {
          reinterpret_cast<float4*>(dst)[0] = make_float4(
              tot[i][0][2 * half], tot[i][1][2 * half], tot[i][2][2 * half], tot[i][3][2 * half]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(
              tot[i][0][2 * half + 1], tot[i][1][2 * half + 1], tot[i][2][2 * half + 1],
              tot[i][3][2 * half + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (cl + e < ncol) dst[e] = tot[i][e & 3][2 * half + (e >> 2)];
        }
      }
    int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (!last_of_tile(counter, nsplit)) return;
    sum_splits<XT>(a, nsplit, row0, Tl::BM, ycol0, ncol, Tl::THREADS);
    if (tid == 0) *counter = 0;
    return;
  }
  XT* y = static_cast<XT*>(a.y);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = row0 + wm * WROWS + 16 * i + g + 8 * half;
      if (t >= a.T) continue;
      float o[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        o[jj] = tot[i][jj][2 * half];
        o[4 + jj] = tot[i][jj][2 * half + 1];
      }
      XT* dst = y + (size_t)t * ldy + ycol0 + cl;
      if (a.vec_y && cl + 8 <= ncol) {
        if constexpr (sizeof(XT) == 4) {
          reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
        } else {
          uint4 p;
          const __nv_bfloat162 p0 = __floats2bfloat162_rn(o[0], o[1]);
          const __nv_bfloat162 p1 = __floats2bfloat162_rn(o[2], o[3]);
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(o[4], o[5]);
          const __nv_bfloat162 p3 = __floats2bfloat162_rn(o[6], o[7]);
          p.x = *reinterpret_cast<const uint32_t*>(&p0);
          p.y = *reinterpret_cast<const uint32_t*>(&p1);
          p.z = *reinterpret_cast<const uint32_t*>(&p2);
          p.w = *reinterpret_cast<const uint32_t*>(&p3);
          *reinterpret_cast<uint4*>(dst) = p;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (cl + e < ncol) dst[e] = from_f32<XT>(o[e]);
      }
    }
}

template <int AMODE, typename XT, int WN, int MI, int GR>
__global__ void __launch_bounds__(Tile<WN, MI>::THREADS, 1) mma_kernel(Args a) {
  using Tl = Tile<WN, MI>;
  constexpr int BN = Tl::BN, THREADS = Tl::THREADS, LDB = Tl::LDB, BM = Tl::BM;
  constexpr int WROWS = 16 * MI;
  constexpr int LDA = AMODE == kDirect ? LDH : LDF;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Bs = reinterpret_cast<int8_t*>(smem);                      // [STAGES][KS][LDB]
  unsigned char* rest = smem + (size_t)STAGES * KS * LDB;
  XT* Araw = reinterpret_cast<XT*>(rest);                            // [STAGES][BM][LDA]
  __nv_bfloat16* H = reinterpret_cast<__nv_bfloat16*>(               // [2][hi, lo][BM][LDH]
      rest + (AMODE == kSplit ? (size_t)STAGES * BM * LDF * 4 : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, c4 = lane & 3;
  const int tiles = (a.bn + BN - 1) / BN;
  const int j = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * BN;   // column inside output block j
  const int row0 = blockIdx.y * BM;
  const int cbj = __ldg(a.cb + j);
  const size_t wcol0 = (size_t)cbj * a.bn + c0;
  const int ncol = min(BN, a.bn - c0);
  // split-K (few output tiles): this block contracts rows [kbeg, kend)
  const int nsplit = gridDim.z;
  const int kbeg = nsplit > 1 ? blockIdx.z * a.split_rows : 0;
  const int kend = nsplit > 1 ? min(a.m, kbeg + a.split_rows) : a.m;
  const int kt0 = kbeg / KS, nk = (kend + KS - 1) / KS - kt0;   // steps kt0 .. kt0 + nk

  auto load_b = [&](int slot, int kt) {
    int8_t* dst = Bs + (size_t)slot * KS * LDB;
    const int k0 = kt * KS;
    if (a.vec_b) {
      constexpr int CH = BN / 16;
      for (int idx = tid; idx < KS * CH; idx += THREADS) {
        const int r = idx / CH, c = (idx % CH) * 16, k = k0 + r;
        const bool ok = k < a.m && c < ncol;
        cp_async16(dst + r * LDB + c, ok ? a.q + (size_t)k * a.n + wcol0 + c : a.q, ok);
      }
    } else {
      for (int idx = tid; idx < KS * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN, k = k0 + r;
        dst[r * LDB + c] = (k < a.m && c < ncol) ? a.q[(size_t)k * a.n + wcol0 + c] : int8_t(0);
      }
    }
  };
  auto load_a = [&](int slot, int kt) {
    XT* dst = Araw + (size_t)slot * BM * LDA;
    const XT* x = static_cast<const XT*>(a.x);
    const int k0 = kt * KS;
    if (a.vec_a) {
      constexpr int EPC = 16 / (int)sizeof(XT), CH = KS / EPC;
      for (int idx = tid; idx < BM * CH; idx += THREADS) {
        const int r = idx / CH, kk = (idx % CH) * EPC;
        const int t = row0 + r, k = k0 + kk;
        const bool ok = t < a.T && k < a.m;
        cp_async16(dst + r * LDA + kk, ok ? x + (size_t)t * a.ldx + k : x, ok);
      }
    } else {
      for (int idx = tid; idx < BM * KS; idx += THREADS) {
        const int r = idx / KS, kk = idx % KS, t = row0 + r, k = k0 + kk;
        dst[r * LDA + kk] = (t < a.T && k < a.m) ? x[(size_t)t * a.ldx + k] : from_f32<XT>(0.f);
      }
    }
  };
  auto split = [&](int slot, int buf) {
    const float* src = reinterpret_cast<const float*>(Araw) + (size_t)slot * BM * LDF;
    __nv_bfloat16* dst = H + (size_t)(NSPLIT * buf) * BM * LDH;
    for (int idx = tid; idx < BM * KS / 4; idx += THREADS) {
      const int r = idx / (KS / 4), kk = (idx % (KS / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(src + r * LDF + kk);
      uint32_t p0[NSPLIT], p1[NSPLIT];
      split_pair(v.x, v.y, p0);
      split_pair(v.z, v.w, p1);
#pragma unroll
      for (int pass = 0; pass < NSPLIT; ++pass)
        *reinterpret_cast<uint2*>(dst + (size_t)pass * BM * LDH + r * LDH + kk) =
            make_uint2(p0[pass], p1[pass]);
    }
  };
  // kernel #2's producer: fold step kt of the row tile straight into hi/lo.
  // A warp takes one row's 32 epitome rows (neighbouring k read neighbouring
  // virtual rows); 8 rows and 4 table entries per round keep 32 loads in
  // flight; each sum adds in ascending table order from +0, as the
  // reference's fold does (a padded entry adds +0, which changes nothing).
  auto fold = [&](int kt, int buf) {
    const float* x = static_cast<const float*>(a.x);
    __nv_bfloat16* hi = H + (size_t)(NSPLIT * buf) * BM * LDH;
    __half* lo = reinterpret_cast<__half*>(hi + (size_t)BM * LDH);
    const int kk = tid % KS, k = kt * KS + kk;
    const bool kin = k < a.m;
    constexpr int FR = 8;   // rows per round: FR x 4 loads in flight
    for (int r0 = (tid / KS) * FR; r0 < BM; r0 += THREADS / KS * FR) {
      float v[FR];
#pragma unroll
      for (int rr = 0; rr < FR; ++rr) v[rr] = 0.f;
      for (int c = 0; c < a.C; c += 4) {
        long long u[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          u[cc] = (kin && c + cc < a.C) ? __ldg(a.fold + (size_t)(c + cc) * a.m + k) : a.M;
        if (u[0] >= a.M) break;   // the table ascends, its padding last
        float e[4][FR];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int rr = 0; rr < FR; ++rr) {
            const int t = row0 + r0 + rr;
            e[cc][rr] = (u[cc] < a.M && t < a.T) ? __ldg(x + (size_t)t * a.M + u[cc]) : 0.f;
          }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int rr = 0; rr < FR; ++rr) v[rr] += e[cc][rr];
      }
#pragma unroll
      for (int rr = 0; rr < FR; ++rr) {
        const __nv_bfloat16 h = __float2bfloat16(v[rr]);
        hi[(r0 + rr) * LDH + kk] = h;
        lo[(r0 + rr) * LDH + kk] = __float2half_rn(lo_scaled(v[rr], __bfloat162float(h)));
      }
    }
  };

  float acc[MI][4][4], rsum[MI][4], tot[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rsum[i][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj][e] = tot[i][jj][e] = 0.f;
    }
  int pb = kbeg / a.bk;                                // current pack block
  int kb_end = min((pb + 1) * a.bk, kend);             // and where it ends here
  auto flush = [&]() {
    const size_t sz = (size_t)pb * a.s_cols + cbj;
    const float s = __ldg(a.scales + sz), z = __ldg(a.zeros + sz);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[i][jj][e] = fmaf(s, fmaf(z, rsum[i][e & 2], acc[i][jj][e]), tot[i][jj][e]);
          acc[i][jj][e] = 0.f;
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) rsum[i][e] = 0.f;
    }
    ++pb;
    kb_end = min((pb + 1) * a.bk, kend);
  };

  constexpr int NP = AMODE == kDirect ? 1 : NSPLIT;    // passes: bf16 x or hi, fp16 lo
  auto compute = [&](int slot, int buf, int kt) {
    // pass p's operand: A + p * BM * LDH
    const __nv_bfloat16* A = AMODE == kDirect
        ? reinterpret_cast<const __nv_bfloat16*>(Araw) + (size_t)slot * BM * LDH
        : H + (size_t)(NSPLIT * buf) * BM * LDH;
    const int8_t* Bt = Bs + (size_t)slot * KS * LDB;
    // pass p's code fragments: the codes of columns 4g..4g+3 of the warp's
    // 32, rows 2c4 + {0, 1, 8, 9} (n8 tile jj holds columns 4l + jj); pass
    // 0 takes them as bf16, pass 1 as fp16 / 2^8
    auto codes = [&](int s16, int p, uint32_t (&b)[4][2]) {
      const int8_t* bp = Bt + (s16 + 2 * c4) * LDB + wn * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(bp) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(bp + LDB) ^ 0x80808080u;
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(bp + 8 * LDB) ^ 0x80808080u;
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(bp + 9 * LDB) ^ 0x80808080u;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (p == 0) {
          b[jj][0] = bf16_pair(code_at(w0, jj), code_at(w1, jj));
          b[jj][1] = bf16_pair(code_at(w2, jj), code_at(w3, jj));
        } else {
          b[jj][0] = f16_pair(w0, w1, jj, jj);
          b[jj][1] = f16_pair(w2, w3, jj, jj);
        }
      }
    };
#pragma unroll
    for (int s16 = 0; s16 < KS; s16 += 16) {
      const int kg = kt * KS + s16;
      if (kg >= kend) break;
      const int arow = wm * WROWS + (lane & 15), acol = s16 + (lane >> 4) * 8;
      if constexpr (GR == 16) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          uint32_t b[4][2];
          codes(s16, p, b);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            uint32_t af[4];
            ldmatrix_x4(af, A + (size_t)p * BM * LDH + (arow + 16 * i) * LDH + acol);
            if (p == 0) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) mma_16816(acc[i][jj], af, b[jj][0], b[jj][1]);
              mma_16816(rsum[i], af, kOnes, kOnes);
            } else {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) mma_16816_h(acc[i][jj], af, b[jj][0], b[jj][1]);
              mma_16816_h(rsum[i], af, kOnesLo, kOnesLo);
            }
          }
        }
        if (kg + 16 >= kb_end) flush();
      } else {  // bk = 8: two k8 halves, a pack block each; a 16 x 16
                // fragment holds both halves (registers 0-1 and 2-3)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kg + 8 * h >= kend) break;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            uint32_t b[4][2];
            codes(s16, p, b);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
              uint32_t af[4];
              ldmatrix_x4(af, A + (size_t)p * BM * LDH + (arow + 16 * i) * LDH + acol);
              if (p == 0) {
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  mma_1688(acc[i][jj], af[2 * h], af[2 * h + 1], b[jj][h]);
                mma_1688(rsum[i], af[2 * h], af[2 * h + 1], kOnes);
              } else {
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  mma_1688_h(acc[i][jj], af[2 * h], af[2 * h + 1], b[jj][h]);
                mma_1688_h(rsum[i], af[2 * h], af[2 * h + 1], kOnesLo);
              }
            }
          }
          if (kg + 8 * h + 8 >= kb_end) flush();
        }
      }
    }
  };

  // prologue: STAGES - 1 stages in flight (a group per stage, empty or not)
  // (step i of this block is contraction step kt0 + i)
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_b(s, kt0 + s);
      if (AMODE != kFold) load_a(s, kt0 + s);
    }
    cp_async_commit();
  }
  if (AMODE == kSplit) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    split(0, 0);
  }
  if (AMODE == kFold) fold(kt0, 0);

  for (int i = 0; i < nk; ++i) {
    // step i (and, for kSplit, i + 1) has landed; every thread is done with
    // step i - 1, whose slots the next copies and the producer reuse
    if (AMODE == kSplit) cp_async_wait<STAGES - 3>();
    else cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < nk) {
      load_b(nxt % STAGES, kt0 + nxt);
      if (AMODE != kFold) load_a(nxt % STAGES, kt0 + nxt);
    }
    cp_async_commit();
    if (AMODE == kSplit && i + 1 < nk) split((i + 1) % STAGES, (i + 1) & 1);
    if (AMODE == kFold && i + 1 < nk) fold(kt0 + i + 1, (i + 1) & 1);
    compute(i % STAGES, i & 1, kt0 + i);
  }

  store_tile<XT, WN, MI>(a, tot, row0, (size_t)j * a.bn + c0, ncol);
}

// ---------------------------------------------------------------------------
// Decode rows: split-K streaming of the codes
// ---------------------------------------------------------------------------
constexpr int DEC_THREADS = 128;
constexpr int DEC_COLS = 128;    // columns per block: 8 threads of 16 codes
constexpr int DEC_LANES = 16;    // row lanes per block
constexpr int DEC_MAX_T = 32;    // the largest T the decode loop takes

inline size_t decode_smem_bytes(int T, int R, int G) {
  const int TP = (T + 3) & ~3;
  return (size_t)DEC_LANES * R * DEC_COLS + (size_t)DEC_LANES * R * TP * 4
         + (size_t)DEC_LANES * G * DEC_COLS * 4;
}

// G: rows of x per pass (1, 2 or 4; T > 4 takes ceil(T / 4) passes over the
// codes held in registers); R: contraction rows per thread (4 or 8).
template <typename XT, int G, int R>
__global__ void __launch_bounds__(DEC_THREADS, 4) decode_kernel(Args a) {
  constexpr int ROWS = DEC_LANES * R;   // contraction rows per block
  extern __shared__ __align__(16) unsigned char smem[];
  const int TP = (a.T + 3) & ~3;
  uint4* cs = reinterpret_cast<uint4*>(smem);          // [ROWS][DEC_COLS] codes
  float* xs = reinterpret_cast<float*>(cs + ROWS * (DEC_COLS / 16));  // [ROWS][TP]
  float* red = xs + ROWS * TP;                         // [DEC_LANES][G][DEC_COLS]

  const int tid = threadIdx.x, cw = tid & 7, rl = tid >> 3;
  const int tiles = (a.bn + DEC_COLS - 1) / DEC_COLS;
  const int tile = blockIdx.x, j = tile / tiles, c0 = (tile % tiles) * DEC_COLS;
  const int split = blockIdx.y, nsplit = gridDim.y, k0 = split * ROWS;
  const int cbj = __ldg(a.cb + j);
  const size_t wcol0 = (size_t)cbj * a.bn + c0;
  const int ncol = min(DEC_COLS, a.bn - c0);
  const size_t ldy = (size_t)a.gn * a.bn, ycol0 = (size_t)j * a.bn + c0;
  const XT* x = static_cast<const XT*>(a.x);
  XT* y = static_cast<XT*>(a.y);

  // this thread's run: rows k0 + rl*R .. + R, columns 16 cw .. + 16.  Its
  // codes go to shared memory by cp.async, all R rows in flight together
  // while x is staged: loads into registers were sunk by the compiler to
  // their first use, one row's latency at a time.
  const int kr0 = rl * R, kt0 = k0 + kr0, col = cw * 16;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = kt0 + r;
    const bool ok = k < a.m && col < ncol;
    const int8_t* src = a.q + (size_t)k * a.n + wcol0 + col;
    uint4* dst = cs + (kr0 + r) * (DEC_COLS / 16) + cw;
    if (a.vec_b) {
      cp_async16(dst, ok ? src : a.q, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int e = 0; e < 16; ++e)
        if (k < a.m && col + e < ncol)
          w[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
      *dst = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  cp_async_commit();
  for (int idx = tid; idx < TP * ROWS; idx += DEC_THREADS) {
    const int t = idx / ROWS, kr = idx % ROWS, k = k0 + kr;
    xs[kr * TP + t] = (t < a.T && k < a.m) ? to_f32(x[(size_t)t * a.ldx + k]) : 0.f;
  }
  float s = 0.f, z = 0.f;   // a run past m contributes 0
  if (kt0 < a.m) {
    const size_t sz = (size_t)(kt0 / a.bk) * a.s_cols + cbj;
    s = __ldg(a.scales + sz);
    z = __ldg(a.zeros + sz);
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int tg = 0; tg * G < a.T; ++tg) {
    float p[G][16], rs[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      rs[gg] = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) p[gg][e] = 0.f;
    }
#pragma unroll 2   // the codes are in shared memory; fewer rows in flight, no spills
    for (int r = 0; r < R; ++r) {
      const float* xr = xs + (kr0 + r) * TP + tg * G;
      float xv[G];
      if constexpr (G == 4) {
        const float4 v = *reinterpret_cast<const float4*>(xr);
        xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
      } else {
#pragma unroll
        for (int gg = 0; gg < G; ++gg) xv[gg] = xr[gg];
      }
      const uint4 cv = cs[(kr0 + r) * (DEC_COLS / 16) + cw];
      const uint32_t w[4] = {cv.x ^ 0x80808080u, cv.y ^ 0x80808080u,
                             cv.z ^ 0x80808080u, cv.w ^ 0x80808080u};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float f = code_at(w[e >> 2], e & 3);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) p[gg][e] = fmaf(xv[gg], f, p[gg][e]);
      }
#pragma unroll
      for (int gg = 0; gg < G; ++gg) rs[gg] += xv[gg];
    }
    // this run's contribution, once per pack block; then the block's partial
    // in row-lane order
    float* rd = red + (size_t)rl * G * DEC_COLS + col;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        float4 v;
        v.x = s * fmaf(z, rs[gg], p[gg][4 * e4 + 0]);
        v.y = s * fmaf(z, rs[gg], p[gg][4 * e4 + 1]);
        v.z = s * fmaf(z, rs[gg], p[gg][4 * e4 + 2]);
        v.w = s * fmaf(z, rs[gg], p[gg][4 * e4 + 3]);
        *reinterpret_cast<float4*>(rd + gg * DEC_COLS + 4 * e4) = v;
      }
    __syncthreads();
    for (int o = tid; o < G * DEC_COLS; o += DEC_THREADS) {
      const int gg = o / DEC_COLS, c = o % DEC_COLS, t = tg * G + gg;
      float lanes[DEC_LANES];
#pragma unroll
      for (int l = 0; l < DEC_LANES; ++l) lanes[l] = red[(l * G + gg) * DEC_COLS + c];
      const float v = tree16(lanes);
      if (t < a.T && c < ncol) {
        if (nsplit == 1) y[(size_t)t * ldy + ycol0 + c] = from_f32<XT>(v);
        else a.scratch[((size_t)split * a.T + t) * ldy + ycol0 + c] = v;
      }
    }
    __syncthreads();
  }
  if (nsplit == 1 || !last_of_tile(a.counters + tile, nsplit)) return;
  sum_splits<XT>(a, nsplit, 0, a.T, ycol0, ncol, DEC_THREADS);
  if (tid == 0) a.counters[tile] = 0;
}

// ---------------------------------------------------------------------------
// Host side: pick the instantiation, allow its shared memory, launch
// ---------------------------------------------------------------------------
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// once per instantiation (one card): every block here uses dynamic shared
// memory, and a static __shared__ beside 48 KB of it needs the opt-in too
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  done = e == cudaSuccess;
  return e;
}

// 16-byte copies of x's rows and of the weight's (w: WT (m, n)) rows, and
// 8-column stores of y
template <typename XT, typename WT = int8_t>
inline void set_vec(Args& a, const void* w) {
  a.vec_a = aligned16(a.x) && ((size_t)a.ldx * sizeof(XT)) % 16 == 0;
  a.vec_b = aligned16(w) && (a.n * sizeof(WT)) % 16 == 0 && (a.bn * sizeof(WT)) % 16 == 0;
  a.vec_y = aligned16(a.y) && a.bn % 8 == 0;
}

// A prefill kernel on the tile Tl: one block per (output tile, row tile,
// split).  ready: the instantiation's own flag for allow_smem.
template <typename Tl, typename K>
inline int launch_tile(K kernel, size_t smem, bool& ready, const Args& a, cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, smem, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int splits = a.split_rows > 0 ? (a.m + a.split_rows - 1) / a.split_rows : 1;
  const dim3 grid(a.gn * ((a.bn + Tl::BN - 1) / Tl::BN), (a.T + Tl::BM - 1) / Tl::BM, splits);
  kernel<<<grid, Tl::THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int AMODE, typename XT, int WN, int MI, int GR>
inline int launch_mma_t(const Args& a, cudaStream_t stream) {
  static bool ready = false;
  return launch_tile<Tile<WN, MI>>(mma_kernel<AMODE, XT, WN, MI, GR>,
                                   mma_smem_bytes<AMODE, WN, MI>(), ready, a, stream);
}

// A prefill launch's split-K: split_rows is 0 or a multiple of KS, and a
// split launch has its scratch and counters; one split is none.
inline bool take_splits(Args& a) {
  if (a.split_rows < 0 || a.split_rows % KS != 0 ||
      (a.split_rows > 0 && a.split_rows < a.m && (a.scratch == nullptr || a.counters == nullptr)))
    return false;
  if (a.split_rows >= a.m) a.split_rows = 0;
  return true;
}

// The tensor-core loop for any pack: a k16 step lies in one pack block when
// bk is a multiple of 16 or the whole contraction is one block; bk = 8 (the
// only other block pack_blocks makes) takes k8 steps.
// split_rows: 0, or the contraction rows of each split (a multiple of KS),
// whose partials meet in a.scratch under a.counters.
template <int AMODE, typename XT>
inline int launch_mma(Args a, void* stream) {
  if (a.T == 0 || a.gn == 0) return 0;
  if (!take_splits(a)) return static_cast<int>(cudaErrorInvalidValue);
  set_vec<XT>(a, a.q);
  const bool k16 = a.bk % 16 == 0 || a.bk >= a.m;
  if (!k16 && a.bk % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.bn >= 128)
    return k16 ? launch_mma_t<AMODE, XT, 4, 4, 16>(a, st) : launch_mma_t<AMODE, XT, 4, 4, 8>(a, st);
  return k16 ? launch_mma_t<AMODE, XT, 2, 2, 16>(a, st) : launch_mma_t<AMODE, XT, 2, 2, 8>(a, st);
}

template <typename XT, int G, int R>
inline int launch_decode_t(const Args& a, int splits, cudaStream_t stream) {
  static bool ready = false;
  const cudaError_t e = allow_smem(decode_kernel<XT, G, R>, decode_smem_bytes(DEC_MAX_T, R, G), ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.gn * ((a.bn + DEC_COLS - 1) / DEC_COLS), splits);
  decode_kernel<XT, G, R><<<grid, DEC_THREADS, decode_smem_bytes(a.T, R, G), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Decode rows: split_rows (64 or 128) contraction rows per block, a run of
// split_rows / 16 rows per thread, which must lie in one pack block.
template <typename XT>
inline int launch_decode(Args a, void* stream) {
  if (a.T == 0 || a.gn == 0) return 0;
  const int R = a.split_rows / DEC_LANES;
  if (a.T > DEC_MAX_T || (R != 4 && R != 8) || (a.bk % R != 0 && a.bk < a.m))
    return static_cast<int>(cudaErrorInvalidValue);
  set_vec<XT>(a, a.q);
  const int splits = max(1, (a.m + a.split_rows - 1) / a.split_rows);   // m = 0: zeros
  if (splits > 1 && (a.scratch == nullptr || a.counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = a.T == 1 ? 1 : a.T == 2 ? 2 : 4;
  if (R == 4) {
    if (G == 1) return launch_decode_t<XT, 1, 4>(a, splits, st);
    if (G == 2) return launch_decode_t<XT, 2, 4>(a, splits, st);
    return launch_decode_t<XT, 4, 4>(a, splits, st);
  }
  if (G == 1) return launch_decode_t<XT, 1, 8>(a, splits, st);
  if (G == 2) return launch_decode_t<XT, 2, 8>(a, splits, st);
  return launch_decode_t<XT, 4, 8>(a, splits, st);
}

}  // namespace
}  // namespace epim_mma
