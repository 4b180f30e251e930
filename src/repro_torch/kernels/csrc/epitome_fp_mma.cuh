// Kernel #3's tensor-core main loop, epitome_matmul_blocks:
//
//   y[:, j*bn + c] = sum_k x[:, k] * E[k, cb[j]*bn + c]
//
// on the tile, ring, split-K and epilogue of epitome_mma.cuh: a 128 x BN
// block of 8 warps, 4 stages of 32 contraction rows copied by 16-byte
// cp.async, each block reading its own cb[j], ragged edges masked, the
// contraction split over blocks where the output tiles fill less than a
// wave (launch_tile, store_tile).  What differs from the int8 loop is the
// weight, E staged as it is in x's type, and the mma kind that follows it:
//
//   float32: E is not exact in bf16, so 3xTF32 on mma.sync m16n8k8.tf32.
//     Each operand v splits at fragment load into hi = tf32(v) and
//     lo = tf32(v - hi) (cvt.rna, 10 mantissa bits), and x_lo E_hi, x_hi E_lo
//     and x_hi E_hi go into one float32 accumulator, in that order; x_lo E_lo
//     is dropped.  What the three miss is about 2^-21 of each product, where
//     one TF32 pass misses the 2e-4 gate (tests/mma_models.py
//     models both).  Shared memory holds one float32 copy of each tile.
//   bf16: one m16n8k16 pass; bf16 x bf16 products are exact in float32.
//
// Fragments.  A thread reads B as four neighbouring columns 4g .. 4g + 3 of
// an E row in one load (16 bytes of float32, 8 of bf16), so the n8 tiles
// interleave their columns as the int8 loop's do and the epilogue is
// store_tile's.  In a k8 step of the float32 entry the mma's k slots c4 and
// c4 + 4 take rows 2 c4 and 2 c4 + 1 (any order inside a step is the same
// sum where A and B agree), so a thread's A pair is one 8-byte load and its
// B rows two 16-byte loads.  The bf16 entry reads A with ldmatrix and packs
// B's k pairs from two rows with byte permutes.  Row pitches (x: 40
// elements; E: BN + 4 float32, BN + 8 bf16) keep every load conflict-free.
#pragma once

#include "epitome_mma.cuh"

namespace epim_mma {
namespace {   // internal linkage, as in epitome_mma.cuh

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = hi + lo to about 2^-22 |v|, both TF32 (float32 bit patterns whose low
// 13 bits are 0); v - hi is exact in float32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}
// d += a . b, TF32 inputs, float32 sums
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int LDX_FP = 40;   // x elements per staged row (32 + 8)
template <typename XT, int BN>   // E elements per staged row
__host__ __device__ constexpr int lde_fp() { return sizeof(XT) == 4 ? BN + 4 : BN + 8; }

template <typename XT, int WN, int MI>
constexpr size_t fp_smem_bytes() {
  using Tl = Tile<WN, MI>;
  return (size_t)STAGES * (Tl::BM * LDX_FP + KS * lde_fp<XT, Tl::BN>()) * sizeof(XT);
}

template <typename XT, int WN, int MI>
__global__ void __launch_bounds__(Tile<WN, MI>::THREADS, 1) fp_mma_kernel(Args a) {
  using Tl = Tile<WN, MI>;
  constexpr int BN = Tl::BN, BM = Tl::BM, THREADS = Tl::THREADS, WROWS = 16 * MI;
  constexpr int LDA = LDX_FP, LDE = lde_fp<XT, BN>();
  constexpr int EPC = 16 / (int)sizeof(XT);   // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  XT* As = reinterpret_cast<XT*>(smem);              // [STAGES][BM][LDA]
  XT* Bs = As + (size_t)STAGES * BM * LDA;           // [STAGES][KS][LDE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, c4 = lane & 3;
  const int tiles = (a.bn + BN - 1) / BN;
  const int j = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * BN;   // column inside output block j
  const int row0 = blockIdx.y * BM;
  const size_t wcol0 = (size_t)__ldg(a.cb + j) * a.bn + c0;
  const int ncol = min(BN, a.bn - c0);
  // split-K (few output tiles): this block contracts rows [kbeg, kend)
  const int nsplit = gridDim.z;
  const int kbeg = nsplit > 1 ? blockIdx.z * a.split_rows : 0;
  const int kend = nsplit > 1 ? min(a.m, kbeg + a.split_rows) : a.m;
  const int kt0 = kbeg / KS, nk = (kend + KS - 1) / KS - kt0;   // steps kt0 .. kt0 + nk
  const XT* x = static_cast<const XT*>(a.x);
  const XT* E = static_cast<const XT*>(a.e);

  auto load_a = [&](int slot, int kt) {
    XT* dst = As + (size_t)slot * BM * LDA;
    const int k0 = kt * KS;
    if (a.vec_a) {
      constexpr int CH = KS / EPC;
      for (int idx = tid; idx < BM * CH; idx += THREADS) {
        const int r = idx / CH, kk = (idx % CH) * EPC, t = row0 + r, k = k0 + kk;
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
  auto load_b = [&](int slot, int kt) {
    XT* dst = Bs + (size_t)slot * KS * LDE;
    const int k0 = kt * KS;
    if (a.vec_b) {
      constexpr int CH = BN / EPC;
      for (int idx = tid; idx < KS * CH; idx += THREADS) {
        const int r = idx / CH, c = (idx % CH) * EPC, k = k0 + r;
        const bool ok = k < a.m && c < ncol;
        cp_async16(dst + r * LDE + c, ok ? E + (size_t)k * a.n + wcol0 + c : E, ok);
      }
    } else {
      for (int idx = tid; idx < KS * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN, k = k0 + r;
        dst[r * LDE + c] = (k < a.m && c < ncol) ? E[(size_t)k * a.n + wcol0 + c]
                                                 : from_f32<XT>(0.f);
      }
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;

  auto compute = [&](int slot, int kt) {
    const XT* A = As + (size_t)slot * BM * LDA;
    const XT* Bt = Bs + (size_t)slot * KS * LDE + wn * 32 + 4 * g;   // this thread's 4 columns
    if constexpr (sizeof(XT) == 4) {
#pragma unroll
      for (int k8 = 0; k8 < KS; k8 += 8) {
        if (kt * KS + k8 >= kend) break;
        // k slot c4: row 2 c4 of the step, slot c4 + 4: row 2 c4 + 1
        const float4 e0 = *reinterpret_cast<const float4*>(Bt + (k8 + 2 * c4) * LDE);
        const float4 e1 = *reinterpret_cast<const float4*>(Bt + (k8 + 2 * c4 + 1) * LDE);
        const float ev[2][4] = {{e0.x, e0.y, e0.z, e0.w}, {e1.x, e1.y, e1.z, e1.w}};
        uint32_t bh[4][2], bl[4][2], ah[MI][4], al[MI][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) split_tf32(ev[h][jj], bh[jj][h], bl[jj][h]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float* ar = reinterpret_cast<const float*>(A)
                            + (wm * WROWS + 16 * i + g) * LDA + k8 + 2 * c4;
          const float2 u = *reinterpret_cast<const float2*>(ar);            // row g
          const float2 v = *reinterpret_cast<const float2*>(ar + 8 * LDA);  // row g + 8
          split_tf32(u.x, ah[i][0], al[i][0]);
          split_tf32(v.x, ah[i][1], al[i][1]);
          split_tf32(u.y, ah[i][2], al[i][2]);
          split_tf32(v.y, ah[i][3], al[i][3]);
        }
        // one product at a time over all MI x 4 accumulators, so that no
        // mma waits on the one before it (mma asm is issued in this order)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_1688_tf32(acc[i][jj], al[i], bh[jj][0], bh[jj][1]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_1688_tf32(acc[i][jj], ah[i], bl[jj][0], bl[jj][1]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_1688_tf32(acc[i][jj], ah[i], bh[jj][0], bh[jj][1]);
      }
    } else {
#pragma unroll
      for (int s16 = 0; s16 < KS; s16 += 16) {
        if (kt * KS + s16 >= kend) break;
        // rows 2 c4, 2 c4 + 1, 2 c4 + 8, 2 c4 + 9 of the step, 4 columns each
        const XT* bp = Bt + (s16 + 2 * c4) * LDE;
        const uint2 r0 = *reinterpret_cast<const uint2*>(bp);
        const uint2 r1 = *reinterpret_cast<const uint2*>(bp + LDE);
        const uint2 r8 = *reinterpret_cast<const uint2*>(bp + 8 * LDE);
        const uint2 r9 = *reinterpret_cast<const uint2*>(bp + 9 * LDE);
        // n8 tile jj: column 4g + jj, its k pair low then high
        const uint32_t b[4][2] = {
            {__byte_perm(r0.x, r1.x, 0x5410u), __byte_perm(r8.x, r9.x, 0x5410u)},
            {__byte_perm(r0.x, r1.x, 0x7632u), __byte_perm(r8.x, r9.x, 0x7632u)},
            {__byte_perm(r0.y, r1.y, 0x5410u), __byte_perm(r8.y, r9.y, 0x5410u)},
            {__byte_perm(r0.y, r1.y, 0x7632u), __byte_perm(r8.y, r9.y, 0x7632u)}};
        const int arow = wm * WROWS + (lane & 15), acol = s16 + (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, A + (arow + 16 * i) * LDA + acol);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_16816(acc[i][jj], af, b[jj][0], b[jj][1]);
        }
      }
    }
  };

  // the ring of epitome_mma.cuh's kDirect mode: STAGES - 1 stages in flight
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_a(s, kt0 + s);
      load_b(s, kt0 + s);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();   // step i has landed
    __syncthreads();               // and every thread is done with step i - 1's slot
    const int nxt = i + STAGES - 1;
    if (nxt < nk) {
      load_a(nxt % STAGES, kt0 + nxt);
      load_b(nxt % STAGES, kt0 + nxt);
    }
    cp_async_commit();
    compute(i % STAGES, kt0 + i);
  }
  store_tile<XT, WN, MI>(a, acc, row0, (size_t)j * a.bn + c0, ncol);
}

template <typename XT, int WN, int MI>
inline int launch_fp_t(const Args& a, cudaStream_t stream) {
  static bool ready = false;
  return launch_tile<Tile<WN, MI>>(fp_mma_kernel<XT, WN, MI>, fp_smem_bytes<XT, WN, MI>(),
                                   ready, a, stream);
}

// Kernel #3 at any T (a.e: E (m, n) in XT); split_rows as for launch_mma.
template <typename XT>
inline int launch_fp_mma(Args a, void* stream) {
  if (a.T == 0 || a.gn == 0) return 0;
  if (!take_splits(a)) return static_cast<int>(cudaErrorInvalidValue);
  set_vec<XT, XT>(a, a.e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.bn >= 128 ? launch_fp_t<XT, 4, 4>(a, st) : launch_fp_t<XT, 2, 2>(a, st);
}

}  // namespace
}  // namespace epim_mma
