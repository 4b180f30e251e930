// Chunked RWKV6 (Finch) WKV with data-dependent decay and a carried state,
// its chunk products on the tensor cores (mma.sync m16n8k8, 3xTF32).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py, wkv6_chunked (its
// _kernel), and computes what the LM's prefill computes in plain jnp
// (src/repro/models/ssm.py, rwkv_chunked).  Per (batch, head), with a K x K
// float32 state S carried across chunks of L tokens, and per chunk
//   cs      = cumsum(logw) over the chunk, cs_prev = cs - logw  (<= 0)
//   o_t     = (r_t * exp(cs_prev_t)) @ S                          inter-chunk
//           + sum_{i<t} [sum_k r_tk exp(min(cs_prev_tk - cs_ik, 0)) k_ik] v_i
//           + (sum_k r_tk u_k k_tk) v_t                           u bonus
//   S'      = diag(exp(cs_L)) S + sum_i (k_i * exp(cs_L - cs_i))^T v_i
// With a zero initial state this is wkv6_chunked; with h0 it is
// rwkv_chunked, whose final state comes back in hT.
//
// Layout: r, k, v are (B, S, H, K), float32 or bfloat16 (one dtype: the
// LM's projections come out in bf16 and are read as they are); logw and o
// are (B, S, H, K) float32, the model's own layout; u is (H, K); h0 and hT
// are (B, H, K, K) float32.  Positions past S count as r = k = v = 0 and
// logw = 0, exactly the zero padding of the reference, so the last chunk
// may be ragged.
//
// Design.  One block of 8 warps per (batch, head) walks its chunks in
// order, a loop that replaces the TPU grid's sequential chunk axis and its
// VMEM state.  (Splitting a head's value columns over blocks, each block
// recomputing the cumsum and the scores, measured slower at rwkv6-7b's
// shape: PERF.md.)  A chunk is staged by cp.async into a 64-token tile in
// shared memory (rows past L or S zero), its cumsum taken one thread per
// channel in time order as the reference sums it, the u bonus two threads
// per token.  Then two
// warps own each 16-token sub-chunk sb, one per half of the value columns:
// warp w < 4 takes sub-chunk w, warp 7 - w sub-chunk w's other half, so
// each scheduler (warps w and w + 4) holds sub-chunks w and 3 - w, whose
// work grows with their place in the chunk.  Each warp computes, for its
// 16 tokens and its half of the columns:
//   scores   sc_ti, i < t, shared with the partner through shared memory
//            as A fragments (each computes half of the tiles).  Against
//            earlier sub-chunks (i < 16 sb) the decay factors through
//            c = cs_{16sb-1}, the cumsum just before the sub-chunk:
//            exp(cs_prev_t - c) exp(c - cs_i), both exponents <= 0, so
//            (r * exp(min(cs_prev - c, 0))) @ (k * exp(c - cs))^T is an mma.
//            Inside the sub-chunk, tokens 8..15 against 0..7 factor the same
//            way through cs at token 7 (an mma whose top 8 rows are zero), and
//            the two 8 x 8 diagonal blocks take their exponents exactly,
//            clamped at 0 as the reference clamps them, 28 pairs per warp.
//            Only strictly causal blocks are factored, so no factor sees a
//            positive exponent (exp(+) times a masked 0 would be NaN); a
//            factor that underflows (log w = -20) drops a term below 1e-38.
//   outputs  (r * exp(cs_prev)) @ S, then scores @ v (k slots c4 and c4 + 4
//            of a step take tokens 2 c4 and 2 c4 + 1, so a C fragment of the
//            scores is an A fragment, and v is read to match), then the
//            bonus, all in one float32 accumulator.
//   state    S diag(exp(cs_L)) + (k * exp(cs_L - cs))^T @ v for channels
//            16 sb .. 16 sb + 15, written back to shared memory after a
//            barrier.
// Each operand splits at fragment load into hi and lo, TF32 by truncation,
// and lo hi, hi lo and hi hi go into the accumulator (3xTF32, as kernel #3's
// float32 entry): one TF32 pass misses the 1e-3 gate in each of the four
// products (tests/mma_models.py models both).  A bf16 value is
// exact in TF32, so with bf16 v the two products on v take two passes.  Row
// pitches (r, k and v: fp32 68, bf16 72 elements; S 72) keep the fragment
// loads free of bank conflicts.  Exponentials are __expf (dexp).
//
// Bound on an H100 at the LM's prefill shape (4 x 256 tokens, 64 heads of
// 64, bf16 r, k, v): 67 MB of inputs and outputs, 0.020 ms at 3.35 TB/s; the
// four chunk products, 1.6 GFLOP, 0.0097 ms as 3xTF32 at 495 TFLOP/s; the
// exponentials and the rest, 0.46 GFLOP, 0.0068 ms at the fp32 rate.  Bytes
// bound it: every intermediate (cumsum, scores, decayed operands, state)
// stays on chip and each input is read once.  What holds the kernel above
// that is latency: 256 blocks of 8 warps, two blocks an SM, each chunk a
// chain of barriers (stage, cumsum, products, state), and a chunk's staging
// waits on memory with nothing of the block to overlap it.
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SUBS = 4;          // sub-chunks of 16 tokens in a 64-token tile
constexpr int WARPS = 2 * SUBS;  // two per sub-chunk, one per half of the value columns
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 64;         // tokens of a chunk's tile, and channels
constexpr int MAX_K = 64;
constexpr int MAX_L = 64;
constexpr int PF = 68;           // float32 row pitch of the cumsum (4 mod 32 words)
constexpr int NT = TILE / 16;    // n8 tiles of a warp's half of the value columns
constexpr int MAX_DEVICES = 64;

typedef __nv_bfloat16 bf16;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;
  const float* h0;   // may be null: a zero initial state
  float* o;
  float* hT;
  int B, S, H, K, L;
  int vec;           // 16-byte staging and float2 stores (K % 8 == 0, aligned)
};

template <typename T>
struct Shape {
  static constexpr int PR = sizeof(T) == 4 ? 68 : 72;            // r, k
  static constexpr int PV = TILE + (sizeof(T) == 4 ? 4 : 8);      // v
  static constexpr int PS = TILE + 8;                             // state
  __host__ __device__ static constexpr size_t bytes() {
    return (size_t)TILE * (2 * PR + PV) * sizeof(T)
           + (size_t)TILE * (2 * PF + PS) * sizeof(float)
           + (size_t)(SUBS * 8 * 32 * 4 + 2 * TILE + SUBS * 128) * sizeof(float);
  }
};

template <typename T>
struct Smem {
  T* R;          // (64, PR) r
  T* K;          // (64, PR) k
  T* V;          // (64, PV) v
  float* CP;     // (64, PF) logw, then cs_prev = cs - logw
  float* CS;     // (64, PF) inclusive cumsum
  float* S;      // (64, PS) the state
  float* SC;     // (4, 8, 32, 4) scores: sub-chunk, n8 tile, lane, A fragment
  float* U;      // (64) u of this head
  float* BN;     // (64) u bonus per token
  float* DG;     // (4, 2, 64) exact diagonal scores, two 8 x 8 blocks per sub-chunk
};

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float (&x)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(q.x << 16); x[1] = __uint_as_float(q.x & 0xffff0000u);
  x[2] = __uint_as_float(q.y << 16); x[3] = __uint_as_float(q.y & 0xffff0000u);
}

// exp(x) for the kernel's exponents, all <= 0: ex2.approx(x log2 e), two
// instructions where the accurate expf takes eight; within 3e-6 relative
// (the product x log2 e rounds to 2^-24 of it) down to x = -87, and 0 below,
// where the term it scales is below 1e-38 anyway.  The exponentials are the
// larger part of the kernel's instructions.
__device__ __forceinline__ float dexp(float x) { return __expf(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the two warps of sub-chunk sb meet here (barrier 1 + sb, 64 threads)
__device__ __forceinline__ void pair_sync(int sb) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + sb), "n"(64) : "memory");
}

// v = hi + lo to about 2^-20 |v|, both TF32 (float32 bit patterns whose
// low 13 bits are 0), by truncation: two bitwise ands and a subtraction at
// the full ALU rate, where cvt.rna.tf32.f32 is a conversion at a quarter of
// it and the kernel splits some 20 operands a lane per k step; v - hi is
// exact in float32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}
// B operand pair (k slots c4, c4 + 4) as hi and lo; a bf16 value is exact
// in TF32, its lo is 0 and its product is skipped
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&h)[2], uint32_t (&l)[2]) {
  split_tf32(b0, h[0], l[0]);
  split_tf32(b1, h[1], l[1]);
}
__device__ __forceinline__ void split_b(bf16 b0, bf16 b1, uint32_t (&h)[2], uint32_t (&l)[2]) {
  h[0] = __float_as_uint(tof(b0));
  h[1] = __float_as_uint(tof(b1));
  l[0] = l[1] = 0u;
}
// d += a . b, TF32 inputs, float32 sums; not volatile, so the compiler may
// interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32 over N accumulators sharing one A: a_lo b_hi, a_hi b_lo, a_hi b_hi,
// each pass over all N before the next, so that no mma waits on the one
// before it; B_EXACT skips a_hi b_lo (bf16 b).  No guards: a conditional
// mma.sync costs a WARPSYNC.
template <int N, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[N][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], al, bh[n]);
  if constexpr (!B_EXACT) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bh[n]);
}
__device__ __forceinline__ void split_a(float x0, float x1, float x2, float x3,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(x0, ah[0], al[0]);
  split_tf32(x1, ah[1], al[1]);
  split_tf32(x2, ah[2], al[2]);
  split_tf32(x3, ah[3], al[3]);
}

// Stage chunk c0 of this block's (batch, head): r, k, v and logw, rows past
// L or S as zeros.  Channels past K stay as the kernel zeroed them.
template <typename T>
__device__ __forceinline__ void stage(const Smem<T>& s, const Args& a, int c0, size_t base,
                                      size_t ts) {
  using Sh = Shape<T>;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, K = a.K;
  float* LW = s.CP;
  if (a.vec) {
    constexpr int EPC = 16 / (int)sizeof(T);
    const int kch = K / EPC, wch = K / 4;
    for (int idx = tid; idx < TILE * kch; idx += THREADS) {
      const int t = idx / kch, c = (idx % kch) * EPC, sp = c0 + t;
      const bool ok = t < a.L && sp < a.S;
      const size_t off = base + (size_t)sp * ts + c;
      cp_async16(s.R + t * Sh::PR + c, ok ? r + off : r, ok);
      cp_async16(s.K + t * Sh::PR + c, ok ? k + off : k, ok);
      cp_async16(s.V + t * Sh::PV + c, ok ? v + off : v, ok);
    }
    for (int idx = tid; idx < TILE * wch; idx += THREADS) {
      const int t = idx / wch, c = (idx % wch) * 4, sp = c0 + t;
      const bool ok = t < a.L && sp < a.S;
      cp_async16(LW + t * PF + c, ok ? a.lw + base + (size_t)sp * ts + c : a.lw, ok);
    }
    cp_async_wait_all();
  } else {
    for (int idx = tid; idx < TILE * K; idx += THREADS) {
      const int t = idx / K, c = idx % K, sp = c0 + t;
      const bool ok = t < a.L && sp < a.S;
      const size_t off = base + (size_t)sp * ts + c;
      s.R[t * Sh::PR + c] = ok ? r[off] : zero_of<T>();
      s.K[t * Sh::PR + c] = ok ? k[off] : zero_of<T>();
      s.V[t * Sh::PV + c] = ok ? v[off] : zero_of<T>();
      LW[t * PF + c] = ok ? a.lw[off] : 0.f;
    }
  }
}

// Scores of sub-chunk sb against earlier sub-chunks, the tiles j = h, h + 2,
// .. < 2 sb of warp half h: through c = cs just before the sub-chunk,
//   (r * exp(min(cs_prev - c, 0))) @ (k * exp(c - cs))^T
// SB a template parameter, so that the tiles' accumulators sit in registers
// with no guards around the mma (a guarded mma.sync costs a WARPSYNC).
template <int SB, typename T>
__device__ __forceinline__ void scores_below(const Smem<T>& s, int h, int lane, int nkc,
                                             float (&sc)[SB][4]) {
  using Sh = Shape<T>;
  constexpr int PR = Sh::PR, R0 = 16 * SB;
  const int g = lane >> 2, c4 = lane & 3;
  const T* r0 = s.R + (R0 + g) * PR;
  const T* r1 = r0 + 8 * PR;
  const float* p0 = s.CP + (R0 + g) * PF;
  const float* p1 = p0 + 8 * PF;
  const float* cw = s.CS + (R0 - 1) * PF;
#pragma unroll
  for (int j = 0; j < SB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < nkc; ++ks) {
    const int ch = 8 * ks + c4;
    const float w0 = cw[ch], w1 = cw[ch + 4];
    uint32_t ah[4], al[4], bh[SB][2], bl[SB][2];
    split_a(tof(r0[ch]) * dexp(fminf(p0[ch] - w0, 0.f)),
            tof(r1[ch]) * dexp(fminf(p1[ch] - w0, 0.f)),
            tof(r0[ch + 4]) * dexp(fminf(p0[ch + 4] - w1, 0.f)),
            tof(r1[ch + 4]) * dexp(fminf(p1[ch + 4] - w1, 0.f)), ah, al);
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const int i = 8 * (2 * j + h) + g;
      split_b(tof(s.K[i * PR + ch]) * dexp(w0 - s.CS[i * PF + ch]),
              tof(s.K[i * PR + ch + 4]) * dexp(w1 - s.CS[i * PF + ch + 4]), bh[j], bl[j]);
    }
    mma3<SB, false>(sc, ah, al, bh, bl);
  }
}

// Warp (sb, h) of one chunk: tokens 16 sb .. 16 sb + 15 of the outputs and
// channels 16 sb .. 16 sb + 15 of the state, both at value columns
// 32 h .. 32 h + 31; its partner (sb, 1 - h) shares the scores.  Returns
// the new state rows in st.
template <typename T>
__device__ __forceinline__ void chunk_warp(const Smem<T>& s, const Args& a, int sb, int h,
                                           int lane, int nkc, int nkt, int c0, size_t base,
                                           size_t ts, float (&st)[NT][4]) {
  using Sh = Shape<T>;
  constexpr int PR = Sh::PR, PV = Sh::PV, PS = Sh::PS;
  constexpr bool VX = sizeof(T) == 2;   // v exact in TF32
  const int R0 = 16 * sb, g = lane >> 2, c4 = lane & 3, ch0 = h * (TILE / 2);
  const T* r0 = s.R + (R0 + g) * PR;
  const T* r1 = r0 + 8 * PR;
  const float* p0 = s.CP + (R0 + g) * PF;    // cs_prev of tokens R0 + g, + 8
  const float* p1 = p0 + 8 * PF;
  float4* tiles = reinterpret_cast<float4*>(s.SC) + sb * 8 * 32 + lane;   // [j][lane]

  // -- scores against earlier sub-chunks: this half's tiles -------------------------
  switch (sb) {
    case 1: { float sc[1][4]; scores_below<1, T>(s, h, lane, nkc, sc);
              tiles[h * 32] = make_float4(sc[0][0], sc[0][2], sc[0][1], sc[0][3]); break; }
    case 2: { float sc[2][4]; scores_below<2, T>(s, h, lane, nkc, sc);
#pragma unroll
              for (int j = 0; j < 2; ++j)
                tiles[(2 * j + h) * 32] = make_float4(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
              break; }
    case 3: { float sc[3][4]; scores_below<3, T>(s, h, lane, nkc, sc);
#pragma unroll
              for (int j = 0; j < 3; ++j)
                tiles[(2 * j + h) * 32] = make_float4(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
              break; }
    default: break;
  }
  // -- the sub-chunk's own 16 x 16: diagonal block h exactly (28 pairs over
  //    lanes 0..27), and in half 0 tokens 8..15 against 0..7 through cs at 7 --------
  {
    float* dg = s.DG + sb * 128 + h * 64;
    if (lane < 28) {
      int i = lane, t = 1;
      while (i >= t) { i -= t; ++t; }
      const int tt = R0 + 8 * h + t, ii = R0 + 8 * h + i;
      const int kc4 = (a.K + 3) & ~3;
      float acc = 0.f;
#pragma unroll 2
      for (int c = 0; c < kc4; c += 4) {
        float rv[4], kv[4], pv[4], cv[4];
        ld4(s.R + tt * PR + c, rv);
        ld4(s.K + ii * PR + c, kv);
        ld4(s.CP + tt * PF + c, pv);
        ld4(s.CS + ii * PF + c, cv);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc += rv[e] * dexp(fminf(pv[e] - cv[e], 0.f)) * kv[e];
      }
      dg[t * 8 + i] = acc;
    }
    float inner[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    if (h == 0) {
      const float* cq = s.CS + (R0 + 7) * PF;
      const int i = R0 + g;
#pragma unroll 1
      for (int ks = 0; ks < nkc; ++ks) {
        const int ch = 8 * ks + c4;
        const float q0 = cq[ch], q1 = cq[ch + 4];
        uint32_t ah[4], al[4], bh[1][2], bl[1][2];
        split_a(0.f, tof(r1[ch]) * dexp(fminf(p1[ch] - q0, 0.f)),
                0.f, tof(r1[ch + 4]) * dexp(fminf(p1[ch + 4] - q1, 0.f)), ah, al);
        split_b(tof(s.K[i * PR + ch]) * dexp(q0 - s.CS[i * PF + ch]),
                tof(s.K[i * PR + ch + 4]) * dexp(q1 - s.CS[i * PF + ch + 4]), bh[0], bl[0]);
        mma3<1, false>(inner, ah, al, bh, bl);
      }
    }
    __syncwarp();
    // tile 2 sb + h: rows g (block 0's, half 0) or g + 8 (block 1's, half 1)
    const int e0 = 2 * c4, e1 = e0 + 1;
    const float d0 = e0 < g ? dg[g * 8 + e0] : 0.f, d1 = e1 < g ? dg[g * 8 + e1] : 0.f;
    tiles[(2 * sb + h) * 32] = h == 0 ? make_float4(d0, inner[0][2], d1, inner[0][3])
                                      : make_float4(0.f, d0, 0.f, d1);
  }

  // -- inter-chunk: (r * exp(cs_prev)) @ S ----------------------------------------
  float oc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oc[n][e] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < nkc; ++ks) {
    const int ch = 8 * ks + c4;
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    split_a(tof(r0[ch]) * dexp(p0[ch]), tof(r1[ch]) * dexp(p1[ch]),
            tof(r0[ch + 4]) * dexp(p0[ch + 4]), tof(r1[ch + 4]) * dexp(p1[ch + 4]), ah, al);
    const float* s0 = s.S + ch * PS + ch0 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) split_b(s0[8 * n], s0[4 * PS + 8 * n], bh[n], bl[n]);
    mma3<NT, false>(oc, ah, al, bh, bl);
  }
  pair_sync(sb);   // the partner's tiles are in shared memory

  // -- intra-chunk: scores @ v, tile j's C fragment as a k step's A fragment -------
  const int nj = 2 * sb + 2;
#pragma unroll 1
  for (int j = 0; j < nj; ++j) {
    const float4 f = tiles[j * 32];
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    split_a(f.x, f.y, f.z, f.w, ah, al);
    const T* v0 = s.V + (8 * j + 2 * c4) * PV + ch0 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) split_b(v0[8 * n], v0[PV + 8 * n], bh[n], bl[n]);
    mma3<NT, VX>(oc, ah, al, bh, bl);
  }
  // -- the bonus, and the store -------------------------------------------------------
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int t = R0 + g + 8 * q, sp = c0 + t;
    const float bn = s.BN[t];
    const T* vr = s.V + t * PV + ch0 + 2 * c4;
    const bool keep = t < a.L && sp < a.S;
    float* orow = a.o + base + (size_t)sp * ts + ch0 + 2 * c4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float y0 = oc[n][2 * q] + bn * tof(vr[8 * n]);
      const float y1 = oc[n][2 * q + 1] + bn * tof(vr[8 * n + 1]);
      const int col = ch0 + 8 * n + 2 * c4;
      if (!keep || col >= a.K) continue;
      if (a.vec) {
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(y0, y1);
      } else {
        orow[8 * n] = y0;
        if (col + 1 < a.K) orow[8 * n + 1] = y1;
      }
    }
  }

  // -- the state's channels 16 sb + g, + 8:
  //    S diag(exp(cs_L)) + (k * exp(cs_L - cs))^T @ v ----------------------------------
  const int cg = R0 + g, cg8 = cg + 8;
  const float* csL = s.CS + (TILE - 1) * PF;   // past L, logw = 0: cs of token L - 1
  const float l0 = csL[cg], l1 = csL[cg8];
  const float e0 = dexp(l0), e1 = dexp(l1);
  const float* S0 = s.S + cg * PS + ch0 + 2 * c4;
  const float* S1 = S0 + 8 * PS;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 x0 = *reinterpret_cast<const float2*>(S0 + 8 * n);
    const float2 x1 = *reinterpret_cast<const float2*>(S1 + 8 * n);
    st[n][0] = x0.x * e0; st[n][1] = x0.y * e0;
    st[n][2] = x1.x * e1; st[n][3] = x1.y * e1;
  }
#pragma unroll 2
  for (int ks = 0; ks < nkt; ++ks) {
    const int i0 = 8 * ks + 2 * c4, i1 = i0 + 1;   // k slots c4, c4 + 4
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    split_a(tof(s.K[i0 * PR + cg]) * dexp(l0 - s.CS[i0 * PF + cg]),
            tof(s.K[i0 * PR + cg8]) * dexp(l1 - s.CS[i0 * PF + cg8]),
            tof(s.K[i1 * PR + cg]) * dexp(l0 - s.CS[i1 * PF + cg]),
            tof(s.K[i1 * PR + cg8]) * dexp(l1 - s.CS[i1 * PF + cg8]), ah, al);
    const T* v0 = s.V + i0 * PV + ch0 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) split_b(v0[8 * n], v0[PV + 8 * n], bh[n], bl[n]);
    mma3<NT, VX>(st, ah, al, bh, bl);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) wkv6_kernel(Args a) {
  using Sh = Shape<T>;
  constexpr int PR = Sh::PR, PV = Sh::PV, PS = Sh::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> s;
  s.R = reinterpret_cast<T*>(smem);
  s.K = s.R + TILE * PR;
  s.V = s.K + TILE * PR;
  s.CP = reinterpret_cast<float*>(s.V + TILE * PV);
  s.CS = s.CP + TILE * PF;
  s.S = s.CS + TILE * PF;
  s.SC = s.S + TILE * PS;
  s.U = s.SC + SUBS * 8 * 32 * 4;
  s.BN = s.U + TILE;
  s.DG = s.BN + TILE;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, c4 = lane & 3;
  // warp w < 4 takes sub-chunk w, value half 0; warp 7 - w sub-chunk w, half
  // 1: each of the four schedulers (warp w and w + 4) gets sub-chunks w and
  // 3 - w, whose work depends on their place in the chunk
  const int sb = w < SUBS ? w : WARPS - 1 - w, h = w >= SUBS;
  const int K = a.K, L = a.L;
  const int bh = blockIdx.x, b = bh / a.H, hd = bh % a.H;
  const size_t ts = (size_t)a.H * K;                  // one time step
  const size_t base = (size_t)b * a.S * ts + (size_t)hd * K;
  const size_t sbase = (size_t)bh * K * K;
  const int nkc = (K + 7) / 8, nkt = (L + 7) / 8;

  // channels and value columns past K stay zero throughout
  for (int i = tid; i < (int)(Sh::bytes() / 16); i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < K * K; i += THREADS) {
    const int c = i / K, n = i % K;
    s.S[c * PS + n] = a.h0 ? a.h0[sbase + i] : 0.f;
  }
  for (int i = tid; i < K; i += THREADS) s.U[i] = a.u[(size_t)hd * K + i];

  for (int c0 = 0; c0 < a.S; c0 += L) {
    stage<T>(s, a, c0, base, ts);
    __syncthreads();
    if (tid < TILE) {
      // cumsum over the chunk, in time order, and cs_prev = cs - logw
      float* cp = s.CP + tid;
      float* cs = s.CS + tid;
      float acc = 0.f;
#pragma unroll
      for (int t0 = 0; t0 < TILE; t0 += 16) {
        float x[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) x[t] = cp[(t0 + t) * PF];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          acc += x[t];
          cs[(t0 + t) * PF] = acc;
          cp[(t0 + t) * PF] = acc - x[t];
        }
      }
    } else if (tid < 3 * TILE) {
      // the u bonus of token t, two threads of neighbouring lanes each
      // summing every other channel
      const int t = (tid - TILE) >> 1, half = tid & 1;
      const T* rr = s.R + t * PR;
      const T* kr = s.K + t * PR;
      float acc = 0.f;
#pragma unroll 4
      for (int c = half; c < K; c += 2) acc += tof(rr[c]) * s.U[c] * tof(kr[c]);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (!half) s.BN[t] = acc;
    }
    __syncthreads();
    float st[NT][4];
    chunk_warp<T>(s, a, sb, h, lane, nkc, nkt, c0, base, ts, st);
    __syncthreads();   // every warp is done with this chunk's tiles and S
    float* S0 = s.S + (16 * sb + g) * PS + h * (TILE / 2) + 2 * c4;
    float* S1 = S0 + 8 * PS;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(S0 + 8 * n) = make_float2(st[n][0], st[n][1]);
      *reinterpret_cast<float2*>(S1 + 8 * n) = make_float2(st[n][2], st[n][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < K * K; i += THREADS) {
    const int c = i / K, n = i % K;
    a.hT[sbase + i] = s.S[c * PS + n];
  }
}

// Above 48 KB a block's shared memory must be asked for, and the carveout
// set to shared memory so that two blocks fit an SM: once per device and
// dtype, not at every launch.
template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {};
  const size_t bytes = Shape<T>::bytes();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const long long blocks = (long long)a.B * a.H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  wkv6_kernel<T><<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// r, k, v float32 (bf16 = 0) or bfloat16 (bf16 = 1).  Launches on the
// caller's stream and returns cudaGetLastError(), so a launch the card
// refuses is reported to the caller right away.
extern "C" int wkv6_chunked_launch(const void* r, const void* k, const void* v,
                                   const void* lw, const void* u, const void* h0,
                                   void* o, void* hT, int B, int S, int H, int K,
                                   int L, int bf16_in, void* stream) {
  if (K < 1 || K > MAX_K || L < 1 || L > MAX_L || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  Args a;
  a.r = r; a.k = k; a.v = v;
  a.lw = static_cast<const float*>(lw);
  a.u = static_cast<const float*>(u);
  a.h0 = static_cast<const float*>(h0);
  a.o = static_cast<float*>(o);
  a.hT = static_cast<float*>(hT);
  a.B = B; a.S = S; a.H = H; a.K = K; a.L = L;
  a.vec = K % 8 == 0 && aligned(r, 16) && aligned(k, 16) && aligned(v, 16) &&
          aligned(lw, 16) && aligned(o, 8);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_in ? launch<bf16>(a, st) : launch<float>(a, st);
}
