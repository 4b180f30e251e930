// The gradient of the RWKV6 (Finch) WKV recurrence with a carried state:
// the backward of kernel #4 (csrc/wkv6.cu), which the LM's training needs,
// its chunk products on the tensor cores (mma.sync m16n8k8, 3xTF32).
//
// The TPU package has no backward kernel: its LM trains through plain jnp
// (src/repro/models/ssm.py, rwkv_chunked), whose gradient XLA derives.  Here
// the forward is kernel #4, so its gradient is a kernel too.  It computes
// the gradient of the exact recurrence, the function of kernels/ref.py,
// wkv6_chunked_bwd_ref: per (batch, head), with S_t = diag(w_t) S_{t-1} +
// k_t^T v_t and o_t = r_t (S_{t-1} + diag(u) k_t^T v_t), given do and dhT,
// the gradients dr, dk, dv, dlogw, du and dh0.
//
// The chunked form.  Per chunk of L = 64 tokens from its start state S0,
// with cs the cumsum of logw over the chunk, cp_t = cs_{t-1} (0 at t = 0),
// csL = cs at its last token, the forward is
//   o_t = (r_t e^{cp_t}) S0 + sum_{i<t} A_ti v_i + (r_t . u k_t) v_t,
//   A_ti = sum_k r_tk k_ik e^{cp_tk - cs_ik},
//   S_L = diag(e^{csL}) S0 + sum_i (k_i e^{csL - cs_i})^T v_i,
// and, given dS (the gradient of S_L) and do, its gradient is
//   dA   = do v^T, strictly causal;       dv = A^T do + (k e^{csL - cs}) dS + (r.u k) do
//   dr_t = e^{cp_t} (do_t S0^T) + sum_{i<t} dA_ti k_i e^{cp_t - cs_i} + u k_t (do_t . v_t)
//   dk_i = sum_{t>i} dA_ti r_t e^{cp_t - cs_i} + e^{csL - cs_i} (v_i dS^T) + r_i u (do_i . v_i)
//   dS0  = diag(e^{csL}) dS + (r e^{cp})^T do,   du += sum_t r_t k_t (do_t . v_t)
//   dlogw_s = C + sum_{t>s} P_t - sum_{t>=s} Q_t,   C = rowsum(dS * S_L),
// P_t = r_t dr_t and Q_t = k_t dk_t without their bonus terms (the paths
// through cp and cs), C the path through csL.
//
// Layout: r, k, v (B, S, H, K), float32 or bfloat16 (one dtype); logw and
// do (B, S, H, K) float32; u (H, K); h0 and dhT (B, H, K, K) float32, each
// may be null (zero).  dr, dk, dv and dlogw come out (B, S, H, K) float32
// (the wrapper casts dr, dk, dv to r's dtype), du (H, K) and dh0 (B, H, K, K)
// float32.  K <= 64.  Tokens past S count as r = k = v = do = 0, logw = 0.
//
// Design.  One block of 16 warps per (batch, head).  Sweep 1 walks the
// chunks forward and stores each chunk's start state (64 x 64 floats) in a
// scratch, B H ceil(S / 64) 16 KB, the state updated as kernel #4 updates
// it.  Sweep 2 walks them backward, carrying dS in shared memory.  A chunk
// is staged by cp.async (r, k, v, logw, do and its start state S0); the
// cumsum, dlogw's scan, C and du are taken by every thread, a thread a
// channel and part of 8 tokens (or columns), the parts added in order; the
// bonus and do . v by 8 lanes a token and a butterfly.  Warp (rb, cq) owns
// row block rb (16 tokens, or 16 channels of a state) and value or channel
// columns 16 cq .. 16 cq + 15:
//   1. scores A of its tokens against earlier blocks, (r e^{min(cp - c, 0)})
//      @ (k e^{c - cs})^T with c = cs_{R0-1} (its share of the tiles; each
//      decay taken as the operand is loaded); tokens 8..15 of its block
//      against 0..7 through cs at token 7; the two 8 x 8 diagonal blocks
//      exactly (exponents clamped at 0, a warp a pair); and dA = do v^T
//      (its share of the tiles up to the diagonal, masked), into shared
//      memory.
//   2. dv = A^T do + (k e^{csL - cs}) dS;  dr = e^{cp - c} (do (e^c S0)^T
//      + dA_{<R0} (k e^{c - cs})) with c = cs_{R0-1};  dk = e^{c' - cs}
//      (dA^T_{>R0+15} (r e^{cp - c'}) + v (e^{csL - c'} dS)^T) with c' =
//      cs_{R0+15};  the block's own pairs of dr and dk as the scores' (an
//      mma through cs at token 7, the 8 x 8 diagonal blocks exactly); dS0.
//      Every factor is e to a non-positive power, so nothing overflows at
//      log w = -20, and a factor that underflows drops a term below 1e-38.
//   3. P and Q into shared memory (over the scores), dS0 over dS; then
//      dlogw, du and C for the chunk before.
// Each operand splits into hi and lo, TF32 by truncation, and lo hi, hi lo
// and hi hi go into the float32 accumulator (3xTF32, as kernel #4); a bf16
// operand is exact in TF32 and skips its lo pass.  One TF32 pass misses
// the 1e-3 gate (tests/mma_models.py models the arithmetic).
// Every sum runs in a fixed order and du, a sum over batch, goes through a
// second kernel that adds the blocks' partial sums in batch order: no
// atomics, so the kernel repeats bit for bit.
//
// Bound (chip_smoke.py computes it at the training shape, B 8, S 256, 64
// heads of 64, bf16 r, k, v): 0.27 GB of inputs and outputs at 3.35 TB/s,
// 0.080 ms; the chunked form's ten products (the scores, dA, A^T do, dr's
// and dk's through dA, the three with S0 or dS, dS0's and sweep 1's) at 3 x
// their 8.0 GFLOP over the TF32 rate, 0.049 ms, and the rest at the fp32
// rate.  Bytes bound it.  What holds the kernel at several times that
// (PERF.md) is shared memory: every mma.sync fragment element is a 32-bit
// load, the four warps of a row block load the same A fragments, and the
// exact 8 x 8 blocks load per pair; 16 warps in one block an SM (139 KB of
// shared memory at bf16) and eight barriers a chunk leave little to overlap.
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // tokens of a chunk, and channels
constexpr int MAX_K = 64;
constexpr int SUBS = TILE / 16;   // row blocks of 16
// column groups: warp (rb, cq) owns 64 / NQ columns.  Four (16 warps)
// measured 0.61-0.62 ms a launch at the training shape where two (8 warps,
// each twice the columns) took 0.87 (bf16 r, k, v; chip_smoke.py
// --time-wkv-bwd on a copy with NQ = 2; NVIDIA H100 80GB HBM3, 700.00 W)
constexpr int NQ = 4;
constexpr int WARPS = SUBS * NQ;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = TILE / NQ / 8; // n8 tiles of a warp's columns
constexpr int PF = 68;            // float32 pitch: cumsum, do, S0 (4 mod 32 words)
constexpr int PW = 72;            // float32 pitch: dS, scores, dA (8 mod 32)
constexpr int SP = TILE * TILE;   // floats of one stored state
constexpr int MAX_DEVICES = 64;
constexpr int NP = THREADS / TILE;  // parts of the scans: a thread a channel and part
constexpr int TP = TILE / NP;       // tokens of a part
static_assert(THREADS % TILE == 0 && TILE % NP == 0 && NP <= 32, "scans: whole parts");

typedef __nv_bfloat16 bf16;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;
  const float* h0;    // may be null: a zero initial state
  const float* dO;
  const float* dhT;   // may be null: a zero final-state gradient
  float* dr;
  float* dk;
  float* dv;
  float* dlw;
  float* du_part;     // (B, H, K): each block's du, summed by du_reduce
  float* du;
  float* dh0;         // may be null: not wanted
  float* ckpt;        // (B H, ceil(S / TILE), SP): each chunk's start state
  int B, S, H, K;
  int vec;            // 16-byte staging and float2 stores (K % 8 == 0, aligned)
};

template <typename T>
struct Shape {
  static constexpr int PR = sizeof(T) == 4 ? 68 : 72;   // r, k, v
  __host__ __device__ static constexpr size_t bytes() {
    return (size_t)TILE * 3 * PR * sizeof(T)
           + ((size_t)TILE * PF * 2 + (size_t)(TILE + 1) * PF + (size_t)TILE * PW * 3
              + (size_t)(3 + 3 * NP) * TILE) * sizeof(float);
  }
};

template <typename T>
struct Smem {
  T* R;          // (64, PR) r
  T* K;          // (64, PR) k
  T* V;          // (64, PR) v
  float* DO;     // (64, PF) do
  float* CX;     // (65, PF) row 0 zero, row t + 1 cs_t: cp_t = CX[t], cs_t = CX[t + 1]
  float* S;      // (64, PF) the state: sweep 1's running state, sweep 2's S0
  float* DS;     // (64, PW) dS
  float* AS;     // (64, PW) scores A (t, i); then P
  float* DA;     // (64, PW) dA (t, i); then Q
  float* U;      // (64) u of this head
  float* BN;     // (64) bonus r . u k per token
  float* DOV;    // (64) do . v per token
  float* PT;     // (NP, 64) the scans' part totals
  float* CP;     // (2, NP, 64) parts of C of this chunk and of the one before
};

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ void ld2(const float* p, float (&x)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  x[0] = q.x; x[1] = q.y;
}
__device__ __forceinline__ void ld2(const bf16* p, float (&x)[2]) {
  const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
  x[0] = __uint_as_float(q << 16); x[1] = __uint_as_float(q & 0xffff0000u);
}

// exp(x) for the kernel's exponents, all <= 0 (as kernel #4's dexp)
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

// v = hi + lo, both TF32, by truncation (as kernel #4); v - hi is exact
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}
// d += a . b, TF32 inputs, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += A B_n over nks k8 steps, 3xTF32: fa(ks, x) gives the A fragment
// at step ks (rows g, g + 8 at k slots c4, c4 + 4), fb(ks, n, y) tile n's B
// pair (k slots c4, c4 + 4 at column g).  AX / BX: that operand is exact in
// TF32 (bf16 values), so its lo pass is skipped.  Each pass runs over all N
// before the next, so no mma waits on the one before it; no guards around
// an mma (a conditional mma.sync costs a WARPSYNC).
template <int N, bool AX, bool BX, class FA, class FB>
__device__ __forceinline__ void gemm(float (&d)[N][4], int nks, FA fa, FB fb) {
#pragma unroll 2
  for (int ks = 0; ks < nks; ++ks) {
    float x[4];
    fa(ks, x);
    uint32_t ah[4], al[4], bh[N][2], bl[N][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (AX) ah[e] = __float_as_uint(x[e]);
      else split_tf32(x[e], ah[e], al[e]);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float y[2];
      fb(ks, n, y);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (BX) bh[n][e] = __float_as_uint(y[e]);
        else split_tf32(y[e], bh[n][e], bl[n][e]);
      }
    }
    if constexpr (!AX) {
#pragma unroll
      for (int n = 0; n < N; ++n) mma_tf32(d[n], al, bh[n]);
    }
    if constexpr (!BX) {
#pragma unroll
      for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bl[n]);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[n], ah, bh[n]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
}

// Stage the chunk at token c0: k, v and logw (into CX rows 1..64), and with
// FULL also r, do and the chunk's start state S0 from the scratch.  Rows
// past S are zeros; channels past K stay as the kernel zeroed them.
template <typename T, bool FULL>
__device__ __forceinline__ void stage(const Smem<T>& s, const Args& a, int c0, size_t base,
                                      size_t ts, const float* s0) {
  constexpr int PR = Shape<T>::PR;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, K = a.K;
  float* LW = s.CX + PF;
  if (a.vec) {
    constexpr int EPC = 16 / (int)sizeof(T);
    const int kch = K / EPC, wch = K / 4;
    for (int idx = tid; idx < TILE * kch; idx += THREADS) {
      const int t = idx / kch, c = (idx % kch) * EPC, sp = c0 + t;
      const bool ok = sp < a.S;
      const size_t off = base + (size_t)sp * ts + c;
      if (FULL) cp_async16(s.R + t * PR + c, ok ? r + off : r, ok);
      cp_async16(s.K + t * PR + c, ok ? k + off : k, ok);
      cp_async16(s.V + t * PR + c, ok ? v + off : v, ok);
    }
    for (int idx = tid; idx < TILE * wch; idx += THREADS) {
      const int t = idx / wch, c = (idx % wch) * 4, sp = c0 + t;
      const bool ok = sp < a.S;
      const size_t off = base + (size_t)sp * ts + c;
      cp_async16(LW + t * PF + c, ok ? a.lw + off : a.lw, ok);
      if (FULL) cp_async16(s.DO + t * PF + c, ok ? a.dO + off : a.dO, ok);
    }
  } else {
    for (int idx = tid; idx < TILE * K; idx += THREADS) {
      const int t = idx / K, c = idx % K, sp = c0 + t;
      const bool ok = sp < a.S;
      const size_t off = base + (size_t)sp * ts + c;
      if (FULL) {
        s.R[t * PR + c] = ok ? r[off] : zero_of<T>();
        s.DO[t * PF + c] = ok ? a.dO[off] : 0.f;
      }
      s.K[t * PR + c] = ok ? k[off] : zero_of<T>();
      s.V[t * PR + c] = ok ? v[off] : zero_of<T>();
      LW[t * PF + c] = ok ? a.lw[off] : 0.f;
    }
  }
  if (FULL) {
    for (int idx = tid; idx < SP / 4; idx += THREADS) {
      const int row = idx / (TILE / 4), c = (idx % (TILE / 4)) * 4;
      cp_async16(s.S + row * PF + c, s0 + row * TILE + c, true);
    }
  }
  cp_async_wait_all();
}

// The cumsum over the chunk in place (CX row t + 1 goes from logw_t to
// cs_t), by every thread, in two steps with a barrier between them: thread
// (part p, channel) sums its TP tokens in time order (cumsum_part), then
// adds the totals of parts 0 .. p - 1 in that order (cumsum_carry)
__device__ __forceinline__ void cumsum_part(float* CX, float* PT, int tid) {
  const int ch = tid % TILE, p = tid / TILE;
  float* cs = CX + (1 + p * TP) * PF + ch;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    acc += cs[t * PF];
    cs[t * PF] = acc;
  }
  PT[p * TILE + ch] = acc;
}
__device__ __forceinline__ void cumsum_carry(float* CX, const float* PT, int tid) {
  const int ch = tid % TILE, p = tid / TILE;
  float* cs = CX + (1 + p * TP) * PF + ch;
  float off = 0.f;
  for (int q = 0; q < p; ++q) off += PT[q * TILE + ch];
  if (p) {
#pragma unroll
    for (int t = 0; t < TP; ++t) cs[t * PF] += off;
  }
}

// Two values of a C fragment's row into a (B, S, H, K) float32 output
__device__ __forceinline__ void store2(float* row, int col, float y0, float y1, const Args& a) {
  if (col >= a.K) return;
  if (a.vec) {
    *reinterpret_cast<float2*>(row + col) = make_float2(y0, y1);
  } else {
    row[col] = y0;
    if (col + 1 < a.K) row[col + 1] = y1;
  }
}

// Phase 1: scores of row block rb against earlier blocks, tiles jt = cq +
// NQ q (q < NJ, all < 2 rb): (r e^{min(cp - c, 0)}) @ (k e^{c - cs})^T,
// c = cs_{R0-1}, into AS
template <int NJ, typename T>
__device__ __forceinline__ void scores_below(const Smem<T>& s, int rb, int cq, int lane, int nkc) {
  const int R0 = 16 * rb, g = lane >> 2, c4 = lane & 3;
  constexpr int PR = Shape<T>::PR;
  const T* r0 = s.R + (R0 + g) * PR;
  const T* r1 = r0 + 8 * PR;
  const float* p0 = s.CX + (R0 + g) * PF;
  const float* p1 = p0 + 8 * PF;
  const float* cw = s.CX + R0 * PF;
  float acc[NJ][4];
  zero(acc);
  gemm<NJ, false, false>(acc, nkc,
      [&](int ks, float (&x)[4]) {
        const int ch = 8 * ks + c4;
        const float w0 = cw[ch], w1 = cw[ch + 4];
        x[0] = tof(r0[ch]) * dexp(fminf(p0[ch] - w0, 0.f));
        x[1] = tof(r1[ch]) * dexp(fminf(p1[ch] - w0, 0.f));
        x[2] = tof(r0[ch + 4]) * dexp(fminf(p0[ch + 4] - w1, 0.f));
        x[3] = tof(r1[ch + 4]) * dexp(fminf(p1[ch + 4] - w1, 0.f));
      },
      [&](int ks, int q, float (&y)[2]) {
        const int ch = 8 * ks + c4, i = 8 * (cq + NQ * q) + g;
        y[0] = tof(s.K[i * PR + ch]) * dexp(cw[ch] - s.CX[(i + 1) * PF + ch]);
        y[1] = tof(s.K[i * PR + ch + 4]) * dexp(cw[ch + 4] - s.CX[(i + 1) * PF + ch + 4]);
      });
#pragma unroll
  for (int q = 0; q < NJ; ++q) {
    const int col = 8 * (cq + NQ * q) + 2 * c4;
    *reinterpret_cast<float2*>(s.AS + (R0 + g) * PW + col) = make_float2(acc[q][0], acc[q][1]);
    *reinterpret_cast<float2*>(s.AS + (R0 + g + 8) * PW + col) = make_float2(acc[q][2], acc[q][3]);
  }
}

// Phase 1: dA = do v^T of row block rb, tiles jt = cq + NQ q (q < NJ, all
// < 2 rb + 2), zero on and above the diagonal, into DA
template <int NJ, typename T>
__device__ __forceinline__ void dA_tiles(const Smem<T>& s, int rb, int cq, int lane, int nkc) {
  constexpr int PR = Shape<T>::PR;
  const int R0 = 16 * rb, g = lane >> 2, c4 = lane & 3;
  const float* d0 = s.DO + (R0 + g) * PF;
  const float* d1 = d0 + 8 * PF;
  float acc[NJ][4];
  zero(acc);
  gemm<NJ, false, sizeof(T) == 2>(acc, nkc,
      [&](int ks, float (&x)[4]) {
        const int ch = 8 * ks + c4;
        x[0] = d0[ch]; x[1] = d1[ch]; x[2] = d0[ch + 4]; x[3] = d1[ch + 4];
      },
      [&](int ks, int q, float (&y)[2]) {
        const int ch = 8 * ks + c4, i = 8 * (cq + NQ * q) + g;
        y[0] = tof(s.V[i * PR + ch]);
        y[1] = tof(s.V[i * PR + ch + 4]);
      });
  const int t0 = R0 + g, t1 = t0 + 8;
#pragma unroll
  for (int q = 0; q < NJ; ++q) {
    const int col = 8 * (cq + NQ * q) + 2 * c4;
    *reinterpret_cast<float2*>(s.DA + t0 * PW + col) =
        make_float2(col < t0 ? acc[q][0] : 0.f, col + 1 < t0 ? acc[q][1] : 0.f);
    *reinterpret_cast<float2*>(s.DA + t1 * PW + col) =
        make_float2(col < t1 ? acc[q][2] : 0.f, col + 1 < t1 ? acc[q][3] : 0.f);
  }
}

// the number of tiles jt = cq, cq + NQ, .. below ``end``
__device__ __forceinline__ int share(int end, int cq) { return end > cq ? (end - cq + NQ - 1) / NQ : 0; }

template <typename T>
__device__ __forceinline__ void phase1(const Smem<T>& s, int rb, int cq, int lane, int nkc) {
  constexpr int PR = Shape<T>::PR;
  switch (share(2 * rb, cq)) {
    case 1: scores_below<1, T>(s, rb, cq, lane, nkc); break;
    case 2: scores_below<2, T>(s, rb, cq, lane, nkc); break;
    case 3: scores_below<3, T>(s, rb, cq, lane, nkc); break;
    default: break;
  }
  switch (share(2 * rb + 2, cq)) {
    case 1: dA_tiles<1, T>(s, rb, cq, lane, nkc); break;
    case 2: dA_tiles<2, T>(s, rb, cq, lane, nkc); break;
    case 3: dA_tiles<3, T>(s, rb, cq, lane, nkc); break;
    case 4: dA_tiles<4, T>(s, rb, cq, lane, nkc); break;
    default: break;
  }
  // the block's own 16 x 16: tokens 8..15 against 0..7 through cs at token
  // 7 (an mma whose rows 0..7 are zero), by the block's last warp, ...
  const int R0 = 16 * rb, g = lane >> 2, c4 = lane & 3;
  if (cq == NQ - 1) {
    const T* r1 = s.R + (R0 + 8 + g) * PR;
    const float* p1 = s.CX + (R0 + 8 + g) * PF;
    const float* c7 = s.CX + (R0 + 8) * PF;
    const int i = R0 + g;
    float acc[1][4];
    zero(acc);
    gemm<1, false, false>(acc, nkc,
        [&](int ks, float (&x)[4]) {
          const int ch = 8 * ks + c4;
          x[0] = x[2] = 0.f;
          x[1] = tof(r1[ch]) * dexp(fminf(p1[ch] - c7[ch], 0.f));
          x[3] = tof(r1[ch + 4]) * dexp(fminf(p1[ch + 4] - c7[ch + 4], 0.f));
        },
        [&](int ks, int, float (&y)[2]) {
          const int ch = 8 * ks + c4;
          y[0] = tof(s.K[i * PR + ch]) * dexp(c7[ch] - s.CX[(i + 1) * PF + ch]);
          y[1] = tof(s.K[i * PR + ch + 4]) * dexp(c7[ch + 4] - s.CX[(i + 1) * PF + ch + 4]);
        });
    *reinterpret_cast<float2*>(s.AS + (R0 + 8 + g) * PW + R0 + 2 * c4) =
        make_float2(acc[0][2], acc[0][3]);
  }
  // ... zeros on and above the diagonal ...
  for (int e = lane + 32 * cq; e < 256; e += 32 * NQ) {
    const int tl = e >> 4, il = e & 15;
    if (il >= tl) s.AS[(R0 + tl) * PW + R0 + il] = 0.f;
  }
  // ... and the pairs i < t of the two 8 x 8 diagonal blocks exactly
  // (exponents clamped at 0): a warp a pair, each lane two channels, summed
  // by a butterfly
  for (int p = cq; p < 56; p += NQ) {
    int i = p % 28, t = 1;
    while (i >= t) { i -= t; ++t; }
    const int o = R0 + 8 * (p / 28);
    t += o;
    i += o;
    const int c = 2 * lane;
    float rv[2], kv[2], pv[2], cv[2];
    ld2(s.R + t * PR + c, rv);
    ld2(s.K + i * PR + c, kv);
    ld2(s.CX + t * PF + c, pv);
    ld2(s.CX + (i + 1) * PF + c, cv);
    float acc = rv[0] * dexp(fminf(pv[0] - cv[0], 0.f)) * kv[0]
              + rv[1] * dexp(fminf(pv[1] - cv[1], 0.f)) * kv[1];
#pragma unroll
    for (int m = 16; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) s.AS[t * PW + i] = acc;
  }
}

// Phase 2 of warp (rb, cq): dv, dr and dk of tokens 16 rb .. 16 rb + 15 at
// columns n0 .. n0 + 8 NT - 1 into the outputs, P and Q of the same
// elements, and dS0 of channels 16 rb .. 16 rb + 15.
template <typename T>
__device__ __forceinline__ void phase2(const Smem<T>& s, const Args& a, int rb, int cq, int lane,
                                       int nkc, int c0, size_t base, size_t ts,
                                       float (&P)[NT][4], float (&Q)[NT][4],
                                       float (&ds)[NT][4]) {
  constexpr int PR = Shape<T>::PR;
  constexpr bool X = sizeof(T) == 2;    // r, k, v exact in TF32
  const int R0 = 16 * rb, g = lane >> 2, c4 = lane & 3, n0 = cq * NT * 8;
  const int t0 = R0 + g, t1 = t0 + 8;
  const float* csL = s.CX + TILE * PF;
  float acc[NT][4];

  // -- dv = A^T do (t >= R0) + (k e^{csL - cs}) dS, + bonus do ----------------
  zero(acc);
  gemm<NT, false, false>(acc, (TILE - R0) / 8,
      [&](int ks, float (&x)[4]) {
        const float* a0 = s.AS + (R0 + 8 * ks + c4) * PW + t0;
        x[0] = a0[0]; x[1] = a0[8]; x[2] = a0[4 * PW]; x[3] = a0[4 * PW + 8];
      },
      [&](int ks, int n, float (&y)[2]) {
        const float* b0 = s.DO + (R0 + 8 * ks + c4) * PF + n0 + 8 * n + g;
        y[0] = b0[0]; y[1] = b0[4 * PF];
      });
  gemm<NT, false, false>(acc, nkc,
      [&](int ks, float (&x)[4]) {
        const int ch = 8 * ks + c4;
        x[0] = tof(s.K[t0 * PR + ch]) * dexp(csL[ch] - s.CX[(t0 + 1) * PF + ch]);
        x[1] = tof(s.K[t1 * PR + ch]) * dexp(csL[ch] - s.CX[(t1 + 1) * PF + ch]);
        x[2] = tof(s.K[t0 * PR + ch + 4]) * dexp(csL[ch + 4] - s.CX[(t0 + 1) * PF + ch + 4]);
        x[3] = tof(s.K[t1 * PR + ch + 4]) * dexp(csL[ch + 4] - s.CX[(t1 + 1) * PF + ch + 4]);
      },
      [&](int ks, int n, float (&y)[2]) {
        const float* b0 = s.DS + (8 * ks + c4) * PW + n0 + 8 * n + g;
        y[0] = b0[0]; y[1] = b0[4 * PW];
      });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 8 * h;
    if (c0 + t >= a.S) continue;
    float* row = a.dv + base + (size_t)(c0 + t) * ts;
    const float bn = s.BN[t];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + 8 * n + 2 * c4;
      store2(row, col, acc[n][2 * h] + bn * s.DO[t * PF + col],
             acc[n][2 * h + 1] + bn * s.DO[t * PF + col + 1], a);
    }
  }

  // -- dr = e^{cp - c} (do (e^c S0)^T + dA_{<R0} (k e^{c - cs})), c = cs_{R0-1},
  //    + the block's own pairs exactly, + u k (do . v) ------------------------
  const float* cw = s.CX + R0 * PF;
  {
    float ec[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) ec[n] = dexp(cw[n0 + 8 * n + g]);
    zero(acc);
    gemm<NT, false, false>(acc, nkc,
        [&](int ks, float (&x)[4]) {
          const int ch = 8 * ks + c4;
          x[0] = s.DO[t0 * PF + ch]; x[1] = s.DO[t1 * PF + ch];
          x[2] = s.DO[t0 * PF + ch + 4]; x[3] = s.DO[t1 * PF + ch + 4];
        },
        [&](int ks, int n, float (&y)[2]) {
          const float* b0 = s.S + (n0 + 8 * n + g) * PF + 8 * ks + c4;
          y[0] = b0[0] * ec[n]; y[1] = b0[4] * ec[n];
        });
  }
  gemm<NT, false, false>(acc, 2 * rb,
      [&](int ks, float (&x)[4]) {
        const int i = 8 * ks + c4;
        x[0] = s.DA[t0 * PW + i]; x[1] = s.DA[t1 * PW + i];
        x[2] = s.DA[t0 * PW + i + 4]; x[3] = s.DA[t1 * PW + i + 4];
      },
      [&](int ks, int n, float (&y)[2]) {
        const int i = 8 * ks + c4, kc = n0 + 8 * n + g;
        y[0] = tof(s.K[i * PR + kc]) * dexp(cw[kc] - s.CX[(i + 1) * PF + kc]);
        y[1] = tof(s.K[(i + 4) * PR + kc]) * dexp(cw[kc] - s.CX[(i + 5) * PF + kc]);
      });
  // tokens 8..15 against 0..7 through cs at token 7 (rows 0..7 zero)
  const float* c7 = s.CX + (R0 + 8) * PF;
  float in[NT][4];
  zero(in);
  gemm<NT, false, false>(in, 1,
      [&](int, float (&x)[4]) {
        x[0] = x[2] = 0.f;
        x[1] = s.DA[t1 * PW + R0 + c4]; x[3] = s.DA[t1 * PW + R0 + c4 + 4];
      },
      [&](int, int n, float (&y)[2]) {
        const int i = R0 + c4, kc = n0 + 8 * n + g;
        y[0] = tof(s.K[i * PR + kc]) * dexp(c7[kc] - s.CX[(i + 1) * PF + kc]);
        y[1] = tof(s.K[(i + 4) * PR + kc]) * dexp(c7[kc] - s.CX[(i + 5) * PF + kc]);
      });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 8 * h, d0 = R0 + 8 * h;
    const bool keep = c0 + t < a.S;
    float* row = a.dr + base + (size_t)(c0 + t) * ts;
    const float dov = s.DOV[t];
    float da[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) da[j] = s.DA[t * PW + d0 + j];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + 8 * n + 2 * c4;
      float cp[2], ow[2] = {0.f, 0.f};
      ld2(s.CX + t * PF + col, cp);
      // the 8 x 8 diagonal block exactly, dA zero where i >= t
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = da[j];
        float kv[2], cv[2];
        ld2(s.K + (d0 + j) * PR + col, kv);
        ld2(s.CX + (d0 + j + 1) * PF + col, cv);
#pragma unroll
        for (int e = 0; e < 2; ++e) ow[e] += d * kv[e] * dexp(fminf(cp[e] - cv[e], 0.f));
      }
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = col + e;
        float nb = acc[n][2 * h + e] * dexp(fminf(cp[e] - cw[kc], 0.f));
        if (h) nb += in[n][2 + e] * dexp(fminf(cp[e] - c7[kc], 0.f));
        nb += ow[e];
        P[n][2 * h + e] = tof(s.R[t * PR + kc]) * nb;
        y[e] = nb + s.U[kc] * tof(s.K[t * PR + kc]) * dov;
      }
      if (keep) store2(row, col, y[0], y[1], a);
    }
  }

  // -- dk = e^{c' - cs} (dA^T_{>R0+15} (r e^{cp - c'}) + v (e^{csL - c'} dS)^T),
  //    c' = cs_{R0+15}, + the block's own pairs, + r u (do . v) -------------------
  const float* cq_ = s.CX + (R0 + 16) * PF;
  zero(acc);
  gemm<NT, false, false>(acc, (TILE - R0 - 16) / 8,
      [&](int ks, float (&x)[4]) {
        const float* a0 = s.DA + (R0 + 16 + 8 * ks + c4) * PW + t0;
        x[0] = a0[0]; x[1] = a0[8]; x[2] = a0[4 * PW]; x[3] = a0[4 * PW + 8];
      },
      [&](int ks, int n, float (&y)[2]) {
        const int t = R0 + 16 + 8 * ks + c4, kc = n0 + 8 * n + g;
        y[0] = tof(s.R[t * PR + kc]) * dexp(fminf(s.CX[t * PF + kc] - cq_[kc], 0.f));
        y[1] = tof(s.R[(t + 4) * PR + kc]) * dexp(fminf(s.CX[(t + 4) * PF + kc] - cq_[kc], 0.f));
      });
  {
    float ed[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) ed[n] = dexp(csL[n0 + 8 * n + g] - cq_[n0 + 8 * n + g]);
    gemm<NT, X, false>(acc, nkc,
        [&](int ks, float (&x)[4]) {
          const int ch = 8 * ks + c4;
          x[0] = tof(s.V[t0 * PR + ch]); x[1] = tof(s.V[t1 * PR + ch]);
          x[2] = tof(s.V[t0 * PR + ch + 4]); x[3] = tof(s.V[t1 * PR + ch + 4]);
        },
        [&](int ks, int n, float (&y)[2]) {
          const float* b0 = s.DS + (n0 + 8 * n + g) * PW + 8 * ks + c4;
          y[0] = b0[0] * ed[n]; y[1] = b0[4] * ed[n];
        });
  }
  // tokens 0..7 against 8..15 through cs at token 7 (rows 8..15 zero)
  zero(in);
  gemm<NT, false, false>(in, 1,
      [&](int, float (&x)[4]) {
        x[0] = s.DA[(R0 + 8 + c4) * PW + t0]; x[2] = s.DA[(R0 + 12 + c4) * PW + t0];
        x[1] = x[3] = 0.f;
      },
      [&](int, int n, float (&y)[2]) {
        const int t = R0 + 8 + c4, kc = n0 + 8 * n + g;
        y[0] = tof(s.R[t * PR + kc]) * dexp(fminf(s.CX[t * PF + kc] - c7[kc], 0.f));
        y[1] = tof(s.R[(t + 4) * PR + kc]) * dexp(fminf(s.CX[(t + 4) * PF + kc] - c7[kc], 0.f));
      });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = t0 + 8 * h, d0 = R0 + 8 * h;
    const bool keep = c0 + i < a.S;
    float* row = a.dk + base + (size_t)(c0 + i) * ts;
    const float dov = s.DOV[i];
    float da[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) da[j] = s.DA[(d0 + j) * PW + i];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + 8 * n + 2 * c4;
      float cs[2], ow[2] = {0.f, 0.f};
      ld2(s.CX + (i + 1) * PF + col, cs);
      // the 8 x 8 diagonal block exactly, dA zero where t <= i
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = da[j];
        float rv[2], pv[2];
        ld2(s.R + (d0 + j) * PR + col, rv);
        ld2(s.CX + (d0 + j) * PF + col, pv);
#pragma unroll
        for (int e = 0; e < 2; ++e) ow[e] += d * rv[e] * dexp(fminf(pv[e] - cs[e], 0.f));
      }
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = col + e;
        float nb = acc[n][2 * h + e] * dexp(cq_[kc] - cs[e]);
        if (!h) nb += in[n][e] * dexp(c7[kc] - cs[e]);
        nb += ow[e];
        Q[n][2 * h + e] = tof(s.K[i * PR + kc]) * nb;
        y[e] = nb + tof(s.R[i * PR + kc]) * s.U[kc] * dov;
      }
      if (keep) store2(row, col, y[0], y[1], a);
    }
  }

  // -- dS0 = e^{csL} dS + (r e^{cp})^T do, channels t0, t1 -----------------------
  {
    const float e0 = dexp(csL[t0]), e1 = dexp(csL[t1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + 8 * n + 2 * c4;
      ds[n][0] = e0 * s.DS[t0 * PW + col]; ds[n][1] = e0 * s.DS[t0 * PW + col + 1];
      ds[n][2] = e1 * s.DS[t1 * PW + col]; ds[n][3] = e1 * s.DS[t1 * PW + col + 1];
    }
  }
  gemm<NT, false, false>(ds, TILE / 8,
      [&](int ks, float (&x)[4]) {
        const int t = 8 * ks + c4;
        x[0] = tof(s.R[t * PR + t0]) * dexp(s.CX[t * PF + t0]);
        x[1] = tof(s.R[t * PR + t1]) * dexp(s.CX[t * PF + t1]);
        x[2] = tof(s.R[(t + 4) * PR + t0]) * dexp(s.CX[(t + 4) * PF + t0]);
        x[3] = tof(s.R[(t + 4) * PR + t1]) * dexp(s.CX[(t + 4) * PF + t1]);
      },
      [&](int ks, int n, float (&y)[2]) {
        const float* b0 = s.DO + (8 * ks + c4) * PF + n0 + 8 * n + g;
        y[0] = b0[0]; y[1] = b0[4 * PF];
      });
}

// A C fragment's rows rb, rb + 8 of columns n0.. into a (64, pitch) tile
template <int PITCH>
__device__ __forceinline__ void put(float* tile, int rb, int cq, int lane, const float (&f)[NT][4]) {
  const int g = lane >> 2, c4 = lane & 3;
  float* p0 = tile + (16 * rb + g) * PITCH + cq * NT * 8 + 2 * c4;
  float* p1 = p0 + 8 * PITCH;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(p0 + 8 * n) = make_float2(f[n][0], f[n][1]);
    *reinterpret_cast<float2*>(p1 + 8 * n) = make_float2(f[n][2], f[n][3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wkv6_bwd_kernel(const Args a) {
  using Sh = Shape<T>;
  constexpr int PR = Sh::PR;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> s;
  s.R = reinterpret_cast<T*>(smem);
  s.K = s.R + TILE * PR;
  s.V = s.K + TILE * PR;
  s.DO = reinterpret_cast<float*>(s.V + TILE * PR);
  s.CX = s.DO + TILE * PF;
  s.S = s.CX + (TILE + 1) * PF;
  s.DS = s.S + TILE * PF;
  s.AS = s.DS + TILE * PW;
  s.DA = s.AS + TILE * PW;
  s.U = s.DA + TILE * PW;
  s.BN = s.U + TILE;
  s.DOV = s.BN + TILE;
  s.PT = s.DOV + TILE;
  s.CP = s.PT + NP * TILE;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rb = w % SUBS, cq = w / SUBS;
  const int K = a.K, bh = blockIdx.x, b = bh / a.H, hd = bh % a.H;
  const size_t ts = (size_t)a.H * K;
  const size_t base = (size_t)b * a.S * ts + (size_t)hd * K;
  const size_t sbase = (size_t)bh * K * K;
  const int nkc = (K + 7) / 8, nch = (a.S + TILE - 1) / TILE;
  float* ckpt = a.ckpt + (size_t)bh * nch * SP;

  for (int i = tid; i < (int)(Sh::bytes() / 16); i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < K * K; i += THREADS) {
    const int c = i / K, n = i % K;
    s.S[c * PF + n] = a.h0 ? a.h0[sbase + i] : 0.f;
  }
  for (int i = tid; i < K; i += THREADS) s.U[i] = a.u[(size_t)hd * K + i];

  // -- sweep 1: each chunk's start state into the scratch ---------------------------
  for (int c = 0; c < nch; ++c) {
    __syncthreads();
    float* dst = ckpt + (size_t)c * SP;
    for (int i = tid; i < SP / 4; i += THREADS) {
      const int row = i / (TILE / 4), col = (i % (TILE / 4)) * 4;
      *reinterpret_cast<float4*>(dst + row * TILE + col) =
          *reinterpret_cast<const float4*>(s.S + row * PF + col);
    }
    stage<T, false>(s, a, c * TILE, base, ts, nullptr);
    __syncthreads();
    cumsum_part(s.CX, s.PT, tid);
    __syncthreads();
    cumsum_carry(s.CX, s.PT, tid);
    __syncthreads();
    // S <- diag(e^{csL}) S + (k e^{csL - cs})^T v, channels t0, t1 of this warp
    const int g = lane >> 2, c4 = lane & 3, t0 = 16 * rb + g, t1 = t0 + 8, n0 = cq * NT * 8;
    const float* csL = s.CX + TILE * PF;
    float st[NT][4];
    const float e0 = dexp(csL[t0]), e1 = dexp(csL[t1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + 8 * n + 2 * c4;
      st[n][0] = e0 * s.S[t0 * PF + col]; st[n][1] = e0 * s.S[t0 * PF + col + 1];
      st[n][2] = e1 * s.S[t1 * PF + col]; st[n][3] = e1 * s.S[t1 * PF + col + 1];
    }
    gemm<NT, false, sizeof(T) == 2>(st, TILE / 8,
        [&](int ks, float (&x)[4]) {
          const int t = 8 * ks + c4;
          x[0] = tof(s.K[t * PR + t0]) * dexp(csL[t0] - s.CX[(t + 1) * PF + t0]);
          x[1] = tof(s.K[t * PR + t1]) * dexp(csL[t1] - s.CX[(t + 1) * PF + t1]);
          x[2] = tof(s.K[(t + 4) * PR + t0]) * dexp(csL[t0] - s.CX[(t + 5) * PF + t0]);
          x[3] = tof(s.K[(t + 4) * PR + t1]) * dexp(csL[t1] - s.CX[(t + 5) * PF + t1]);
        },
        [&](int ks, int n, float (&y)[2]) {
          const T* b0 = s.V + (8 * ks + c4) * PR + n0 + 8 * n + g;
          y[0] = tof(b0[0]); y[1] = tof(b0[4 * PR]);
        });
    __syncthreads();
    put<PF>(s.S, rb, cq, lane, st);
  }

  // -- sweep 2: the chunks backward, carrying dS ----------------------------------
  __syncthreads();
  for (int i = tid; i < K * K; i += THREADS) {
    const int c = i / K, n = i % K;
    s.DS[c * PW + n] = a.dhT ? a.dhT[sbase + i] : 0.f;
  }
  __syncthreads();
  // C of the last chunk, rowsum(dS_T * S_T), in parts of the row: thread
  // (part p, channel) sums columns p TP .. p TP + TP - 1
  const int sch = tid % TILE, sp = tid / TILE;
  if (nch > 0) {
    float acc = 0.f;
#pragma unroll
    for (int j = sp * TP; j < sp * TP + TP; ++j) acc += s.DS[sch * PW + j] * s.S[sch * PF + j];
    s.CP[(((nch - 1) & 1) * NP + sp) * TILE + sch] = acc;
  }
  float du = 0.f;   // this thread's part of du[sch]: its tokens of every chunk
  for (int c = nch - 1; c >= 0; --c) {
    const int c0 = c * TILE, par = c & 1;
    __syncthreads();
    stage<T, true>(s, a, c0, base, ts, ckpt + (size_t)c * SP);
    __syncthreads();
    cumsum_part(s.CX, s.PT, tid);
    {
      // the bonus r . u k and do . v of token t, NP threads of neighbouring
      // lanes each summing every NP-th channel, then a butterfly
      const int t = tid / NP, q = tid % NP;
      float bn = 0.f, dov = 0.f;
      for (int ch = q; ch < K; ch += NP) {
        bn += tof(s.R[t * PR + ch]) * s.U[ch] * tof(s.K[t * PR + ch]);
        dov += s.DO[t * PF + ch] * tof(s.V[t * PR + ch]);
      }
#pragma unroll
      for (int m = 1; m < NP; m <<= 1) {
        bn += __shfl_xor_sync(0xffffffffu, bn, m);
        dov += __shfl_xor_sync(0xffffffffu, dov, m);
      }
      if (!q) {
        s.BN[t] = bn;
        s.DOV[t] = dov;
      }
    }
    __syncthreads();
    cumsum_carry(s.CX, s.PT, tid);
    __syncthreads();
    phase1<T>(s, rb, cq, lane, nkc);
    __syncthreads();
    float P[NT][4], Q[NT][4], ds[NT][4];
    phase2<T>(s, a, rb, cq, lane, nkc, c0, base, ts, P, Q, ds);
    __syncthreads();
    put<PW>(s.DS, rb, cq, lane, ds);
    put<PW>(s.AS, rb, cq, lane, P);
    put<PW>(s.DA, rb, cq, lane, Q);
    __syncthreads();
    {
      // dlogw_s = C + sum_{t>s} P_t - sum_{t>=s} Q_t: thread (part p,
      // channel) totals its part's P - Q, and its part of C of the chunk
      // before, rowsum(dS0 * S0) (its end state and gradient) ...
      float d = 0.f, cb = 0.f;
#pragma unroll
      for (int t = sp * TP + TP - 1; t >= sp * TP; --t) d += s.AS[t * PW + sch] - s.DA[t * PW + sch];
#pragma unroll
      for (int j = sp * TP; j < sp * TP + TP; ++j) cb += s.DS[sch * PW + j] * s.S[sch * PF + j];
      s.PT[sp * TILE + sch] = d;
      s.CP[((1 - par) * NP + sp) * TILE + sch] = cb;
    }
    __syncthreads();
    {
      // ... then starts from C (its parts in order) plus the later parts'
      // totals (last first) and walks its tokens from the last; and du
      float acc = 0.f;
      for (int q = 0; q < NP; ++q) acc += s.CP[(par * NP + q) * TILE + sch];
      for (int q = NP - 1; q > sp; --q) acc += s.PT[q * TILE + sch];
#pragma unroll
      for (int t = sp * TP + TP - 1; t >= sp * TP; --t) {
        acc -= s.DA[t * PW + sch];
        if (sch < K && c0 + t < a.S) a.dlw[base + (size_t)(c0 + t) * ts + sch] = acc;
        acc += s.AS[t * PW + sch];
        du += tof(s.R[t * PR + sch]) * tof(s.K[t * PR + sch]) * s.DOV[t];
      }
    }
  }
  __syncthreads();
  s.PT[sp * TILE + sch] = du;
  __syncthreads();
  if (tid < K) {
    float x = 0.f;
    for (int q = 0; q < NP; ++q) x += s.PT[q * TILE + tid];
    a.du_part[(size_t)bh * K + tid] = x;
  }
  if (a.dh0) {
    for (int i = tid; i < K * K; i += THREADS) {
      const int c = i / K, n = i % K;
      a.dh0[sbase + i] = s.DS[c * PW + n];
    }
  }
}

// du[h, i] = sum over b, in batch order, of the blocks' partial sums
__global__ void du_reduce(const float* part, float* du, int B, int H, int K) {
  const int h = blockIdx.x, i = threadIdx.x;
  if (i >= K) return;
  float x = 0.f;
  for (int b = 0; b < B; ++b) x += part[((size_t)b * H + h) * K + i];
  du[h * K + i] = x;
}

// Above 48 KB a block's shared memory must be asked for: once per device
// and dtype, not at every launch.
template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {};
  const size_t bytes = Shape<T>::bytes();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const long long blocks = (long long)a.B * a.H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  wkv6_bwd_kernel<T><<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  du_reduce<<<a.H, MAX_K, 0, stream>>>(a.du_part, a.du, a.B, a.H, a.K);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// The floats of the scratch ``ckpt`` that wkv6_chunked_bwd_launch needs
// at (B, S, H): one 64 x 64 start state a chunk of 64 tokens of each
// (batch, head).
extern "C" int wkv6_chunked_bwd_scratch(int B, int S, int H, void* floats) {
  if (S < 0 || B < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<long long*>(floats) = (long long)B * H * ((S + TILE - 1) / TILE) * SP;
  return 0;
}

// The scratch ``ckpt`` holds wkv6_chunked_bwd_scratch(B, S, H) floats, 16-byte
// aligned, and ``du_part`` B H K.  r, k, v float32 (bf16_in = 0) or
// bfloat16 (bf16_in = 1).  Launches on the caller's stream and returns
// cudaGetLastError().
extern "C" int wkv6_chunked_bwd_launch(const void* r, const void* k, const void* v,
                                       const void* lw, const void* u, const void* h0,
                                       const void* dO, const void* dhT, void* dr, void* dk,
                                       void* dv, void* dlw, void* du_part, void* du,
                                       void* dh0, void* ckpt, int B, int S, int H, int K,
                                       int bf16_in, void* stream) {
  if (K < 1 || K > MAX_K || S < 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return 0;
  Args a;
  a.r = r; a.k = k; a.v = v;
  a.lw = static_cast<const float*>(lw);
  a.u = static_cast<const float*>(u);
  a.h0 = static_cast<const float*>(h0);
  a.dO = static_cast<const float*>(dO);
  a.dhT = static_cast<const float*>(dhT);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dlw = static_cast<float*>(dlw);
  a.du_part = static_cast<float*>(du_part);
  a.du = static_cast<float*>(du);
  a.dh0 = static_cast<float*>(dh0);
  a.ckpt = static_cast<float*>(ckpt);
  a.B = B; a.S = S; a.H = H; a.K = K;
  a.vec = K % 8 == 0 && aligned(r, 16) && aligned(k, 16) && aligned(v, 16) &&
          aligned(lw, 16) && aligned(dO, 16) && aligned(dr, 8) && aligned(dk, 8) &&
          aligned(dv, 8);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) {   // no block runs: du is the empty sum
    du_reduce<<<H, MAX_K, 0, st>>>(a.du_part, a.du, 0, H, K);
    return static_cast<int>(cudaGetLastError());
  }
  return bf16_in ? launch<bf16>(a, st) : launch<float>(a, st);
}
