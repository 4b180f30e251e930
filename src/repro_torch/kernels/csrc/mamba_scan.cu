// Mamba's selective scan (jamba's SSM layer) with a carried state.
//
// No TPU kernel exists for it: the reference runs the scan in plain jnp
// (src/repro/models/ssm.py:320, _mamba_scan_chunk, inside the window body
// of mamba_mix, :395-411), an associative scan over windows of mamba_chunk
// tokens.  Per (batch b, channel d, state n), token by token:
//   dA  = 2^(dt_t A2[d, n]),  A2 = A log2(e),   dBx = (dt_t x_t) B_t[n]
//   h   = dA h + dBx
//   y_t = sum_n h[n] C_t[n] + D[d] x_t
// The plain version is kernels/ref.py, mamba_scan_ref (exp(dt A) in float32).
//
// Layout: dt and x are (B, S, di), B and C (B, S, ds), all four float32 or
// bfloat16 (one dtype, widened to float32 exactly); A is (di, ds), D (di),
// h0 and hT (B, di, ds), y (B, S, di), all float32.  h0 may be null for a
// zero state.  ds runs from 1 to 16; a channel keeps 16 states, those past
// ds zero (A = h = B = C = 0, so they add +0 to y and stay 0).
//
// What bounds it on an H100.  Bytes: dt, x, B, C read once, y written in
// float32, h0 read and hT written (4 x 256 x 16384 x 16 in bf16: 143.8 MB,
// 0.0429 ms at 3.35 TB/s; a decode step 4 x 1: 10.0 MB, 0.0030 ms).  One
// exponential per (token, channel, state): 268.4 M at 4 x 256, which the
// SFUs (16 a clock an SM) take 0.064 ms for at 1.98 GHz.  And, measured,
// the issue of the five other float32 instructions an element (dt A2, (dt
// x) B, the state's fma, h C, a tree add) with the loads that feed them:
// with its exponentials taken out the kernel still takes 0.084 ms at 4 x
// 256, so the SFU is not its binding limit.
//
// Design.
// * Lanes per channel.  G adjacent lanes of a warp share one channel, each
//   with 16 / G states in registers as float4s of h and of A2, so a warp
//   moves h0, A and hT as 16-byte vectors over contiguous bytes.  G = 4 at
//   a decode step (S = 1: 4 threads a channel, the states' traffic is the
//   work); G = 2 at every longer scan (8 states a lane, half the per-token
//   overhead of 4).
// * y in one fixed order.  Each product h C is rounded on its own and the
//   16 products are summed by one pairwise tree over n: the levels inside a
//   lane first, then one __shfl_xor_sync level for each doubling of the
//   lanes, then + D x (one fma).  The exchange is a reduce-scatter over G
//   tokens at a time, so after it lane q holds token q's sum: G - 1
//   shuffles for G tokens.  IEEE addition commutes, so the two lanes of a
//   pair get the same bits, and the tree is the same whatever G, the batch,
//   the token count or where a scan is cut: a row of a 4-row launch equals
//   a 1-row launch of it, and a scan split at any token and carried through
//   hT gives the bits of one launch.  Lanes past di take part in every
//   shuffle with zero states and store nothing.
// * Exponentials.  2^(dt A2) on the SFU (ex2.approx.ftz.f32), with A2 =
//   A log2(e) rounded once a (channel, state) when the row is loaded.  It
//   is exactly 1 at +-0, so dt = 0 is the identity (h = 1 h + 0) the
//   engine's pads rely on.  Explicit intrinsics only, no fast-math flag.  A
//   degree-5 polynomial on the FMA pipe for a fixed share of the states (1
//   in 8, 1 in 4, 1 in 2) was measured 10-33 % slower at 4 x 256: the
//   issue slots it takes are the kernel's limit, not the SFU.
// * Staging.  A block of 128 threads (128 / G channels of one batch row)
//   stages dt and x (TILE tokens x its channels) and B and C (TILE x 16)
//   in shared memory with cp.async, double-buffered: the token loop reads
//   only shared memory while the next tile is in flight.  bf16 B and C are
//   widened once a tile in shared memory (every channel of the block reads
//   them).  ds = 16 with di a multiple of 8 and every tensor 16-byte
//   aligned takes this vector instance; any other ds, a ragged di or a
//   pointer off 16 bytes takes the scalar-access instance of the same
//   kernel (plain loads staged into the same buffers; the same arithmetic
//   and bits).  The C entry picks the instance.
// * Grid: (ceil(di / (128 / G)), B) blocks of 128 threads.  At jamba's di
//   = 16384: 4 x 1 (decode, G = 4): (512, 4), at most 64 registers; 1 x 1:
//   (512, 1); 4 x 256 (prefill, G = 2): (256, 4), up to 128 registers for
//   the instruction-level parallelism of 4 unrolled 2-token groups; 1 x
//   128, 1 x 64 and 1 x 8 (engine chunks and buckets): (256, 1).  G and
//   the register plan were settled on the card against 1 and 2 channels a
//   lane, 64 to 128 registers and 1 to 8 unrolled groups.  2 lanes at a
//   decode step too (4 instances fewer) took 0.0054 ms at 4 x 1 against
//   0.0043-0.0045 (L2-cold 0.0063 against 0.0055) and 0.0029 at 1 x 1
//   against 0.0025, the same bits: a decode step keeps its 4 lanes.
// Measured on an H100 SXM at 700 W, bf16 at jamba's width, device ms a
// launch (python3 chip_smoke.py --time-mamba-scan .): 4 x 256 0.0951-0.0958
// (bound 0.0429, the SFU 0.0642), 4 x 1 0.0045 (L2-cold 0.0055; bound
// 0.0030), 1 x 128 0.0158-0.0159 (bound 0.0060).  More in PERF.md
// section 6.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 32;        // tokens staged at a time
constexpr int MAX_DS = 16;      // states a channel keeps
constexpr float LOG2E = 0x1.715476p+0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float exp2_sfu(float e) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

template <typename T, int G, bool VEC>
struct Smem {
  static constexpr int CH = THREADS / G;                 // channels of a block
  // bf16 B and C land raw (double-buffered) and are widened into one float
  // buffer; float B and C (and the scalar instance's) land widened
  static constexpr bool WIDEN = VEC && sizeof(T) == 2;
  T dt[2][TILE][CH];
  T x[2][TILE][CH];
  float bc[WIDEN ? 1 : 2][TILE][2][MAX_DS];              // B_t, C_t as float32
  T raw[2][TILE][2][WIDEN ? MAX_DS : 1];
};

struct Args {
  const void *dt, *x, *Bm, *Cm;
  const float *A, *D, *h0;
  float *y, *hT;
  int S, di, ds;
};

// Stage tokens [t0, t0 + nt) of batch row b, channels [d0, d0 + CH), into
// buffer buf.  VEC: cp.async of 16-byte chunks (ds = 16, di % 8 == 0,
// aligned); else plain loads, B and C widened on the way.
template <typename T, int G, bool VEC>
__device__ __forceinline__ void stage(Smem<T, G, VEC>& sm, const Args& a, int buf, int b,
                                      int d0, int t0, int nt) {
  using S_ = Smem<T, G, VEC>;
  const T* dt = static_cast<const T*>(a.dt);
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const size_t row0 = static_cast<size_t>(b) * a.S + t0;
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);                  // elements a chunk
    constexpr int CPR = S_::CH / EPC;                    // chunks a row of dt or x
    for (int i = threadIdx.x; i < nt * CPR; i += THREADS) {
      const int t = i / CPR, ch = i % CPR, d = d0 + ch * EPC;
      const bool in = d < a.di;
      const size_t off = in ? (row0 + t) * a.di + d : 0;
      cp_async16(&sm.dt[buf][t][ch * EPC], dt + off, in);
      cp_async16(&sm.x[buf][t][ch * EPC], x + off, in);
    }
    constexpr int CPT = MAX_DS / EPC;                    // chunks a token of B or C
    for (int i = threadIdx.x; i < nt * CPT; i += THREADS) {
      const int t = i / CPT, ch = i % CPT;
      const size_t off = (row0 + t) * MAX_DS + ch * EPC;
      if constexpr (S_::WIDEN) {
        cp_async16(&sm.raw[buf][t][0][ch * EPC], Bm + off, true);
        cp_async16(&sm.raw[buf][t][1][ch * EPC], Cm + off, true);
      } else {
        cp_async16(&sm.bc[buf][t][0][ch * EPC], Bm + off, true);
        cp_async16(&sm.bc[buf][t][1][ch * EPC], Cm + off, true);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nt * S_::CH; i += THREADS) {
      const int t = i / S_::CH, c = i % S_::CH, d = d0 + c;
      const bool in = d < a.di;
      const size_t off = (row0 + t) * a.di + d;
      sm.dt[buf][t][c] = in ? dt[off] : zero<T>();
      sm.x[buf][t][c] = in ? x[off] : zero<T>();
    }
    for (int i = threadIdx.x; i < nt * MAX_DS; i += THREADS) {
      const int t = i / MAX_DS, n = i % MAX_DS;
      const size_t off = (row0 + t) * a.ds + n;
      sm.bc[buf][t][0][n] = n < a.ds ? to_f32(Bm[off]) : 0.f;
      sm.bc[buf][t][1][n] = n < a.ds ? to_f32(Cm[off]) : 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ float tree(float* v) {
#pragma unroll
  for (int w = 1; w < N; w <<= 1)
#pragma unroll
    for (int i = 0; i < N; i += 2 * w) v[i] = __fadd_rn(v[i], v[i + w]);
  return v[0];
}

// G tokens [g, g + G) of the staged tile: the state update of each valid
// token (FULL: all G), then the exchange that leaves token g + q's sum over
// the 16 states in lane q.  Returns it, with x of token g + q in *xq (0 for
// a token past nt).
template <typename T, int G, bool VEC, bool FULL>
__device__ __forceinline__ float group(const Smem<T, G, VEC>& sm, int buf, int g, int nt,
                                       int c, int q, const float* a2, float* h, float* xq) {
  constexpr int NPL = MAX_DS / G;
  constexpr int BC = Smem<T, G, VEC>::WIDEN ? 0 : 1;
  float part[G];
  *xq = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    part[j] = 0.f;
    if (FULL || g + j < nt) {
      const float dtv = to_f32(sm.dt[buf][g + j][c]);
      const float xv = to_f32(sm.x[buf][g + j][c]);
      *xq = q == j ? xv : *xq;
      const float dtx = __fmul_rn(dtv, xv);
      const float* Bt = &sm.bc[BC * buf][g + j][0][q * NPL];
      const float* Ct = &sm.bc[BC * buf][g + j][1][q * NPL];
      float pr[NPL];
#pragma unroll
      for (int k4 = 0; k4 < NPL; k4 += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(Bt + k4);
        const float4 c4 = *reinterpret_cast<const float4*>(Ct + k4);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w}, cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k4 + u;
          const float dA = exp2_sfu(__fmul_rn(dtv, a2[k]));
          h[k] = __fmaf_rn(dA, h[k], __fmul_rn(dtx, bv[u]));
          pr[k] = __fmul_rn(h[k], cv[u]);
        }
      }
      part[j] = tree<NPL>(pr);
    }
  }
#pragma unroll
  for (int m = 1; m < G; m <<= 1) {
    const bool up = (q & m) != 0;
#pragma unroll
    for (int j = 0; j < G; j += 2 * m) {
      const float send = up ? part[j] : part[j + m];
      const float keep = up ? part[j + m] : part[j];
      part[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, m));
    }
  }
  return part[0];
}

// Blocks an SM the registers are planned for, and token groups unrolled: a
// decode step (G = 4) is state traffic and wants warps; a longer scan (G =
// 2) wants registers for 4 unrolled token groups
template <int G>
constexpr int min_blocks() { return G == 4 ? 8 : 4; }

template <typename T, int G, bool VEC>
__global__ void __launch_bounds__(THREADS, min_blocks<G>()) mamba_scan_kernel(const Args a) {
  constexpr int NPL = MAX_DS / G;                        // states a lane keeps
  using S_ = Smem<T, G, VEC>;
  __shared__ __align__(16) S_ sm;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * S_::CH;
  const int c = threadIdx.x / G, q = threadIdx.x % G;
  const int d = d0 + c;
  const bool live = d < a.di;
  float a2[NPL], h[NPL];
  const size_t row = static_cast<size_t>(b) * a.di + d;
  if constexpr (VEC) {
#pragma unroll
    for (int k4 = 0; k4 < NPL; k4 += 4) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 av = live ? *reinterpret_cast<const float4*>(
                                   a.A + static_cast<size_t>(d) * MAX_DS + q * NPL + k4)
                             : z;
      const float4 hv = (live && a.h0) ? *reinterpret_cast<const float4*>(
                                             a.h0 + row * MAX_DS + q * NPL + k4)
                                       : z;
      a2[k4] = av.x; a2[k4 + 1] = av.y; a2[k4 + 2] = av.z; a2[k4 + 3] = av.w;
      h[k4] = hv.x; h[k4 + 1] = hv.y; h[k4 + 2] = hv.z; h[k4 + 3] = hv.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int n = q * NPL + k;
      const bool in = live && n < a.ds;
      a2[k] = in ? a.A[static_cast<size_t>(d) * a.ds + n] : 0.f;
      h[k] = (in && a.h0) ? a.h0[row * a.ds + n] : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < NPL; ++k) a2[k] = __fmul_rn(a2[k], LOG2E);
  const float dd = live ? a.D[d] : 0.f;
  // lane q writes y of tokens q, q + G, q + 2G, ...
  float* yq = a.y + (static_cast<size_t>(b) * a.S + q) * a.di + d;
  const size_t ystep = static_cast<size_t>(G) * a.di;

  if (a.S > 0) {
    stage<T, G, VEC>(sm, a, 0, b, d0, 0, min(TILE, a.S));
    cp_commit();
  }
  for (int t0 = 0, buf = 0; t0 < a.S; t0 += TILE, buf ^= 1) {
    const int nt = min(TILE, a.S - t0);
    if (t0 + TILE < a.S) stage<T, G, VEC>(sm, a, buf ^ 1, b, d0, t0 + TILE,
                                          min(TILE, a.S - t0 - TILE));
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    if constexpr (S_::WIDEN) {
      for (int i = threadIdx.x; i < nt * 2 * MAX_DS; i += THREADS)
        (&sm.bc[0][0][0][0])[i] = to_f32((&sm.raw[buf][0][0][0])[i]);
      __syncthreads();
    }
    int g = 0;
#pragma unroll (G == 4 ? 1 : 4)
    for (; g + G <= nt; g += G, yq += ystep) {
      float xq;
      const float s = group<T, G, VEC, true>(sm, buf, g, nt, c, q, a2, h, &xq);
      if (live) *yq = __fmaf_rn(dd, xq, s);
    }
    if (g < nt) {
      float xq;
      const float s = group<T, G, VEC, false>(sm, buf, g, nt, c, q, a2, h, &xq);
      if (live && g + q < nt) *yq = __fmaf_rn(dd, xq, s);
      yq += ystep;
    }
    __syncthreads();   // every thread is done with buf before it is staged again
  }

  if (!live) return;
  if constexpr (VEC) {
#pragma unroll
    for (int k4 = 0; k4 < NPL; k4 += 4)
      *reinterpret_cast<float4*>(a.hT + row * MAX_DS + q * NPL + k4) =
          make_float4(h[k4], h[k4 + 1], h[k4 + 2], h[k4 + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      if (q * NPL + k < a.ds) a.hT[row * a.ds + q * NPL + k] = h[k];
  }
}

template <typename T, int G>
int launch(const Args& a, int B, bool vec, cudaStream_t stream) {
  constexpr int CH = Smem<T, G, true>::CH;
  const dim3 grid((a.di + CH - 1) / CH, B);
  if (vec)
    mamba_scan_kernel<T, G, true><<<grid, THREADS, 0, stream>>>(a);
  else
    mamba_scan_kernel<T, G, false><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int mamba_scan_launch(const void* dt, const void* x, const void* Bm,
                                 const void* Cm, const void* A, const void* D,
                                 const void* h0, void* y, void* hT, int B, int S, int di,
                                 int ds, int bf16_in, void* stream) {
  if (ds < 1 || ds > MAX_DS || S < 0 || di < 0 || B < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || di == 0) return 0;
  const Args a{dt, x, Bm, Cm, static_cast<const float*>(A), static_cast<const float*>(D),
               static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT),
               S, di, ds};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the vector instance: 16 states, whole 16-byte chunks of channels, every
  // tensor it moves in vectors 16-byte aligned
  const bool v = ds == MAX_DS && di % 8 == 0 && aligned16(dt) && aligned16(x) &&
                 aligned16(Bm) && aligned16(Cm) && aligned16(A) && aligned16(hT) &&
                 (h0 == nullptr || aligned16(h0));
  // 4 lanes a channel at a decode step, 2 at every longer scan
  if (bf16_in)
    return S <= 1 ? launch<__nv_bfloat16, 4>(a, B, v, st) : launch<__nv_bfloat16, 2>(a, B, v, st);
  return S <= 1 ? launch<float, 4>(a, B, v, st) : launch<float, 2>(a, B, v, st);
}
