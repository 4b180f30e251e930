// Chunked RWKV6 (Finch) WKV with data-dependent decay, with a carried state.
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
// Every exponent is relative and non-positive, so float32 needs no
// rescaling.  With a zero initial state this is wkv6_chunked; with h0 it is
// rwkv_chunked, whose final state comes back in hT.
//
// Layout: r, k, v, logw and o are (B, S, H, K) float32, the model's own
// layout, so no transpose is needed; u is (H, K); h0 and hT are (B, H, K, K).
// Positions past S count as r = k = v = 0 and logw = 0, exactly the zero
// padding of the reference, so the last chunk may be ragged.
//
// Design: one thread block per (batch, head) walks its chunks in order, a
// loop that replaces the TPU grid's sequential chunk axis and its VMEM state
// scratch.  The state, the chunk's r, k, v, cs, cs_prev tiles, a decayed
// tile and the L x L intra-chunk scores stay in shared memory (130 KB at
// K = L = 64, above the 48 KB default, so the limit is raised).  Each chunk
// takes five passes separated by barriers: stage, cumsum (one thread per
// channel, summed in order as the reference sums it), decays and scores,
// outputs, state.  Tiles of L x K are stored with row stride K + 1 so that
// threads walking the time axis hit distinct banks.
//
// Bound on an H100: the three chunk products and the L^2 K / 2 exponentials
// of the scores, about 2 GFLOP for 4 x 256 tokens x 64 heads, against 92 MB
// of inputs and outputs: both bounds are near 0.03 ms.  This simple version
// runs on the FMA and SFU pipes from shared memory with one block per SM;
// mma/wgmma for the chunk products, TMA staging and splitting a head's
// state across blocks are later work.  expf, not __expf, and no fast math:
// the parity tolerance depends on it.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 64;
constexpr int MAX_L = 64;

struct Wkv6Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* h0;  // may be null: a zero initial state
  float* o;
  float* hT;
  int B, S, H, K, L;
};

__host__ __device__ inline size_t smem_floats(int L, int K) {
  return 6 * (size_t)L * (K + 1) + (size_t)K * K + (size_t)L * L + K + L;
}

__global__ void __launch_bounds__(THREADS) wkv6_kernel(Wkv6Args a) {
  extern __shared__ float smem[];
  const int K = a.K, L = a.L, KP = K + 1;
  float* R = smem;              // (L, KP) r
  float* Kt = R + L * KP;       // (L, KP) k
  float* V = Kt + L * KP;       // (L, KP) v
  float* CS = V + L * KP;       // (L, KP) inclusive cumsum of logw
  float* CP = CS + L * KP;      // (L, KP) logw, then cs - logw
  float* D = CP + L * KP;       // (L, KP) r * exp(cs_prev), then k * exp(cs_L - cs)
  float* St = D + L * KP;       // (K, K) state
  float* A = St + K * K;        // (L, L) intra-chunk scores
  float* U = A + L * L;         // (K) u of this head
  float* Bn = U + K;            // (L) u bonus per token

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const size_t tstride = (size_t)a.H * K;                   // one time step
  const size_t base = (size_t)b * a.S * tstride + (size_t)h * K;
  const size_t sbase = (size_t)blockIdx.x * K * K;

  for (int i = tid; i < K * K; i += THREADS) St[i] = a.h0 ? a.h0[sbase + i] : 0.f;
  for (int i = tid; i < K; i += THREADS) U[i] = a.u[(size_t)h * K + i];

  for (int c0 = 0; c0 < a.S; c0 += L) {
    // 1. stage the chunk; past S: r = k = v = logw = 0
    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, c = i % K, p = t * KP + c;
      const int s = c0 + t;
      if (s < a.S) {
        const size_t off = base + (size_t)s * tstride + c;
        R[p] = a.r[off];
        Kt[p] = a.k[off];
        V[p] = a.v[off];
        CP[p] = a.lw[off];
      } else {
        R[p] = 0.f;
        Kt[p] = 0.f;
        V[p] = 0.f;
        CP[p] = 0.f;
      }
    }
    __syncthreads();
    // 2. cumsum over the chunk, one thread per channel, in time order; and
    //    the u bonus, one thread per token
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        const float w = CP[t * KP + tid];
        acc += w;
        CS[t * KP + tid] = acc;
        CP[t * KP + tid] = acc - w;
      }
    }
    for (int t = tid; t < L; t += THREADS) {
      float s = 0.f;
      for (int c = 0; c < K; ++c) s += R[t * KP + c] * U[c] * Kt[t * KP + c];
      Bn[t] = s;
    }
    __syncthreads();
    // 3. decayed r, and the strictly causal scores (i < t; zero above)
    for (int i = tid; i < L * K; i += THREADS) {
      const int p = (i / K) * KP + i % K;
      D[p] = R[p] * expf(CP[p]);
    }
    for (int i = tid; i < L * L; i += THREADS) {
      const int t = i / L, j = i % L;
      float s = 0.f;
      if (j < t) {
        for (int c = 0; c < K; ++c) {
          float e = CP[t * KP + c] - CS[j * KP + c];
          e = e > 0.f ? 0.f : e;
          s += R[t * KP + c] * expf(e) * Kt[j * KP + c];
        }
      }
      A[i] = s;
    }
    __syncthreads();
    // 4. outputs: inter-chunk, then intra-chunk, then the bonus
    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, c = i % K;
      if (c0 + t >= a.S) continue;
      float inter = 0.f;
      for (int kk = 0; kk < K; ++kk) inter += D[t * KP + kk] * St[kk * K + c];
      float intra = 0.f;
      for (int j = 0; j < t; ++j) intra += A[t * L + j] * V[j * KP + c];
      a.o[base + (size_t)(c0 + t) * tstride + c] = (inter + intra) + Bn[t] * V[t * KP + c];
    }
    __syncthreads();
    // 5. the carried state
    const float* csL = CS + (L - 1) * KP;
    for (int i = tid; i < L * K; i += THREADS) {
      const int p = (i / K) * KP + i % K;
      D[p] = Kt[p] * expf(csL[i % K] - CS[p]);
    }
    __syncthreads();
    for (int i = tid; i < K * K; i += THREADS) {
      const int kk = i / K, c = i % K;
      float acc = 0.f;
      for (int t = 0; t < L; ++t) acc += D[t * KP + kk] * V[t * KP + c];
      St[i] = St[i] * expf(csL[kk]) + acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < K * K; i += THREADS) a.hT[sbase + i] = St[i];
}

}  // namespace

// Launches on the caller's stream and returns cudaGetLastError(), so a
// launch the card refuses is reported to the caller right away.
extern "C" int wkv6_chunked_launch(const void* r, const void* k, const void* v,
                                   const void* lw, const void* u, const void* h0,
                                   void* o, void* hT, int B, int S, int H, int K,
                                   int L, void* stream) {
  if (K < 1 || K > MAX_K || L < 1 || L > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const size_t bytes = smem_floats(L, K) * sizeof(float);
  // above 48 KB a block's shared memory must be asked for, on each device
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Wkv6Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lw = static_cast<const float*>(lw);
  a.u = static_cast<const float*>(u);
  a.h0 = static_cast<const float*>(h0);
  a.o = static_cast<float*>(o);
  a.hT = static_cast<float*>(hT);
  a.B = B; a.S = S; a.H = H; a.K = K; a.L = L;
  wkv6_kernel<<<B * H, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
