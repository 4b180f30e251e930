// The gradient of the RWKV6 (Finch) WKV recurrence with a carried state:
// the backward of kernel #4 (csrc/wkv6.cu), which the LM's training needs.
//
// The TPU package has no backward kernel: its LM trains through plain jnp
// (src/repro/models/ssm.py, rwkv_chunked), whose gradient XLA derives.  Here
// the forward is kernel #4, so its gradient is a kernel too.  Per (batch,
// head), with w_t = exp(logw_t), S_t = diag(w_t) S_{t-1} + k_t^T v_t and
// o_t = r_t (S_{t-1} + diag(u) k_t^T v_t), given do and dhT (dS_T), backward
// in t (dS the gradient of the state after token t):
//   dr_t[i]    = sum_j do_t[j] S_{t-1}[i,j] + u[i] k_t[i] (do_t . v_t)
//   dk_t[i]    = r_t[i] u[i] (do_t . v_t) + sum_j dS[i,j] v_t[j]
//   dv_t[j]    = (sum_i r_t[i] u[i] k_t[i]) do_t[j] + sum_i dS[i,j] k_t[i]
//   dlogw_t[i] = w_t[i] sum_j dS[i,j] S_{t-1}[i,j]
//   du[i]     += r_t[i] k_t[i] (do_t . v_t)
//   dS        <- diag(w_t) dS + r_t^T do_t;   dh0 = dS at the end.
// This is the exact token form, the function of kernels/ref.py,
// wkv6_chunked_bwd_ref; the forward's chunked 3xTF32 form agrees with it
// to 1e-3, so the gradient is that of the exact recurrence.
//
// Layout: r, k, v (B, S, H, K), float32 or bfloat16 (one dtype); logw and
// do (B, S, H, K) float32; u (H, K); h0 and dhT (B, H, K, K) float32, each
// may be null (zero).  dr, dk, dv and dlogw come out (B, S, H, K) float32
// (the wrapper casts dr, dk, dv to r's dtype), du (H, K) and dh0 (B, H, K, K)
// float32.  K <= 64.
//
// Design.  One block of 256 threads per (batch, head).  Row i of the K x K
// state belongs to four threads (tid = 4 i + q), each holding the 16
// columns j = 4 c + q in registers, of S and of dS.  Three of the four sums
// over j (dr, dk, dlogw) and do . v then close within the four threads by
// two xor shuffles; the sum over i (dv) closes within a warp's 8 rows by
// three xor shuffles and across the 8 warps in shared memory.  Every sum
// runs in a fixed order, and du, a sum over batch and time, goes through a
// second kernel that adds the blocks' partial sums in batch order: no
// atomics, so the kernel repeats bit for bit.
//   Sweep 1 runs the recurrence from h0 and stores the state before every
//   group of G = 8 tokens in a scratch (B H ceil(S/8) 16 KB).
//   Sweep 2 walks the groups backward: it reloads the group's state,
//   rebuilds the 8 states S_{t-1} of the group in registers (8 x 16 a
//   thread), then takes the group's tokens backward, staging r, k, w, v and
//   do of the group in shared memory as float32.
// Each product and sum is rounded as the plain version rounds it (no fused
// multiply-add in the state recurrences), so the rebuilt states follow the
// plain version's closely.
//
// Bound on an H100 at the training shape (B 8, S 256, 64 heads of 64, bf16
// r, k, v): 0.27 GB of inputs and outputs, 0.080 ms at 3.35 TB/s; 7.5 GFLOP
// of float32 work (14 K^2 a token and head: the state, three row sums, the
// column sum and the dS update), 0.11 ms at 67 TFLOP/s: operations bound it
// (chip_smoke.py computes both).  This first version sits far above that:
// 512 blocks of 8 warps, one block an SM (some 180 registers a thread), a
// chain of dependent shuffles and two barriers a token's group, and a
// scratch that makes 0.27 GB more of traffic.
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_K = 64;
constexpr int Q = 4;                 // threads per state row
constexpr int COLS = MAX_K / Q;      // columns a thread holds
constexpr int THREADS = MAX_K * Q;   // 256
constexpr int WARPS = THREADS / 32;  // 8
constexpr int G = 8;                 // tokens a group (checkpoint interval)
constexpr int CKPT = COLS * THREADS; // floats of one stored state
static_assert(G == WARPS, "the bonus takes one warp a token of the group");

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
  float* ckpt;        // (B H, ceil(S / G), CKPT) scratch
  int B, S, H, K;
};

struct Stage {
  float R[G][MAX_K];
  float K[G][MAX_K];
  float W[G][MAX_K];   // w = exp(logw); 1 past S and past K
  float V[G][MAX_K];
  float DO[G][MAX_K];
  float BN[G];         // sum_i r u k of each token
  float RED[G][WARPS][MAX_K];   // each warp's partial dS^T k
};

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }

// Stage tokens t0 .. t0 + G - 1 of (b, h); zero past S and past K, w = 1
// there, so padded tokens leave S and dS as they are.  With grads, also r,
// do and the bonus.
template <typename T, bool GRADS>
__device__ void stage(const Args& a, Stage& s, int b, int h, int t0, int tid) {
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int idx = tid; idx < G * MAX_K; idx += THREADS) {
    const int n = idx / MAX_K, c = idx % MAX_K, t = t0 + n;
    const bool in = t < a.S && c < a.K;
    const size_t off = in ? (((size_t)b * a.S + t) * a.H + h) * a.K + c : 0;
    s.K[n][c] = in ? tof(k[off]) : 0.f;
    s.V[n][c] = in ? tof(v[off]) : 0.f;
    s.W[n][c] = in ? expf(a.lw[off]) : 1.f;
    if (GRADS) {
      s.R[n][c] = in ? tof(r[off]) : 0.f;
      s.DO[n][c] = in ? a.dO[off] : 0.f;
    }
  }
  if (GRADS) {
    __syncthreads();
    // the bonus of token n, by warp n: lane l sums channels l and l + 32,
    // then the warp's butterfly
    const int n = tid / 32, lane = tid % 32;
    float x = 0.f;
    for (int c = lane; c < a.K; c += 32) {
      const float uc = a.u[h * a.K + c];
      x += __fmul_rn(__fmul_rn(s.R[n][c], uc), s.K[n][c]);
    }
#pragma unroll
    for (int m = 16; m; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
    if (lane == 0) s.BN[n] = x;
  }
}

// S[i, :] <- w_i S[i, :] + k_i v, rounded as the plain version rounds it
__device__ __forceinline__ void advance(float (&st)[COLS], const float (&prev)[COLS],
                                        const Stage& s, int n, int row, int q) {
  const float w = s.W[n][row], kk = s.K[n][row];
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    st[c] = __fadd_rn(__fmul_rn(prev[c], w), __fmul_rn(kk, s.V[n][Q * c + q]));
}

// the sum over the four threads of a row, the same bits in all four
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wkv6_bwd_kernel(const Args a) {
  __shared__ Stage s;
  const int tid = threadIdx.x, row = tid / Q, q = tid % Q;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const bool live = row < a.K;
  const int ngroups = (a.S + G - 1) / G;
  float* ckpt = a.ckpt + (size_t)bh * ngroups * CKPT + tid;
  const size_t sbase = (size_t)bh * a.K * a.K;

  // -- sweep 1: the state before every group ------------------------------
  float st[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = Q * c + q;
    st[c] = a.h0 && live && j < a.K ? a.h0[sbase + row * a.K + j] : 0.f;
  }
  for (int g = 0; g < ngroups; ++g) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) ckpt[(size_t)g * CKPT + c * THREADS] = st[c];
    __syncthreads();   // the previous group's tiles are read
    stage<T, false>(a, s, b, h, g * G, tid);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < G; ++n) advance(st, st, s, n, row, q);
  }

  // -- sweep 2: the groups backward ---------------------------------------
  float ds[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = Q * c + q;
    ds[c] = a.dhT && live && j < a.K ? a.dhT[sbase + row * a.K + j] : 0.f;
  }
  const float uu = live ? a.u[h * a.K + row] : 0.f;
  float du = 0.f;
  for (int g = ngroups - 1; g >= 0; --g) {
    const int t0 = g * G;
    __syncthreads();   // the previous group's tiles and partial sums are read
    stage<T, true>(a, s, b, h, t0, tid);
    __syncthreads();
    // the group's states S_{t-1}, rebuilt from the stored one
    float sg[G][COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) sg[0][c] = ckpt[(size_t)g * CKPT + c * THREADS];
#pragma unroll
    for (int n = 1; n < G; ++n) advance(sg[n], sg[n - 1], s, n - 1, row, q);
#pragma unroll
    for (int n = G - 1; n >= 0; --n) {
      const int t = t0 + n;
      const float w = s.W[n][row], rr = s.R[n][row], kk = s.K[n][row];
      float pdr = 0.f, pdk = 0.f, pdl = 0.f, pdov = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float doj = s.DO[n][Q * c + q], vj = s.V[n][Q * c + q];
        pdr += doj * sg[n][c];
        pdk += ds[c] * vj;
        pdl += ds[c] * sg[n][c];
        pdov += doj * vj;
      }
      pdr = quad_sum(pdr);
      pdk = quad_sum(pdk);
      pdl = quad_sum(pdl);
      const float dov = quad_sum(pdov);
      if (q == 0 && live && t < a.S) {
        const size_t off = (((size_t)b * a.S + t) * a.H + h) * a.K + row;
        a.dr[off] = pdr + uu * kk * dov;
        a.dk[off] = rr * uu * dov + pdk;
        a.dlw[off] = w * pdl;
      }
      du += rr * kk * dov;
      // dS^T k over the warp's 8 rows, then dS <- diag(w) dS + r^T do
      float col[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float x = ds[c] * kk;
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        col[c] = x;
        ds[c] = __fadd_rn(__fmul_rn(ds[c], w), __fmul_rn(rr, s.DO[n][Q * c + q]));
      }
      if (lane < Q) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) s.RED[n][warp][Q * c + q] = col[c];
      }
    }
    __syncthreads();
    // dv of the group: the 8 warps' partial sums in order, then the bonus
    for (int idx = tid; idx < G * MAX_K; idx += THREADS) {
      const int n = idx / MAX_K, j = idx % MAX_K, t = t0 + n;
      if (t >= a.S || j >= a.K) continue;
      float x = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < WARPS; ++w8) x += s.RED[n][w8][j];
      a.dv[(((size_t)b * a.S + t) * a.H + h) * a.K + j] = s.BN[n] * s.DO[n][j] + x;
    }
  }
  if (q == 0 && live) a.du_part[(size_t)bh * a.K + row] = du;
  if (a.dh0 && live) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int j = Q * c + q;
      if (j < a.K) a.dh0[sbase + row * a.K + j] = ds[c];
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

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (long long)a.B * a.H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  wkv6_bwd_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  du_reduce<<<a.H, MAX_K, 0, stream>>>(a.du_part, a.du, a.B, a.H, a.K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The floats of the scratch ``ckpt`` that wkv6_chunked_bwd_launch needs
// at (B, S, H): one stored state every G tokens of each (batch, head).
extern "C" int wkv6_chunked_bwd_scratch(int B, int S, int H, void* floats) {
  if (S < 0 || B < 0 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<long long*>(floats) = (long long)B * H * ((S + G - 1) / G) * CKPT;
  return 0;
}

// The scratch ``ckpt`` holds wkv6_chunked_bwd_scratch(B, S, H) floats and
// ``du_part`` B H K.  r, k, v float32 (bf16_in = 0) or bfloat16 (bf16_in = 1).
// Launches on the caller's stream and returns cudaGetLastError().
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) {   // no block runs: du is the empty sum
    du_reduce<<<H, MAX_K, 0, st>>>(a.du_part, a.du, 0, H, K);
    return static_cast<int>(cudaGetLastError());
  }
  return bf16_in ? launch<bf16>(a, st) : launch<float>(a, st);
}
