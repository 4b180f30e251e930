// Mamba's selective scan (jamba's SSM layer) with a carried state.
//
// No TPU kernel exists for it: the reference runs the scan in plain jnp
// (src/repro/models/ssm.py, _mamba_scan_chunk and the chunk body of
// mamba_mix), an associative scan over windows of mamba_chunk tokens.
// Per (batch b, channel d, state n), token by token:
//   dA  = exp(dt_t A[d, n]),   dBx = (dt_t x_t) B_t[n]
//   h   = dA h + dBx
//   y_t = sum_n h[n] C_t[n] + D[d] x_t
// The plain version is kernels/ref.py, mamba_scan_ref.
//
// Layout: dt and x are (B, S, di), B and C (B, S, ds), all four float32 or
// bfloat16 (one dtype, converted to float32 in registers, exactly); A is
// (di, ds), D (di), h0 and hT (B, di, ds), y (B, S, di), all float32.  h0
// may be null for a zero state.
//
// Design.  One thread per (batch, channel): its ds states and its row of A
// live in registers, and it walks the tokens in order, reading its dt and
// x (consecutive threads read consecutive channels, so a warp's loads
// coalesce) and writing its y.  A block of 128 channels of one batch row
// stages B_t and C_t for a tile of 32 tokens in shared memory, read by
// every thread at one address (a broadcast).  The sum over n runs in a
// fixed order and every product and sum is one explicit IEEE operation, so
// a launch repeats bit for bit, a token's arithmetic does not depend on
// where the launch started (a scan split at any token and carried through
// hT gives the bits of one launch), and bfloat16 inputs give the bits of
// float32 inputs of the same values.  dt = 0 is the identity: exp(0) = 1
// and dBx = 0, so h passes through unchanged.  expf is the accurate one
// (no fast-math flag).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int TILE = 32;       // tokens of B and C staged at a time
constexpr int MAX_DS = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int DS>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int S, int di) {
  __shared__ float sB[TILE][DS];
  __shared__ float sC[TILE][DS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;
  float a[DS], h[DS];
  const size_t state = (static_cast<size_t>(b) * di + d) * DS;
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * DS + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[state + n] : 0.f;
  }
  const float dd = live ? D[d] : 0.f;
  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int nt = min(TILE, S - t0);
    __syncthreads();   // the previous tile is read by every thread
    for (int i = threadIdx.x; i < nt * DS; i += THREADS) {
      const size_t off = (static_cast<size_t>(b) * S + t0) * DS + i;
      sB[i / DS][i % DS] = to_f32(Bm[off]);
      sC[i / DS][i % DS] = to_f32(Cm[off]);
    }
    __syncthreads();
    if (!live) continue;
    size_t off = (static_cast<size_t>(b) * S + t0) * di + d;
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt, off += di) {
      const float dtv = to_f32(dt[off]);
      const float xv = to_f32(x[off]);
      const float dtx = __fmul_rn(dtv, xv);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        const float dA = expf(__fmul_rn(dtv, a[n]));
        const float dBx = __fmul_rn(dtx, sB[tt][n]);
        h[n] = __fmaf_rn(dA, h[n], dBx);
        acc = __fmaf_rn(h[n], sC[tt][n], acc);
      }
      y[off] = __fmaf_rn(dd, xv, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) hT[state + n] = h[n];
  }
}

template <typename T, int DS>
int launch_ds(const void* dt, const void* x, const void* Bm, const void* Cm,
              const float* A, const float* D, const float* h0, float* y, float* hT,
              int B, int S, int di, cudaStream_t stream) {
  const dim3 grid((di + THREADS - 1) / THREADS, B);
  mamba_scan_kernel<T, DS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, D, h0, y, hT, S, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dt, const void* x, const void* Bm, const void* Cm, const float* A,
           const float* D, const float* h0, float* y, float* hT, int B, int S, int di,
           int ds, cudaStream_t st) {
#define MAMBA_DS(N) \
  case N: return launch_ds<T, N>(dt, x, Bm, Cm, A, D, h0, y, hT, B, S, di, st);
  switch (ds) {
    MAMBA_DS(1) MAMBA_DS(2) MAMBA_DS(3) MAMBA_DS(4) MAMBA_DS(5) MAMBA_DS(6)
    MAMBA_DS(7) MAMBA_DS(8) MAMBA_DS(9) MAMBA_DS(10) MAMBA_DS(11) MAMBA_DS(12)
    MAMBA_DS(13) MAMBA_DS(14) MAMBA_DS(15) MAMBA_DS(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MAMBA_DS
}

}  // namespace

extern "C" int mamba_scan_launch(const void* dt, const void* x, const void* Bm,
                                 const void* Cm, const void* A, const void* D,
                                 const void* h0, void* y, void* hT, int B, int S, int di,
                                 int ds, int bf16_in, void* stream) {
  if (ds < 1 || ds > MAX_DS || S < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || di == 0) return 0;
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hTf = static_cast<float*>(hT);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_in ? launch<__nv_bfloat16>(dt, x, Bm, Cm, Af, Df, h0f, yf, hTf, B, S, di, ds, st)
                 : launch<float>(dt, x, Bm, Cm, Af, Df, h0f, yf, hTf, B, S, di, ds, st);
}
