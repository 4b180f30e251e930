// The gradient of Mamba's selective scan (csrc/mamba_scan.cu), which jamba's
// training needs.
//
// No TPU kernel exists for it: the reference trains through jax.grad of its
// jnp scan (src/repro/models/ssm.py:320, _mamba_scan_chunk, inside the
// checkpointed window body of mamba_mix, :403-418).  Here the forward is a
// kernel, so its gradient is one too.  Per (batch b, channel d, state n),
// the forward is
//   a_t = 2^(dt_t A2[d, n]),  A2 = A log2(e),   u_t = (dt_t x_t) B_t[n]
//   h_t = a_t h_{t-1} + u_t,   y_t = sum_n h_t[n] C_t[n] + D[d] x_t
// and, given dy and dhT (either may be null: zero), with g the gradient of
// h_t, backward in t:
//   g     += dy_t C_t
//   dC_t[n] = sum_d dy_t h_t[n]            dB_t[n] = sum_d g[n] dt_t x_t
//   dx_t    = dt_t sum_n g B_t + D dy_t     ddt_t = x_t sum_n g B_t + sum_n g A a_t h_{t-1}
//   dA     += g dt_t a_t h_{t-1}            dD   += dy_t x_t      (over b and t)
//   g       = a_t g                         and dh0 = g at the end.
// The plain version is kernels/ref.py, mamba_scan_bwd_ref.
//
// Layout: dt and x are (B, S, di), B and C (B, S, ds), all four float32 or
// bfloat16 (one dtype, widened to float32 exactly, as the forward reads
// them); A (di, ds), D (di), h0 and dhT (B, di, ds), dy (B, S, di), all
// float32; h0, dy and dhT may be null.  Out, all float32: ddt and dx (B, S,
// di), dB and dC (B, S, ds), dA (di, ds), dD (di), dh0 (B, di, ds).  ds runs
// from 1 to 16; states past ds are zero throughout.
//
// What bounds it on an H100 (8 x 256 tokens at jamba's di 16384, 16 states,
// bf16 dt, x, B, C, float32 dy, no h0 or dhT; chip_smoke.py computes it):
// its inputs and outputs, 0.55 GB, 0.16 ms at 3.35 TB/s; the operations of
// one forward of the states and the backward recurrence (kernels/cost.py,
// scan_bwd_ops), 11.0 GFLOP at the fp32 rate, 0.16 ms; and the
// exponentials, which the two sweeps below take twice, 1.07 G on the SFUs
// (16 a clock an SM at 1.98 GHz), 0.26 ms.
//
// Design (a simple kernel, right first).
// * h_{t-1} in the backward walk is recomputed, never rebuilt by dividing
//   by a_t: a_t underflows to 0 once dt |A| passes about 87.  Sweep 1 walks
//   the tokens forward and stores the state before every window of W = 8
//   tokens in a scratch (B, S / 8, di, 16); sweep 2 walks the windows
//   backward, recomputes a window's 8 states and 8 decays forward into
//   registers from its stored start, then walks it backward.  The
//   recompute is the forward kernel's arithmetic (A2 rounded once, dt x
//   rounded, ex2.approx.ftz on the SFU, one fma a state), so the h it
//   differentiates is, bit for bit, the h the forward returned.
// * G = 4 lanes a (batch, channel), 4 states each; a block of 256 threads
//   holds 64 channels of one batch row; grid (ceil(di / 64), B).  dt, x,
//   dy, B and C are staged 16 tokens at a time in shared memory (plain
//   loads, bf16 widened once).  The window's states (9 x 4) and decays
//   (8 x 4) live in registers, indexed only by unrolled loop counters.
// * Sums in a fixed order, no atomics, so launches repeat bit for bit.
//   Over the states (dx, ddt): each lane's 4 products by a pairwise tree,
//   then two __shfl_xor_sync levels (IEEE addition commutes, so every lane
//   of a channel gets the same bits).  Over the channels (dB, dC): three
//   __shfl_xor_sync levels over the warp's 8 channels, the 8 warps in
//   order, each block's sums to a scratch (ceil(di / 64), B, S, 32), then a
//   second kernel in the same C entry adds the blocks in order.  dA and dD:
//   each thread sums its tokens in reverse order, the second kernel the
//   batch rows in order.  None of it depends on where a scan is cut: a scan
//   split at any token and carried through dh gives a single launch's
//   ddt, dx, dB, dC and dh0 bit for bit (dA and dD add their halves in
//   another order).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int G = 4;                  // lanes a (batch, channel)
constexpr int NPL = 4;                // states a lane
constexpr int MAX_DS = G * NPL;       // states a channel keeps
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = THREADS / G;       // channels a block
constexpr int W = 8;                  // tokens a window: one stored state each
constexpr int TILE = 16;              // tokens staged at a time, whole windows
constexpr int NK = 2 * MAX_DS;        // a token's sums over channels: dC, then dB
constexpr int REDUCE_THREADS = 256;
constexpr float LOG2E = 0x1.715476p+0f;
static_assert(TILE % W == 0, "a tile holds whole windows");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float exp2_sfu(float e) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e));
  return r;
}

__device__ __forceinline__ float tree4(const float* v) {
  return __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3]));
}

struct Args {
  const void *dt, *x, *Bm, *Cm;
  const float *A, *D, *h0, *dy, *dhT;
  float *ddt, *dx, *dB, *dC, *dA, *dD, *dh0;
  float* ckpt;      // (B, nW, di, 16): the state before each window
  float* part;      // (nblk, B, S, 32): each block's sums over its channels
  float* dA_part;   // (B, di, 16): each batch row's dA
  float* dD_part;   // (B, di)
  int B, S, di, ds;
};

struct Smem {
  float dt[TILE][CH];
  float x[TILE][CH];
  float dy[TILE][CH];
  float bc[TILE][2][MAX_DS];          // B_t, C_t
  float red[WARPS][TILE][NK];         // each warp's sums over its channels
  float ox[TILE][CH];                 // dx and ddt, written out whole rows at a time
  float odt[TILE][CH];
};

// Stage tokens [t0, t0 + nt) of batch row b, channels [d0, d0 + CH): dt, x
// (and dy) and B, C as float32; zero past nt, di and ds.
template <typename T>
__device__ __forceinline__ void stage(Smem& sm, const Args& a, int b, int d0, int t0, int nt,
                                      bool with_dy) {
  const T* dt = static_cast<const T*>(a.dt);
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const size_t row0 = static_cast<size_t>(b) * a.S + t0;
  for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
    const int t = i / CH, c = i % CH, d = d0 + c;
    const bool in = t < nt && d < a.di;
    const size_t off = (row0 + t) * a.di + d;
    sm.dt[t][c] = in ? to_f32(dt[off]) : 0.f;
    sm.x[t][c] = in ? to_f32(x[off]) : 0.f;
    if (with_dy) sm.dy[t][c] = (in && a.dy) ? a.dy[off] : 0.f;
  }
  for (int i = threadIdx.x; i < TILE * MAX_DS; i += THREADS) {
    const int t = i / MAX_DS, n = i % MAX_DS;
    const bool in = t < nt && n < a.ds;
    const size_t off = (row0 + t) * a.ds + n;
    sm.bc[t][0][n] = in ? to_f32(Bm[off]) : 0.f;
    sm.bc[t][1][n] = in ? to_f32(Cm[off]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) mamba_scan_bwd_kernel(const Args a) {
  __shared__ __align__(16) Smem sm;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / G, q = threadIdx.x % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = d0 + c;
  const bool live = d < a.di;
  const size_t row = static_cast<size_t>(b) * a.di + d;      // (b, d) of (B, di, ...)
  const int nW = (a.S + W - 1) / W;
  float* const ck = a.ckpt + (static_cast<size_t>(b) * nW * a.di + d) * MAX_DS + q * NPL;
  const size_t ck_step = static_cast<size_t>(a.di) * MAX_DS;  // one window further

  float Av[NPL], a2[NPL], h[NPL], g[NPL], dA_acc[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int n = q * NPL + k;
    const bool in = live && n < a.ds;
    Av[k] = in ? a.A[static_cast<size_t>(d) * a.ds + n] : 0.f;
    a2[k] = __fmul_rn(Av[k], LOG2E);
    h[k] = (in && a.h0) ? a.h0[row * a.ds + n] : 0.f;
    g[k] = (in && a.dhT) ? a.dhT[row * a.ds + n] : 0.f;
    dA_acc[k] = 0.f;
  }
  const float dd = live ? a.D[d] : 0.f;
  float dD_acc = 0.f;

  // sweep 1: forward over every token, the state before each window stored
  for (int t0 = 0; t0 < a.S; t0 += TILE) {
    const int nt = min(TILE, a.S - t0);
    __syncthreads();
    stage<T>(sm, a, b, d0, t0, nt, false);
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      if (j % W == 0 && live)
        *reinterpret_cast<float4*>(ck + static_cast<size_t>((t0 + j) / W) * ck_step) =
            make_float4(h[0], h[1], h[2], h[3]);
      const float dtv = sm.dt[j][c];
      const float dtx = __fmul_rn(dtv, sm.x[j][c]);
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const float dA = exp2_sfu(__fmul_rn(dtv, a2[k]));
        h[k] = __fmaf_rn(dA, h[k], __fmul_rn(dtx, sm.bc[j][0][q * NPL + k]));
      }
    }
  }

  // sweep 2: the tiles backward, and in each tile its windows backward
  for (int t0 = ((a.S - 1) / TILE) * TILE; a.S > 0 && t0 >= 0; t0 -= TILE) {
    const int nt = min(TILE, a.S - t0);
    __syncthreads();       // the tile before has read red, ox and odt
    stage<T>(sm, a, b, d0, t0, nt, true);
    __syncthreads();
    for (int w0 = ((nt - 1) / W) * W; w0 >= 0; w0 -= W) {
      const int nw = min(W, nt - w0);
      float hs[W + 1][NPL], as[W][NPL];
      if (live) {
        const float4 s = *reinterpret_cast<const float4*>(
            ck + static_cast<size_t>((t0 + w0) / W) * ck_step);
        hs[0][0] = s.x; hs[0][1] = s.y; hs[0][2] = s.z; hs[0][3] = s.w;
      } else {
#pragma unroll
        for (int k = 0; k < NPL; ++k) hs[0][k] = 0.f;
      }
      // the window's states and decays, as the forward computed them
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < nw) {
          const float dtv = sm.dt[w0 + j][c];
          const float dtx = __fmul_rn(dtv, sm.x[w0 + j][c]);
#pragma unroll
          for (int k = 0; k < NPL; ++k) {
            as[j][k] = exp2_sfu(__fmul_rn(dtv, a2[k]));
            hs[j + 1][k] = __fmaf_rn(as[j][k], hs[j][k],
                                     __fmul_rn(dtx, sm.bc[w0 + j][0][q * NPL + k]));
          }
        }
      }
      // and backward through them
#pragma unroll
      for (int j = W - 1; j >= 0; --j) {
        if (j < nw) {
          const int tj = w0 + j;
          const float dtv = sm.dt[tj][c], xv = sm.x[tj][c], dyv = sm.dy[tj][c];
          const float dtx = __fmul_rn(dtv, xv);
          float pc[NPL], pb[NPL], gb[NPL], gap[NPL];
#pragma unroll
          for (int k = 0; k < NPL; ++k) {
            g[k] = __fmaf_rn(dyv, sm.bc[tj][1][q * NPL + k], g[k]);
            pc[k] = __fmul_rn(dyv, hs[j + 1][k]);
            pb[k] = __fmul_rn(g[k], dtx);
            gb[k] = __fmul_rn(g[k], sm.bc[tj][0][q * NPL + k]);
            const float gp = __fmul_rn(g[k], __fmul_rn(as[j][k], hs[j][k]));
            gap[k] = __fmul_rn(gp, Av[k]);
            dA_acc[k] = __fmaf_rn(gp, dtv, dA_acc[k]);
            g[k] = __fmul_rn(as[j][k], g[k]);
          }
          // over the states: the lane's tree, then the channel's G lanes
          float sgb = tree4(gb), sgap = tree4(gap);
#pragma unroll
          for (int m = 1; m < G; m <<= 1) {
            sgb = __fadd_rn(sgb, __shfl_xor_sync(0xffffffffu, sgb, m));
            sgap = __fadd_rn(sgap, __shfl_xor_sync(0xffffffffu, sgap, m));
          }
          if (q == 0) {
            sm.ox[tj][c] = __fmaf_rn(dtv, sgb, __fmul_rn(dd, dyv));
            sm.odt[tj][c] = __fmaf_rn(xv, sgb, sgap);
          }
          dD_acc = __fmaf_rn(dyv, xv, dD_acc);
          // over the warp's channels (lanes q, q + G, ...)
#pragma unroll
          for (int m = G; m < 32; m <<= 1) {
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
              pc[k] = __fadd_rn(pc[k], __shfl_xor_sync(0xffffffffu, pc[k], m));
              pb[k] = __fadd_rn(pb[k], __shfl_xor_sync(0xffffffffu, pb[k], m));
            }
          }
          if (lane < G) {
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
              sm.red[warp][tj][q * NPL + k] = pc[k];
              sm.red[warp][tj][MAX_DS + q * NPL + k] = pb[k];
            }
          }
        }
      }
    }
    __syncthreads();
    // the block's sums over its channels (the warps in order), and dx, ddt
    for (int i = threadIdx.x; i < nt * NK; i += THREADS) {
      const int t = i / NK, kk = i % NK;
      float s = sm.red[0][t][kk];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, sm.red[w][t][kk]);
      a.part[((static_cast<size_t>(blockIdx.x) * a.B + b) * a.S + t0 + t) * NK + kk] = s;
    }
    for (int i = threadIdx.x; i < nt * CH; i += THREADS) {
      const int t = i / CH, cc = i % CH;
      if (d0 + cc < a.di) {
        const size_t off = (static_cast<size_t>(b) * a.S + t0 + t) * a.di + d0 + cc;
        a.dx[off] = sm.ox[t][cc];
        a.ddt[off] = sm.odt[t][cc];
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int n = q * NPL + k;
    if (n < a.ds) a.dh0[row * a.ds + n] = g[k];
  }
  *reinterpret_cast<float4*>(a.dA_part + row * MAX_DS + q * NPL) =
      make_float4(dA_acc[0], dA_acc[1], dA_acc[2], dA_acc[3]);
  if (q == 0) a.dD_part[row] = dD_acc;
}

// dC and dB (B, S, ds): the blocks' sums in block order; dA (di, ds) and dD
// (di): the batch rows' in row order.  One thread an output element.
__global__ void __launch_bounds__(REDUCE_THREADS) mamba_scan_bwd_reduce(const Args a, int nblk) {
  const long long n_bc = static_cast<long long>(a.B) * a.S * a.ds;   // dC, and dB
  const long long n_a = static_cast<long long>(a.di) * a.ds;
  const long long total = 2 * n_bc + n_a + a.di;
  const size_t rows = static_cast<size_t>(a.B) * a.S;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (i < 2 * n_bc) {
      const int which = i >= n_bc;                                    // 0: dC, 1: dB
      const long long j = i - which * n_bc;
      const size_t bt = static_cast<size_t>(j / a.ds);
      const int n = static_cast<int>(j % a.ds);
      for (int k = 0; k < nblk; ++k)
        s = __fadd_rn(s, a.part[(k * rows + bt) * NK + which * MAX_DS + n]);
      (which ? a.dB : a.dC)[j] = s;
    } else if (i < 2 * n_bc + n_a) {
      const long long j = i - 2 * n_bc;
      const size_t dn = static_cast<size_t>(j / a.ds) * MAX_DS + j % a.ds;
      for (int b = 0; b < a.B; ++b)
        s = __fadd_rn(s, a.dA_part[static_cast<size_t>(b) * a.di * MAX_DS + dn]);
      a.dA[j] = s;
    } else {
      const long long j = i - 2 * n_bc - n_a;
      for (int b = 0; b < a.B; ++b) s = __fadd_rn(s, a.dD_part[static_cast<size_t>(b) * a.di + j]);
      a.dD[j] = s;
    }
  }
}

struct Scratch {
  long long ckpt, part, dA_part, dD_part;   // floats of each, in this order
};

Scratch scratch_floats(int B, int S, int di) {
  const long long nW = (S + W - 1) / W, nblk = (di + CH - 1) / CH;
  const long long dD = (static_cast<long long>(B) * di + 3) / 4 * 4;
  return {static_cast<long long>(B) * nW * di * MAX_DS,
          nblk * B * static_cast<long long>(S) * NK,
          static_cast<long long>(B) * di * MAX_DS, dD};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Floats of the scratch mamba_scan_bwd_launch takes at (B, S, di): the
// stored window states, the blocks' sums over channels and the batch rows'
// dA and dD.
extern "C" int mamba_scan_bwd_scratch(int B, int S, int di, void* floats) {
  if (B < 0 || S < 0 || di < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_floats(B, S, di);
  *static_cast<long long*>(floats) = s.ckpt + s.part + s.dA_part + s.dD_part;
  return 0;
}

// dt, x, Bm, Cm float32 (bf16_in = 0) or bfloat16 (bf16_in = 1); h0, dy and
// dhT may be null (zero).  ``scratch`` holds mamba_scan_bwd_scratch(B, S, di)
// floats, 16-byte aligned.  Two kernels on the caller's stream; returns
// cudaGetLastError().
extern "C" int mamba_scan_bwd_launch(const void* dt, const void* x, const void* Bm,
                                     const void* Cm, const void* A, const void* D,
                                     const void* h0, const void* dy, const void* dhT,
                                     void* ddt, void* dx, void* dB, void* dC, void* dA,
                                     void* dD, void* dh0, void* scratch, int B, int S, int di,
                                     int ds, int bf16_in, void* stream) {
  if (ds < 1 || ds > MAX_DS || S < 0 || di < 0 || B < 0 || B > 65535 || !aligned16(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_floats(B, S, di);
  float* base = static_cast<float*>(scratch);
  const Args a{dt, x, Bm, Cm,
               static_cast<const float*>(A), static_cast<const float*>(D),
               static_cast<const float*>(h0), static_cast<const float*>(dy),
               static_cast<const float*>(dhT),
               static_cast<float*>(ddt), static_cast<float*>(dx), static_cast<float*>(dB),
               static_cast<float*>(dC), static_cast<float*>(dA), static_cast<float*>(dD),
               static_cast<float*>(dh0),
               base, base + s.ckpt, base + s.ckpt + s.part, base + s.ckpt + s.part + s.dA_part,
               B, S, di, ds};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (di + CH - 1) / CH;
  if (B > 0 && di > 0) {
    const dim3 grid(nblk, B);
    if (bf16_in)
      mamba_scan_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(a);
    else
      mamba_scan_bwd_kernel<float><<<grid, THREADS, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long total = 2LL * B * S * ds + static_cast<long long>(di) * ds + di;
  if (total > 0) {
    const long long blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
    const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
    mamba_scan_bwd_reduce<<<grid, REDUCE_THREADS, 0, st>>>(a, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}
