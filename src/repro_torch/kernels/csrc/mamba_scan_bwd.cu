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
// scan_bwd_ops), 11.0 GFLOP at the fp32 rate, 0.16 ms.  What this design
// itself moves and does (cost.scan_bwd_work): 1.372 GB (the scratch, 0.3445
// GB, written and read; dt, x and B read twice) and 14.83 GFLOP, 0.41 ms
// set by the bytes (the operations take 0.22 ms at the fp32 rate); and its
// 1.61 G exponentials (three a state and token: sweep 1, a window's
// recompute, the backward walk), 0.39 ms on the SFUs (16 a clock an SM at
// 1.98 GHz).
//
// What held the first design (2.295 ms a launch at that shape,
// 13.9x the bound, 5.6x its own 0.41 ms):
//  1. One block of 8 warps an SM: 208 registers at 256 threads, most of
//     them a window's 9 states and 8 decays (68 floats), so each scheduler
//     had 2 warps to hide a token's dependent chain (a shared load, ex2 on
//     the SFU, an fma, a shuffle butterfly).
//  2. 28 shuffles a token and lane: two levels over the states, three
//     levels of 8 values over the warp's channels, each waiting on the one
//     before; then each block's 32 sums a token to a (256, B, S, 32)
//     scratch that a second kernel read back with half-used lines.
//  3. No load in flight while tokens were walked: each 16-token tile was
//     staged by plain loads between two barriers, in both sweeps.
//  4. The scratch round trip: the stored states, 0.27 GB written and read.
//
// Design (this one; each choice timed on the card against its
// alternative, PERF.md section 6).
// * Occupancy: two blocks of 8 warps an SM.  A window's decays are not
//   kept: the backward walk recomputes a_t (a third ex2 a state and token,
//   on the SFU beside the FMA pipe), so a lane holds the window's 9 x 4
//   states and little else, within the 128 registers of
//   __launch_bounds__(256, 2), no spills.  Every loop that stages or
//   widens a tile runs a count fixed when compiled (for_each), so that no
//   thread index stays live in a register across the sweeps.
// * Branch-free windows: a full window of 8 tokens is one unrolled block
//   with no branch between its tokens (only a scan's last window is
//   ragged), and the walk stores nothing to device memory: its sums over
//   the states go to shared memory (``sums``), from which dx and ddt are
//   made and written a window at a time, rows of 64 channels at once.
// * The sums over channels through shared memory.  Each lane adds its
//   channel's products for a token (dy h_t and g dt x, 4 states) to those
//   of the neighbouring channel with one shuffle (the even channel keeps dy
//   h, the odd g dt x) and stores the 4 pair sums as one float4; after each
//   window a warp a token sums its 32 pairs in one fixed order (a lane's 4
//   states over the 8 pairs p = r mod 4, ascending, then the residues r as
//   (s0 + s1) + (s2 + s3) by a reduce-scatter over the lanes).  Two
//   windows' sums are held, so one barrier a window separates a window's
//   walk from its pass, which runs beside the next window's walk.  The
//   layout is padded so that neither the stores nor the pass meet a bank
//   conflict.  The sums over a channel's 4 lanes (g B and g A2 a h) take
//   one reduce-scatter level and one all-reduce level, so a token and lane
//   take 6 shuffles in all, where the first design took 28.
// * Tiles in flight.  Sweep 1 stages dt, x and B 32 tokens a tile by
//   cp.async into a ring of 3 (in the shared memory of the channel pass,
//   idle then), two tiles in flight while one is walked, read as they come
//   (bf16 widened in registers).  Sweep 2 stages dt, x, dy, B and C 16
//   tokens a tile by cp.async, double-buffered, the one before in time in
//   flight while one is walked, bf16 widened once a tile in shared memory;
//   its first tile is in flight through all of sweep 1.  ds = 16 with di a
//   multiple of 8 and every tensor 16-byte aligned takes this vector
//   instance; any other shape or pointer the scalar instance (plain loads
//   into the same buffers: the same arithmetic and bits).
// * Scratch as before: a stored state every 8 tokens, (B, S / 8, di, 16),
//   each block's 32 sums a token (nblk, B, S, 32), the rows' dA and dD:
//   0.3445 GB at 8 x 256 x 16384.  A 16-token window would halve the
//   states, but its 17 x 4 states a lane take the registers that buy the
//   second block, and in shared memory (70 KB a block) they do not fit
//   beside the channel pass's 66 KB at two blocks an SM.  The second
//   kernel adds the blocks' sums in one fixed order (block k into running
//   sum k mod 4, then a fixed tree), one thread a (token, sum), 32
//   neighbouring threads on 128 contiguous bytes a block.
// Invariants.  h_{t-1} in the walk is recomputed from the stored state by
// the forward kernel's arithmetic (A2 rounded once, dt x rounded,
// ex2.approx.ftz, one fma a state), never rebuilt by dividing by a_t (it
// underflows to 0 past dt |A| of about 87), so the h it differentiates is,
// bit for bit, the h the forward returned.  Every sum is in a fixed order,
// no atomics, so launches repeat bit for bit.  None of the orders depends
// on where a scan is cut: a scan split at any token and carried through dh
// gives a single launch's ddt, dx, dB, dC and dh0 bit for bit (dA and dD
// add their halves in another order).
// Measured on an H100 SXM at 700 W (python3 chip_smoke.py
// --time-mamba-scan-bwd TREE, A B B A against the first design in one
// call), a launch at 8 x 256 x 16384 x 16: bf16 1.0196-1.0279 ms against
// 2.2761-2.2895 (the main kernel 0.987-0.997, the second 0.033), float32
// 0.9730-0.9762 against 2.2587-2.2735.  Sweep 1 alone takes about 0.2 ms
// (its exponentials need 0.128 at the SFU's rate).  More in PERF.md
// section 6.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int G = 4;                  // lanes a (batch, channel)
constexpr int NPL = 4;                // states a lane
constexpr int MAX_DS = G * NPL;       // states a channel keeps
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;         // blocks an SM the registers are planned for
constexpr int CH = THREADS / G;       // channels a block
constexpr int W = 8;                  // tokens a window: one stored state each
constexpr int TILE = 16;              // sweep 2: tokens staged at a time, whole windows
constexpr int T1 = 32, NS1 = 3;       // sweep 1: tokens a tile, tiles in its ring
constexpr int NK = 2 * MAX_DS;        // a token's sums over channels: dC, then dB
constexpr int PAIRS = CH / 2;                        // pairs of channels a block
constexpr int HALF = PAIRS * MAX_DS + 16;            // a token's dy h (or g dt x), padded
constexpr int SUMS = W * CH + 8;                     // a window's sums over the states, padded
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 0x1.715476p+0f;
constexpr float LN2 = 0x1.62e430p-1f;
static_assert(TILE % W == 0 && T1 % W == 0, "tiles hold whole windows");
static_assert(W * 32 == THREADS && NK == 32, "the channel pass: a warp a token, a lane a sum");

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

// The same instruction, volatile so that the compiler recomputes the decay
// in the backward walk rather than keep the window's decays live
__device__ __forceinline__ float exp2_sfu_again(float e) {
  float r;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 4 consecutive elements as float32
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

// Sweep 1's ring: NS1 tiles of T1 tokens of dt, x and B as they come
template <typename T>
struct Ring {
  T dt[NS1][T1][CH];
  T x[NS1][T1][CH];
  T b[NS1][T1][MAX_DS];
};

// Shared memory of a block.  Sweep 2 reads float32 dt, x, B and C from
// ``dt``, ``x`` and ``bc``: double-buffered where they land as float32
// (cp.async of float32, or the scalar instance's plain loads), one buffer
// where bf16 lands raw (double-buffered in ``rdt``, ``rx``, ``rbc``) and is
// widened into it once a tile.  ``red`` holds two windows' channel-pair
// sums (even windows, odd windows), and sweep 1's ring before them;
// ``sums`` two windows' sums over the states, from which dx and ddt are
// made on their way to device memory.
template <typename T, bool VEC>
struct Smem {
  static constexpr bool WIDEN = VEC && sizeof(T) == 2;
  static constexpr int NB = WIDEN ? 1 : 2;
  union {
    float red[2][W][2][HALF];           // [window parity][token][dy h | g dt x][pair, state]
    Ring<T> ring;
  };
  float sums[2][2][SUMS];               // [window parity][g B | g A2 a h][token, channel]
  float dy[2][TILE][CH];
  float dt[NB][TILE][CH];
  float x[NB][TILE][CH];
  float bc[NB][TILE][2][MAX_DS];        // B_t, C_t
  T rdt[WIDEN ? 2 : 1][TILE][WIDEN ? CH : 8];
  T rx[WIDEN ? 2 : 1][TILE][WIDEN ? CH : 8];
  T rbc[WIDEN ? 2 : 1][TILE][2][WIDEN ? MAX_DS : 8];
};

// f(i) for i = threadIdx.x, threadIdx.x + THREADS, ... below N: a count
// known when compiled, so that no index is kept across the sweeps' loops
template <int N, typename F>
__device__ __forceinline__ void for_each(F f) {
#pragma unroll
  for (int k = 0; k < (N + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (N % THREADS == 0 || i < N) f(i);
  }
}

// Stage sweep 1's tokens [t0, t0 + nt) of batch row b, channels [d0, d0 +
// CH), dt, x and B as they come, into ring slot s; zero past di and ds.
// VEC: cp.async of 16-byte chunks, else plain loads.
template <typename T, bool VEC>
__device__ __forceinline__ void stage1(Smem<T, VEC>& sm, const Args& a, int s, int b, int d0,
                                       int t0, int nt) {
  const T* dt = static_cast<const T*>(a.dt);
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const size_t row0 = static_cast<size_t>(b) * a.S + t0;
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);                  // elements a chunk
    constexpr int CPR = CH / EPC, CPT = MAX_DS / EPC;    // chunks a row, a token of B
    for_each<T1 * CPR>([&](int i) {
      const int t = i / CPR, c = (i % CPR) * EPC, d = d0 + c;
      if (t < nt) {
        const bool in = d < a.di;
        const size_t off = in ? (row0 + t) * a.di + d : 0;
        cp_async16(&sm.ring.dt[s][t][c], dt + off, in);
        cp_async16(&sm.ring.x[s][t][c], x + off, in);
      }
    });
    for_each<T1 * CPT>([&](int i) {
      const int t = i / CPT, n = (i % CPT) * EPC;
      if (t < nt) cp_async16(&sm.ring.b[s][t][n], Bm + (row0 + t) * MAX_DS + n, true);
    });
  } else {
    for_each<T1 * CH>([&](int i) {
      const int t = i / CH, c = i % CH, d = d0 + c;
      if (t < nt) {
        const bool in = d < a.di;
        const size_t off = (row0 + t) * a.di + d;
        sm.ring.dt[s][t][c] = in ? dt[off] : zero<T>();
        sm.ring.x[s][t][c] = in ? x[off] : zero<T>();
      }
    });
    for_each<T1 * MAX_DS>([&](int i) {
      const int t = i / MAX_DS, n = i % MAX_DS;
      if (t < nt) sm.ring.b[s][t][n] = n < a.ds ? Bm[(row0 + t) * a.ds + n] : zero<T>();
    });
  }
}

// Stage sweep 2's tokens [t0, t0 + nt) of batch row b, channels [d0, d0 +
// CH), into buffer buf: dt, x, dy, B and C; zero past di and ds.  VEC:
// cp.async of 16-byte chunks (ds = 16, di % 8 == 0, aligned), else plain
// loads, widened on the way.  A null dy is zero in both buffers from the
// start.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(Smem<T, VEC>& sm, const Args& a, int buf, int b, int d0,
                                      int t0, int nt) {
  using S_ = Smem<T, VEC>;
  const T* dt = static_cast<const T*>(a.dt);
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const size_t row0 = static_cast<size_t>(b) * a.S + t0;
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);                  // elements a chunk
    constexpr int CPR = CH / EPC, CPT = MAX_DS / EPC;    // chunks a row, a token of B or C
    for_each<TILE * CPR>([&](int i) {
      const int t = i / CPR, c = (i % CPR) * EPC, d = d0 + c;
      if (t < nt) {
        const bool in = d < a.di;
        const size_t off = in ? (row0 + t) * a.di + d : 0;
        if constexpr (S_::WIDEN) {
          cp_async16(&sm.rdt[buf][t][c], dt + off, in);
          cp_async16(&sm.rx[buf][t][c], x + off, in);
        } else {
          cp_async16(&sm.dt[buf][t][c], dt + off, in);
          cp_async16(&sm.x[buf][t][c], x + off, in);
        }
      }
    });
    if (a.dy) {
      for_each<TILE * CH / 4>([&](int i) {
        const int t = i / (CH / 4), c = (i % (CH / 4)) * 4, d = d0 + c;
        const bool in = d < a.di;
        if (t < nt) cp_async16(&sm.dy[buf][t][c], a.dy + (in ? (row0 + t) * a.di + d : 0), in);
      });
    }
    for_each<TILE * 2 * CPT>([&](int i) {
      const int t = i / (2 * CPT), which = i / CPT % 2, n = (i % CPT) * EPC;
      const T* src = (which ? Cm : Bm) + (row0 + t) * MAX_DS + n;
      if (t < nt) {
        if constexpr (S_::WIDEN)
          cp_async16(&sm.rbc[buf][t][which][n], src, true);
        else
          cp_async16(&sm.bc[buf][t][which][n], src, true);
      }
    });
  } else {
    for_each<TILE * CH>([&](int i) {
      const int t = i / CH, c = i % CH, d = d0 + c;
      if (t < nt) {
        const bool in = d < a.di;
        const size_t off = (row0 + t) * a.di + d;
        sm.dt[buf][t][c] = in ? to_f32(dt[off]) : 0.f;
        sm.x[buf][t][c] = in ? to_f32(x[off]) : 0.f;
        if (a.dy) sm.dy[buf][t][c] = in ? a.dy[off] : 0.f;
      }
    });
    for_each<TILE * 2 * MAX_DS>([&](int i) {
      const int t = i / (2 * MAX_DS), which = i / MAX_DS % 2, n = i % MAX_DS;
      if (t < nt)
        sm.bc[buf][t][which][n] =
            n < a.ds ? to_f32((which ? Cm : Bm)[(row0 + t) * a.ds + n]) : 0.f;
    });
  }
}

// The vector bf16 instance: widen buffer buf's raw tile into the float
// buffer the walk reads, two elements a step, then a barrier.
template <typename T, bool VEC>
__device__ __forceinline__ void widen(Smem<T, VEC>& sm, int buf, int nt) {
  if constexpr (Smem<T, VEC>::WIDEN) {
    for_each<TILE * CH / 2>([&](int i) {
      const int t = i / (CH / 2), c = (i % (CH / 2)) * 2;
      if (t < nt) {
        *reinterpret_cast<float2*>(&sm.dt[0][t][c]) =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sm.rdt[buf][t][c]));
        *reinterpret_cast<float2*>(&sm.x[0][t][c]) =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sm.rx[buf][t][c]));
      }
    });
    for_each<TILE * MAX_DS>([&](int i) {
      const int t = i / MAX_DS, n = (i % MAX_DS) * 2, which = n / MAX_DS, m = n % MAX_DS;
      if (t < nt)
        *reinterpret_cast<float2*>(&sm.bc[0][t][which][m]) = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&sm.rbc[buf][t][which][m]));
    });
    __syncthreads();
  }
}

// Sweep 1: the tokens [w0, w0 + nw) of ring slot s forward from h (FULL:
// nw = W, so that the unrolled tokens carry no branch between them)
template <bool FULL, typename T>
__device__ __forceinline__ void forward_window(const Ring<T>& ring, int s, int w0, int nw, int c,
                                               int q, const float (&a2)[NPL], float (&h)[NPL]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (FULL || j < nw) {
      const float dtv = to_f32(ring.dt[s][w0 + j][c]);
      const float dtx = __fmul_rn(dtv, to_f32(ring.x[s][w0 + j][c]));
      const float4 b4 = ld4(&ring.b[s][w0 + j][q * NPL]);
      const float bv[NPL] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int k = 0; k < NPL; ++k)
        h[k] = __fmaf_rn(exp2_sfu(__fmul_rn(dtv, a2[k])), h[k], __fmul_rn(dtx, bv[k]));
    }
  }
}

// What a thread carries through sweep 2: its channel's A log2(e) (4
// states), g, dA and dD summed over its tokens
struct Lane {
  float a2[NPL], g[NPL], dA[NPL];
  float dD;
};

// Sweep 2's window [w0, w0 + nw) of the staged tile: its states from the
// stored one (h0w) as the forward computed them, then backward through
// them, the decays recomputed.  Each token's sum g B over the states
// (lanes 0 and 2 of the channel) and sum g A2 a h (lanes 1 and 3) to
// sums, its products (dy h and g dt x) summed over a pair of channels
// (lanes 4 apart: the even channel keeps dy h, the odd one g dt x) to
// red: no branch between the tokens.
template <bool FULL, typename S_>
__device__ __forceinline__ void backward_window(S_& sm, float (&red)[W][2][HALF],
                                                float (&sums)[2][SUMS], int p, int buf, int w0,
                                                int nw, int c, int q, float4 h0w, Lane& l) {
  float hs[W + 1][NPL];
  hs[0][0] = h0w.x; hs[0][1] = h0w.y; hs[0][2] = h0w.z; hs[0][3] = h0w.w;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (FULL || j < nw) {
      const float dtv = sm.dt[p][w0 + j][c];
      const float dtx = __fmul_rn(dtv, sm.x[p][w0 + j][c]);
      const float4 b4 = ld4(&sm.bc[p][w0 + j][0][q * NPL]);
      const float bv[NPL] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int k = 0; k < NPL; ++k)
        hs[j + 1][k] = __fmaf_rn(exp2_sfu(__fmul_rn(dtv, l.a2[k])), hs[j][k],
                                 __fmul_rn(dtx, bv[k]));
    }
  }
  const bool odd = q & 1, odd_c = c & 1;
  float* const red_c = &red[0][odd_c][(c >> 1) * MAX_DS + q * NPL];
#pragma unroll
  for (int j = W - 1; j >= 0; --j) {
    if (FULL || j < nw) {
      const int tj = w0 + j;
      const float dtv = sm.dt[p][tj][c], xv = sm.x[p][tj][c], dyv = sm.dy[buf][tj][c];
      const float dtx = __fmul_rn(dtv, xv);
      const float4 b4 = ld4(&sm.bc[p][tj][0][q * NPL]);
      const float4 c4 = ld4(&sm.bc[p][tj][1][q * NPL]);
      const float bv[NPL] = {b4.x, b4.y, b4.z, b4.w}, cv[NPL] = {c4.x, c4.y, c4.z, c4.w};
      float pr[NPL], sgb = 0.f, sgap = 0.f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const float ak = exp2_sfu_again(__fmul_rn(dtv, l.a2[k]));
        l.g[k] = __fmaf_rn(dyv, cv[k], l.g[k]);
        const float pc = __fmul_rn(dyv, hs[j + 1][k]), pb = __fmul_rn(l.g[k], dtx);
        pr[k] = __fadd_rn(odd_c ? pb : pc, __shfl_xor_sync(FULL, odd_c ? pc : pb, 4));
        const float gp = __fmul_rn(l.g[k], __fmul_rn(ak, hs[j][k]));
        sgb = k ? __fmaf_rn(l.g[k], bv[k], sgb) : __fmul_rn(l.g[k], bv[k]);
        sgap = k ? __fmaf_rn(gp, l.a2[k], sgap) : __fmul_rn(gp, l.a2[k]);
        l.dA[k] = __fmaf_rn(gp, dtv, l.dA[k]);
        l.g[k] = __fmul_rn(ak, l.g[k]);
      }
      // over the channel's G lanes: even lanes end with sum g B, odd ones
      // with sum g A2 a h (IEEE addition commutes: the same bits in every
      // lane of a pair)
      float v = __fadd_rn(odd ? sgap : sgb, __shfl_xor_sync(FULL, odd ? sgb : sgap, 1));
      sums[odd][j * CH + c] = __fadd_rn(v, __shfl_xor_sync(FULL, v, 2));
      l.dD = __fmaf_rn(dyv, xv, l.dD);
      *reinterpret_cast<float4*>(red_c + j * (2 * HALF)) = make_float4(pr[0], pr[1], pr[2], pr[3]);
    }
  }
}

// A window's dx = dt sum g B + D dy and ddt = x sum g B + ln 2 sum g A2 a
// h, to device memory (dx, ddt: the block's first channel at the window's
// first token), whole rows of channels at a time: thread (r, cc) takes
// channel cc (whose D is Dc) at tokens r, r + 4.
template <typename S_>
__device__ __forceinline__ void write_out(const S_& sm, const float (&sums)[2][SUMS], int p,
                                          int buf, int w0, int nw, int live_ch, float Dc,
                                          float* dx, float* ddt, size_t di) {
  const int cc = threadIdx.x % CH;
#pragma unroll
  for (int t = threadIdx.x / CH; t < W; t += THREADS / CH) {
    if (t < nw && cc < live_ch) {
      const float sgb = sums[0][t * CH + cc];
      dx[t * di + cc] =
          __fmaf_rn(sm.dt[p][w0 + t][cc], sgb, __fmul_rn(Dc, sm.dy[buf][w0 + t][cc]));
      ddt[t * di + cc] = __fmaf_rn(sm.x[p][w0 + t][cc], sgb, __fmul_rn(sums[1][t * CH + cc], LN2));
    }
  }
}

// The block's sum over its 64 channels of each (token, sum) of a window,
// to part_w (the window's first token).  Warp t takes token t; its lane
// (n4, cq, half) adds states 4 n4 .. 4 n4 + 3 of half ``half`` (dy h, then
// g dt x) over the channel pairs p = cq mod 4, ascending, and a
// reduce-scatter over cq (lanes 4 and 8 apart) finishes each state as (s0
// + s1) + (s2 + s3): one fixed order, the same for every block and token.
__device__ __forceinline__ void channel_pass(const float (&red)[W][2][HALF], int nw,
                                             float* part_w) {
  const int t = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n4 = lane & 3, cq = (lane >> 2) & 3, half = lane >> 4;
  const float* r = &red[t][half][cq * MAX_DS + n4 * NPL];
  float4 s = ld4(r);
#pragma unroll
  for (int i = 1; i < PAIRS / 4; ++i) {
    const float4 v = ld4(r + i * 4 * MAX_DS);
    s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                    __fadd_rn(s.w, v.w));
  }
  const bool up1 = cq & 1, up2 = cq & 2;
  const float k0 = __fadd_rn(up1 ? s.z : s.x, __shfl_xor_sync(FULL, up1 ? s.x : s.z, 4));
  const float k1 = __fadd_rn(up1 ? s.w : s.y, __shfl_xor_sync(FULL, up1 ? s.y : s.w, 4));
  const float v = __fadd_rn(up2 ? k1 : k0, __shfl_xor_sync(FULL, up2 ? k0 : k1, 8));
  if (t < nw) part_w[t * NK + half * MAX_DS + n4 * NPL + (up1 ? 2 : 0) + (up2 ? 1 : 0)] = v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mamba_scan_bwd_kernel(const Args a) {
  using S_ = Smem<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  S_& sm = *reinterpret_cast<S_*>(smem_bytes);
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / G, q = threadIdx.x % G;
  const int d = d0 + c;
  const bool live = d < a.di;
  const size_t row = static_cast<size_t>(b) * a.di + d;      // (b, d) of (B, di, ...)
  const int nW = (a.S + W - 1) / W;
  const int nT = (a.S + TILE - 1) / TILE, n1 = (a.S + T1 - 1) / T1;
  float* const ck = a.ckpt + (static_cast<size_t>(b) * nW * a.di + d) * MAX_DS + q * NPL;
  const size_t ck_step = static_cast<size_t>(a.di) * MAX_DS;  // one window further

  Lane l;
  float h[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int n = q * NPL + k;
    const bool in = live && n < a.ds;
    l.a2[k] = __fmul_rn(in ? a.A[static_cast<size_t>(d) * a.ds + n] : 0.f, LOG2E);
    h[k] = (in && a.h0) ? a.h0[row * a.ds + n] : 0.f;
  }
  if (a.dy == nullptr)
    for (int i = threadIdx.x; i < 2 * TILE * CH; i += THREADS) (&sm.dy[0][0][0])[i] = 0.f;

  // sweep 2's first tile, in flight all through sweep 1
  if (nT > 0) stage<T, VEC>(sm, a, 0, b, d0, (nT - 1) * TILE, a.S - (nT - 1) * TILE);
  cp_commit();
  // sweep 1: forward over every token, the state before each window
  // stored; NS1 - 1 tiles of the ring in flight while one is walked
#pragma unroll
  for (int i = 0; i < NS1 - 1; ++i) {
    if (i < n1) stage1<T, VEC>(sm, a, i, b, d0, i * T1, min(T1, a.S - i * T1));
    cp_commit();
  }
  for (int i = 0; i < n1; ++i) {
    const int t0 = i * T1, nt = min(T1, a.S - t0), next = i + NS1 - 1;
    if (next < n1) stage1<T, VEC>(sm, a, next % NS1, b, d0, next * T1, min(T1, a.S - next * T1));
    cp_commit();
    cp_wait<NS1 - 1>();
    __syncthreads();
    for (int w0 = 0; w0 < nt; w0 += W) {
      if (live)
        *reinterpret_cast<float4*>(ck + static_cast<size_t>((t0 + w0) / W) * ck_step) =
            make_float4(h[0], h[1], h[2], h[3]);
      if (nt - w0 >= W)
        forward_window<true>(sm.ring, i % NS1, w0, W, c, q, l.a2, h);
      else
        forward_window<false>(sm.ring, i % NS1, w0, nt - w0, c, q, l.a2, h);
    }
    __syncthreads();   // every thread is done with the slot before it is staged again
  }

  // sweep 2: the tiles backward, in each its windows backward; the stored
  // state of the window before is in flight while a window is walked, and
  // a window's channel pass runs beside the next window's walk (red holds
  // two), one barrier between them
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int n = q * NPL + k;
    l.g[k] = (live && n < a.ds && a.dhT) ? a.dhT[row * a.ds + n] : 0.f;
    l.dA[k] = 0.f;
  }
  l.dD = 0.f;
  float4 ck_next = (live && nW > 0) ? ld4(ck + static_cast<size_t>(nW - 1) * ck_step)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t col = static_cast<size_t>(b) * a.S * a.di + d0;  // (b, 0, d0) of (B, S, di)
  const int live_ch = min(CH, a.di - d0);
  const float Dc = threadIdx.x % CH < live_ch ? a.D[d0 + threadIdx.x % CH] : 0.f;
  float* const part_b = a.part + (static_cast<size_t>(blockIdx.x) * a.B + b) * a.S * NK;
  int buf = 0;
  for (int i = nT - 1; i >= 0; --i, buf ^= 1) {
    const int t0 = i * TILE, nt = min(TILE, a.S - t0);
    cp_wait<0>();
    __syncthreads();   // this tile has landed; every thread is past the last reads of buf ^ 1
    if (i > 0) stage<T, VEC>(sm, a, buf ^ 1, b, d0, t0 - TILE, TILE);
    cp_commit();
    widen<T, VEC>(sm, buf, nt);
    const int p = S_::WIDEN ? 0 : buf;
    for (int w0 = ((nt - 1) / W) * W; w0 >= 0; w0 -= W) {
      const int nw = min(W, nt - w0), wi = (t0 + w0) / W;
      const float4 h0w = ck_next;
      if (live && wi > 0) ck_next = ld4(ck + static_cast<size_t>(wi - 1) * ck_step);
      const size_t at = col + static_cast<size_t>(t0 + w0) * a.di;
      if (nw == W)
        backward_window<true>(sm, sm.red[wi & 1], sm.sums[wi & 1], p, buf, w0, W, c, q, h0w, l);
      else
        backward_window<false>(sm, sm.red[wi & 1], sm.sums[wi & 1], p, buf, w0, nw, c, q, h0w,
                               l);
      __syncthreads();
      write_out(sm, sm.sums[wi & 1], p, buf, w0, nw, live_ch, Dc, a.dx + at, a.ddt + at, a.di);
      channel_pass(sm.red[wi & 1], nw, part_b + static_cast<size_t>(t0 + w0) * NK);
    }
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int n = q * NPL + k;
    if (n < a.ds) a.dh0[row * a.ds + n] = l.g[k];
  }
  *reinterpret_cast<float4*>(a.dA_part + row * MAX_DS + q * NPL) =
      make_float4(l.dA[0], l.dA[1], l.dA[2], l.dA[3]);
  if (q == 0) a.dD_part[row] = l.dD;
}

// dC and dB (B, S, ds): the blocks' sums, 4 lanes a (token, sum), lane r
// adding blocks k = r mod 4 in ascending order, then (s0 + s1) + (s2 + s3)
// by shuffles: a fixed order; a warp reads 8 neighbouring sums of 4
// blocks at a time.  dA (di, ds) and dD (di): the batch rows' in row order.
__global__ void __launch_bounds__(REDUCE_THREADS) mamba_scan_bwd_reduce(const Args a, int nblk) {
  constexpr int R = 4;                                   // lanes a (token, sum)
  const long long rows = static_cast<long long>(a.B) * a.S;
  const long long n_bc = rows * NK * R;                  // whole warps
  const long long n_a = static_cast<long long>(a.di) * a.ds;
  const long long total = n_bc + n_a + a.di;
  const size_t step = static_cast<size_t>(rows) * NK;   // one block further in part
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      const long long grp = i / 32;
      const int lane = static_cast<int>(i % 32), r = lane / 8;
      const long long bt = grp / (NK / 8);
      const int kk = static_cast<int>(grp % (NK / 8)) * 8 + lane % 8, n = kk % MAX_DS;
      const float* src = a.part + bt * NK + kk;
      float s = 0.f;
#pragma unroll 4
      for (int k = r; k < nblk; k += R) s = __fadd_rn(s, src[k * step]);
      s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 8));
      s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 16));
      if (r == 0 && n < a.ds) (kk < MAX_DS ? a.dC : a.dB)[bt * a.ds + n] = s;
    } else if (i < n_bc + n_a) {
      const long long j = i - n_bc;
      const size_t dn = static_cast<size_t>(j / a.ds) * MAX_DS + j % a.ds;
      float s = 0.f;
      for (int b = 0; b < a.B; ++b)
        s = __fadd_rn(s, a.dA_part[static_cast<size_t>(b) * a.di * MAX_DS + dn]);
      a.dA[j] = s;
    } else {
      const long long j = i - n_bc - n_a;
      float s = 0.f;
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

// Above 48 KB a block's shared memory must be asked for, and the carveout
// set to shared memory so that two blocks fit an SM: once per device and
// instance, not at every launch.
template <typename T, bool VEC>
cudaError_t prepare() {
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(mamba_scan_bwd_kernel<T, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem<T, VEC>)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mamba_scan_bwd_kernel<T, VEC>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t launch(const Args& a, int nblk, cudaStream_t st) {
  const cudaError_t err = prepare<T, VEC>();
  if (err != cudaSuccess) return err;
  mamba_scan_bwd_kernel<T, VEC><<<dim3(nblk, a.B), THREADS, sizeof(Smem<T, VEC>), st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t occupancy(int* out) {
  cudaError_t err = prepare<T, VEC>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, mamba_scan_bwd_kernel<T, VEC>, THREADS, sizeof(Smem<T, VEC>));
  out[1] = static_cast<int>(sizeof(Smem<T, VEC>));
  return err;
}

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

// The main kernel's instance for bf16 (bf16_in = 1) or float32 inputs, the
// vector (vec = 1) or scalar one, on the current device: out[0] its blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] its shared
// bytes a block, out[2] its threads a block.
extern "C" int mamba_scan_bwd_occupancy(int bf16_in, int vec, void* out) {
  int* o = static_cast<int*>(out);
  o[2] = THREADS;
  if (bf16_in)
    return static_cast<int>(vec ? occupancy<__nv_bfloat16, true>(o)
                                : occupancy<__nv_bfloat16, false>(o));
  return static_cast<int>(vec ? occupancy<float, true>(o) : occupancy<float, false>(o));
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
    // the vector instance: 16 states, whole 16-byte chunks of channels, every
    // tensor it stages 16-byte aligned
    const bool v = ds == MAX_DS && di % 8 == 0 && aligned16(dt) && aligned16(x) &&
                   aligned16(Bm) && aligned16(Cm) && (dy == nullptr || aligned16(dy));
    const cudaError_t e = bf16_in ? (v ? launch<__nv_bfloat16, true>(a, nblk, st)
                                       : launch<__nv_bfloat16, false>(a, nblk, st))
                                  : (v ? launch<float, true>(a, nblk, st)
                                       : launch<float, false>(a, nblk, st));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long total =
      4LL * B * S * NK + static_cast<long long>(di) * ds + di;   // mamba_scan_bwd_reduce's
  if (total > 0) {
    const long long blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
    const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
    mamba_scan_bwd_reduce<<<grid, REDUCE_THREADS, 0, st>>>(a, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}
