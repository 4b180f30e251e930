// Dense int8 dequant matmul with one (scale, zero) per 256 x 256 crossbar
// tile: kernel #5, quant_matmul, float32 and bf16 entries.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py, quant_matmul
// (its _kernel, :27):
//   y = x @ ((q + z[k / 256, j / 256]) * s[k / 256, j / 256])
// with q an (M, N) int8 code matrix and one float32 (scale, zero) per
// 256 x 256 tile, M and N multiples of 256.  The sum is float32 and y
// rounds once to x's dtype, as in the TPU body.
//
// It is kernel #1 on epitome_mma.cuh with an identity column table (the
// wrapper's), bk = bn = 256 and one (s, z) per 256 columns.  Bound on an
// H100: the codes are exact in bf16, so at prefill rows (T > 32) the
// products run on the tensor cores (989 TFLOP/s bf16; a float32 x as bf16
// hi + fp16 lo, two passes) and sum in three float32 levels: 16 rows in an
// mma, a crossbar tile's 256 rows in the accumulators, one (s, z) flush per
// tile into the total.  At decode rows (T <= 32) the codes' bytes bound it,
// and the split-K loop streams them: a thread's 8 rows, its block's 16 row
// lanes summed pairwise, the splits 16 at a time pairwise.  rwkv6-7b's
// contraction runs to M = 14336, where one float32 chain sat 4 times
// further from the float64 product than cuBLAS; chip_smoke.py holds the
// kernel no further from it than cuBLAS.
#include "epitome_mma.cuh"

namespace {

constexpr int TILE = 256;  // one (scale, zero) per TILE x TILE codes

template <typename XT, int AMODE>
int launch(const void* x, const void* q, const void* scales, const void* zeros,
           const void* cb, void* y, void* scratch, void* counters, int T, int M, int N,
           int split_rows, void* stream) {
  if (M % TILE || N % TILE) return static_cast<int>(cudaErrorInvalidValue);
  epim_mma::Args a = {};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.zeros = static_cast<const float*>(zeros);
  a.cb = static_cast<const int*>(cb);   // j at j: the identity
  a.y = y;
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.T = T; a.m = M; a.n = N; a.gn = N / TILE; a.bn = TILE; a.bk = TILE;
  a.s_cols = N / TILE; a.ldx = M; a.split_rows = split_rows;
  return T <= epim_mma::DEC_MAX_T ? epim_mma::launch_decode<XT>(a, stream)
                                  : epim_mma::launch_mma<AMODE, XT>(a, stream);
}

}  // namespace

extern "C" int quant_matmul_launch(const void* x, const void* q, const void* scales,
                                   const void* zeros, const void* cb, void* y, void* scratch,
                                   void* counters, int T, int M, int N, int split_rows,
                                   void* stream) {
  return launch<float, epim_mma::kSplit>(x, q, scales, zeros, cb, y, scratch, counters, T, M,
                                         N, split_rows, stream);
}

extern "C" int quant_matmul_bf16_launch(const void* x, const void* q, const void* scales,
                                        const void* zeros, const void* cb, void* y,
                                        void* scratch, void* counters, int T, int M, int N,
                                        int split_rows, void* stream) {
  return launch<__nv_bfloat16, epim_mma::kDirect>(x, q, scales, zeros, cb, y, scratch,
                                                  counters, T, M, N, split_rows, stream);
}
