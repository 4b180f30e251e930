// Fused quantized-epitome matmul (EPIM's flagship path), float32 entries,
// and its variant that folds the activation inside the kernel.
//
// Replaces the TPU kernels of src/repro/kernels/quant_epitome_matmul.py:
//   quant_epitome_matmul_blocks (its _kernel, :51):
//     y[:, j*bn:(j+1)*bn] = x_folded @ ((Q_blk + z[k, cb[j]]) * s[k, cb[j]])
//     with int8 codes Q, one (scale, zero) per (bk x bn) pack block;
//   quant_epitome_matmul_fused_fold (its _fused_fold_kernel, :110): the same
//     product taking the unfolded activation; the IFRT fold, each epitome
//     row summing the virtual rows that sample it in ascending order, runs
//     inside the kernel.
//
// Bound on an H100: the codes are exact in bf16, so the products run on
// the tensor cores (989 TFLOP/s bf16); a float32 activation takes two bf16
// passes (hi and lo).  At prefill rows the bound is those operations, at
// decode rows (T <= 32) the codes' bytes over 3.35 TB/s.  The main loop
// (epitome_mma.cuh) keeps the codes int8 from HBM to the registers, stages
// them with cp.async in a 4-deep ring, and at decode rows splits the
// contraction over blocks so that enough of them stream the codes.
//
// The TPU variant keeps the whole (m, bt) folded activation in VMEM (2.4 MB
// at m = 2304, bt = 256), more than the 227 KB of shared memory a block may
// have.  Here the fold producer builds each stage's 128 x 32 slice of it
// from the unfolded rows and splits it into hi and lo, so the folded
// activation never goes through device memory.
#include "epitome_mma.cuh"

extern "C" int quant_epitome_matmul_blocks_launch(
    const void* x, const void* q, const void* scales, const void* zeros,
    const void* cb, void* y, void* scratch, void* counters, int T, int m, int n,
    int gn, int bn, int bk, int s_cols, int split_rows, void* stream) {
  epim_mma::Args a = {};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.zeros = static_cast<const float*>(zeros);
  a.cb = static_cast<const int*>(cb);
  a.y = y;
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.T = T; a.m = m; a.n = n; a.gn = gn; a.bn = bn; a.bk = bk;
  a.s_cols = s_cols; a.ldx = m; a.split_rows = split_rows;
  return T <= epim_mma::DEC_MAX_T
      ? epim_mma::launch_decode<float>(a, stream)
      : epim_mma::launch_mma<epim_mma::kSplit, float>(a, stream);
}

extern "C" int quant_epitome_matmul_fused_fold_launch(
    const void* x, const void* q, const void* scales, const void* zeros,
    const void* cb, const void* fold, void* y, void* scratch, void* counters,
    int T, int M, int m, int n, int gn, int bn, int bk, int s_cols, int C,
    int split_rows, void* stream) {
  epim_mma::Args a = {};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.zeros = static_cast<const float*>(zeros);
  a.cb = static_cast<const int*>(cb);
  a.fold = static_cast<const long long*>(fold);
  a.y = y;
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.T = T; a.M = M; a.m = m; a.n = n; a.gn = gn; a.bn = bn; a.bk = bk;
  a.s_cols = s_cols; a.ldx = M; a.C = C; a.split_rows = split_rows;
  return epim_mma::launch_mma<epim_mma::kFold, float>(a, stream);
}
