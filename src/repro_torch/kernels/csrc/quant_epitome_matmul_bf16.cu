// Fused quantized-epitome matmul with a bf16 activation and output: the
// bf16 entry of quant_epitome_matmul_blocks.
//
// Replaces the TPU kernel src/repro/kernels/quant_epitome_matmul.py,
// quant_epitome_matmul_blocks (its _kernel, :51), for the bf16 compute
// dtype the LM serves in:
//   y[:, j*bn:(j+1)*bn] = x_folded @ ((Q_blk + z[k, cb[j]]) * s[k, cb[j]])
// with x_folded and y bf16, the int8 codes Q and the float32 (scale, zero)
// per pack block as in the float32 entry.  The sum is float32 and y rounds
// once to bf16 at the store, as in the TPU body.
//
// Bound on an H100: at the LM's decode rows (T = 4) the int8 codes dominate
// the bytes, 1 byte per weight against 8 FLOPs, so the bound is the codes'
// bytes; at prefill rows (T = 1024) it is the bf16 tensor-core rate.  A bf16
// activation is exact in bf16, so it takes one tensor-core pass where the
// float32 entry takes two (epitome_mma.cuh).
#include "epitome_mma.cuh"

extern "C" int quant_epitome_matmul_blocks_bf16_launch(
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
      ? epim_mma::launch_decode<__nv_bfloat16>(a, stream)
      : epim_mma::launch_mma<epim_mma::kDirect, __nv_bfloat16>(a, stream);
}
