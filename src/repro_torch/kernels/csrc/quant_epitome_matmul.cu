// Fused quantized-epitome matmul (EPIM's flagship path), and its variant
// that folds the activation inside the kernel.
//
// Replaces the TPU kernels of src/repro/kernels/quant_epitome_matmul.py:
//   quant_epitome_matmul_blocks (its _kernel):
//     y[:, j*bn:(j+1)*bn] = x_folded @ ((Q_blk + z[k, cb[j]]) * s[k, cb[j]])
//     with int8 codes Q, one (scale, zero) per (bk x bn) pack block;
//   quant_epitome_matmul_fused_fold (its _fused_fold_kernel): the same
//     product taking the unfolded activation and the row-offset table, the
//     IFRT fold summed in ascending virtual block order inside the kernel.
//
// Bound on an H100: fp32 operations at the ResNet-50 shapes (25 to 200
// FLOP per byte of x, codes and y, against the 20 FLOP/B ridge of 67 TFLOP/s
// fp32 over 3.35 TB/s); the fc layer at batch 32 is bound by bytes, its
// 0.5 MB of codes.  The codes stay int8 in device memory and are
// dequantized while they are staged in shared memory, so the weight bytes
// read are a quarter of fp32's; the FMA loop is the same as the fp kernel's.
//
// The TPU variant keeps the whole (m, bt) folded activation in VMEM, which
// at m = 2304, bt = 256 is 2.4 MB and does not fit the 227 KB of shared
// memory a block may have.  Here each contraction step builds only its own
// 16 x 64 slice of the folded activation from the unfolded rows, so the
// folded activation never exists in device memory or whole in shared
// memory; the price is that every column tile of a row tile refolds it.
#include "epitome_tile.cuh"

extern "C" int quant_epitome_matmul_blocks_launch(
    const void* x, const void* q, const void* scales, const void* zeros,
    const void* cb, void* y, int T, int m, int n, int gn, int bn, int bk,
    int s_cols, void* stream) {
  epim::TileArgs a = {};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.zeros = static_cast<const float*>(zeros);
  a.cb = static_cast<const int*>(cb);
  a.y = y;
  a.T = T; a.m = m; a.n = n; a.gn = gn; a.bn = bn; a.bk = bk;
  a.s_cols = s_cols; a.ldx = m;
  return epim::launch_tile<epim::kQuant>(a, stream);
}

extern "C" int quant_epitome_matmul_fused_fold_launch(
    const void* x, const void* q, const void* scales, const void* zeros,
    const void* cb, const void* ro, void* y, int T, int M, int m, int n,
    int gn, int gm, int bm, int bn, int bk, int s_cols, void* stream) {
  if (gm > epim::MAX_GM) return static_cast<int>(cudaErrorInvalidValue);
  epim::TileArgs a = {};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.zeros = static_cast<const float*>(zeros);
  a.cb = static_cast<const int*>(cb);
  a.ro = static_cast<const int*>(ro);
  a.y = y;
  a.T = T; a.m = m; a.n = n; a.gn = gn; a.bn = bn; a.bk = bk;
  a.s_cols = s_cols; a.ldx = M; a.M = M; a.bm = bm; a.gm = gm;
  return epim::launch_tile<epim::kFusedFold>(a, stream);
}
