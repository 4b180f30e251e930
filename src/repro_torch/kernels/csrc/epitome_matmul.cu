// Epitome-space blocked matmul with output indirection: kernel #3,
// epitome_matmul_blocks, float32 and bf16 entries.
//
// Replaces the TPU kernel src/repro/kernels/epitome_matmul.py,
// epitome_matmul_blocks (its _kernel, :37): for every output column block j,
//   y[:, j*bn:(j+1)*bn] = x_folded @ E[:, cb[j]*bn:(cb[j]+1)*bn]
// with cb the OFAT column-block table; repeated entries are the paper's
// output channel wrapping and re-read the same E block from L2.  x and E
// share one type, float32 or bf16; the sum is float32 and y rounds once to
// x's type, as in the TPU body.
//
// Bound on an H100: the operations at ResNet-50's shapes and at prefill
// rows, E's bytes at decode rows (T = 4).  float32 E is not exact in bf16,
// so the float32 entry runs 3xTF32, three TF32 tensor-core products per
// step: its bound is max(bytes / 3.35 TB/s, 3 x 2 T m gn bn / 495 TFLOP/s),
// about 4x under float32 outside the tensor cores (67 TFLOP/s); the bf16
// entry is one exact bf16 pass, 2 T m gn bn / 989 TFLOP/s.  The main loop
// (epitome_fp_mma.cuh, on epitome_mma.cuh's tile) stages x and E in a
// 4-deep cp.async ring and splits the contraction over blocks where the
// output tiles fill less than a wave.
#include "epitome_fp_mma.cuh"

namespace {

template <typename XT>
int launch(const void* x, const void* e, const void* cb, void* y, void* scratch,
           void* counters, int T, int m, int n, int gn, int bn, int split_rows,
           void* stream) {
  epim_mma::Args a = {};
  a.x = x;
  a.e = e;
  a.cb = static_cast<const int*>(cb);
  a.y = y;
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.T = T; a.m = m; a.n = n; a.gn = gn; a.bn = bn; a.ldx = m; a.split_rows = split_rows;
  return epim_mma::launch_fp_mma<XT>(a, stream);
}

}  // namespace

extern "C" int epitome_matmul_blocks_launch(
    const void* x, const void* e, const void* cb, void* y, void* scratch, void* counters,
    int T, int m, int n, int gn, int bn, int split_rows, void* stream) {
  return launch<float>(x, e, cb, y, scratch, counters, T, m, n, gn, bn, split_rows, stream);
}

extern "C" int epitome_matmul_blocks_bf16_launch(
    const void* x, const void* e, const void* cb, void* y, void* scratch, void* counters,
    int T, int m, int n, int gn, int bn, int split_rows, void* stream) {
  return launch<__nv_bfloat16>(x, e, cb, y, scratch, counters, T, m, n, gn, bn, split_rows,
                               stream);
}
