// Epitome-space blocked matmul with output indirection, float32.
//
// Replaces the TPU kernel src/repro/kernels/epitome_matmul.py,
// epitome_matmul_blocks (its _kernel): for every output column block j,
//   y[:, j*bn:(j+1)*bn] = x_folded @ E[:, cb[j]*bn:(cb[j]+1)*bn]
// with cb the OFAT column-block table; repeated entries are the paper's
// output channel wrapping and re-read the same E block from L2.
//
// Bound on an H100: fp32 operations.  The work is 2*T*m*gn*bn FLOPs over
// x (T*m*4 B) + E (m*n*4 B) + y (T*gn*bn*4 B); for the ResNet-50 shapes the
// ratio is 25 to 200 FLOP/B, above the 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B
// ridge of fp32 arithmetic outside the tensor cores.  The design keeps the
// FMA units fed from shared memory: 64 x 64 output tiles, 16 outputs per
// thread held in registers, each staged value reused 4 times per load.
// Tensor cores (TF32 or lower) would lift the bound and are later work.
#include "epitome_tile.cuh"

extern "C" int epitome_matmul_blocks_launch(
    const void* x, const void* e, const void* cb, void* y,
    int T, int m, int n, int gn, int bn, void* stream) {
  epim::TileArgs a = {};
  a.x = static_cast<const float*>(x);
  a.e = static_cast<const float*>(e);
  a.cb = static_cast<const int*>(cb);
  a.y = static_cast<float*>(y);
  a.T = T; a.m = m; a.n = n; a.gn = gn; a.bn = bn; a.ldx = m;
  return epim::launch_tile(a, stream);
}
