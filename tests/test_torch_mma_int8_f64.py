"""The int8 kernels' sums against float64: kernel #1's hi + fp16-lo split,
kernel #2's fold table against fold_blocks_ref bit for bit, and kernel #5's
prefill and decode sums at rwkv6-7b's longest contraction.

The models and cases are ``tests/mma_models.py``'s; nothing here needs a
card."""
import numpy as np
import pytest
import torch

from repro_torch.core.epitome import EpitomeSpec
from repro_torch.kernels import ops, ref

from mma_models import (CASES, RESNET_SPECS, _case, _gate, _hi_fp16_lo, _hi_lo, _qm_case,
                        decode_model, mma_model, table_fold)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.mark.parametrize("args,T", CASES)
def test_fp16_lo_split_near_float32_against_float64(args, T):
    """The float32 entries' split leaves under 2^-20 |x| of x out, so their
    sum is about as close to the float64 one as the plain float32 version
    (within 2.5x; 1.0-1.8x at these shapes), where hi + lo in two bf16
    (2^-17 |x|) is over 5x away at every shape: its error grows through
    ResNet-50's 53 layers to most of chip_smoke.py's card-vs-CPU logits
    gate."""
    spec, x, p, cb = _case(args, T)
    args_ = (p.q, p.scales, p.zeros, cb, p.bk, p.bn)
    y64 = mma_model([x], *args_, dtype=torch.float64)
    err = lambda y: float(((y.double() - y64).abs() / (1 + y64.abs())).max())
    plain = err(ref.quant_epitome_matmul_blocks_ref(x, *args_))
    assert err(mma_model(_hi_fp16_lo(x), *args_)) <= 2.5 * plain
    assert err(mma_model(_hi_lo(x), *args_)) > 5 * plain


@pytest.mark.parametrize("args", RESNET_SPECS + [
    (2304, 256, 256, 256, 128, 256),    # 17 virtual rows into one epitome row
    (4200, 128, 64, 128, 4, 128),       # gm = 1050 row blocks
    (512, 512, 251, 256, 128, 256),     # prime m
])
def test_table_fold_equals_fold_blocks_ref_bit_for_bit(args):
    spec = EpitomeSpec(*args)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((7, spec.M))
                         .astype(np.float32))
    assert torch.equal(table_fold(x, spec),
                       ref.fold_blocks_ref(x, spec.row_offsets(), spec.bm, spec.m))


def test_fold_table_on_device_is_the_kernels_layout():
    """SpecTables.fold, what the wrapper hands kernel #2, is the (m, c)
    inverse table column by column: entry c*m + k is row k's c-th virtual
    row."""
    spec = EpitomeSpec(1152, 128, 288, 128, 256, 128)
    flat = ops.spec_tables(spec, spec.bn, torch.device("cpu")).fold
    table = ops.fold_table(spec)
    assert flat.dtype == torch.int64 and flat.numel() == table.size
    np.testing.assert_array_equal(flat.reshape(-1, spec.m).T.numpy(), table)


@pytest.mark.parametrize("M,N", [(14336, 512), (4096, 1024)])
def test_quant_matmul_prefill_sum_against_float64(M, N):
    """Kernel #5 at prefill rows: x as bf16 hi + fp16 lo on the codes, one
    (s, z) flush per crossbar tile, within the reference tolerance of the
    float64 product at rwkv6-7b's longest contraction."""
    x, q, s, z, y64 = _qm_case(M, N, 48)
    cb = torch.arange(N // 256)
    y = mma_model(_hi_fp16_lo(x), q, s, z, cb, 256, 256)
    assert _gate(y, y64)
    assert _gate(ref.quant_matmul_ref(x, q, s, z), y64)


@pytest.mark.parametrize("M,N", [(14336, 512), (4096, 1024)])
def test_quant_matmul_decode_sum_against_float64(M, N):
    """Kernel #5 at decode rows (T = 4): the split-K loop's sum within the
    reference tolerance of the float64 product, the pairwise lanes and
    splits closer to it than sums in order (112 splits at M = 14336)."""
    x, q, s, z, y64 = _qm_case(M, N, 4, seed=1)
    pair = decode_model(x, q, s, z)
    chain = decode_model(x, q, s, z, pairwise=False)
    assert _gate(pair, y64) and _gate(chain, y64)
    rms = lambda y: float((y - y64).pow(2).mean().sqrt())
    assert rms(pair) < rms(chain)
